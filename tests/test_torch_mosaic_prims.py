"""The plain versions of csrc/mosaic_prims.cu (ops/mosaic_prims.py) vs the
Pallas kernels of ``scripts/probe_mosaic_prims.py`` run in interpret mode,
bit for bit; the wrappers on CPU tensors; the shapes they refuse; the
probe's ``main(argv, device="cpu")``; and rehearsals of the dot16 and
roll12 kernels' maps (``roll12_lanes``, ``dot16_lanes``/``dot16_words``/
``dot16_store_map``).  The script is loaded as it is, with
its ``pl`` given ``pallas_call(..., interpret=True)``, its ``timeit``
replaced by one that keeps the jitted step and its inputs, and its sizes
made small (MJ stays 4096, the roll's block width).  The CUDA kernels are
held against the plain versions on the card by chip_smoke.py."""

import functools
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from modimizer_tpu_torch import _build  # noqa: E402
from modimizer_tpu_torch.ops import mosaic_prims as mp  # noqa: E402
from modimizer_tpu_torch.probes import probe_mosaic_prims  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MJ = 4096


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "_script_probe_mosaic_prims",
        REPO / "scripts" / "probe_mosaic_prims.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return mod


def script_step(mod, name, grid):
    """Run the script's probe_<name> at GRID = grid (MJ = 4096) and return
    its jitted step and the inputs it built: step(*inputs) is the Pallas
    kernel's output."""
    kept = {}

    def timeit(fn, *args):
        kept["fn"], kept["args"] = fn, args
        return 0.0

    mod.timeit = timeit
    mod.MJ, mod.GRID = MJ, grid
    mod.NJ = grid * MJ
    mod.C = 16 * mod.NJ
    getattr(mod, "probe_" + name)()
    fn = kept["fn"]
    return (lambda *a: np.asarray(fn(jnp.uint32(0), *a))), kept["args"]


def tensor(a):
    """A numpy u32 / i32 / i8 array as the int32 / int8 tensor the port
    takes (same bits)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def u32(t):
    return t.numpy().view(np.uint32)


def rand_u32(seed, shape):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seed", [None, 1, 2])
def test_tala16_equals_script(script, seed):
    step, (x, i) = script_step(script, "tala16", 2)
    if seed is not None:
        x, i = rand_u32(seed, x.shape), rand_u32(seed + 100, i.shape)
    want = step(jnp.asarray(x), jnp.asarray(i))
    got = mp.tala16_ref(tensor(x), tensor(i))
    assert want.shape == (8, 2 * MJ)
    assert np.array_equal(u32(got), want)


@pytest.mark.parametrize("seed", [None, 3, 4])
def test_roll_equals_script(script, seed):
    step, (x,) = script_step(script, "roll", 2)
    if seed is not None:
        x = rand_u32(seed, x.shape)
    want = step(jnp.asarray(x))
    got = mp.roll12_ref(tensor(x))
    assert np.array_equal(u32(got), want)
    # after the 12 stages every element is its block row's cyclic sum
    sums = (np.asarray(x).astype(np.uint64).reshape(16, 2, MJ).sum(-1)
            & 0xFFFFFFFF).astype(np.uint32)
    assert np.array_equal(want.reshape(16, 2, MJ),
                          np.broadcast_to(sums[..., None], (16, 2, MJ)))


@pytest.mark.parametrize("seed", [None, 5, 6])
def test_cumsum128_equals_script(script, seed):
    step, (e,) = script_step(script, "cumsum128", 2)
    if seed is not None:
        e = np.random.default_rng(seed).integers(
            -128, 128, e.shape).astype(np.int8)
    want = step(jnp.asarray(e))
    got = mp.cumsum128_ref(tensor(e))
    assert want.dtype == np.int32 and want.shape == (1024, 128)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [None, 7, 8])
def test_dot16_equals_script(script, seed):
    # GRID = 16: the script's one step whose blocks lie inside its inputs
    step, (e, c) = script_step(script, "dot16", 16)
    if seed is not None:
        rng = np.random.default_rng(seed)
        e = rng.integers(-20, 140, e.shape).astype(np.int32)   # >= 112 drop
        c = rng.integers(-128, 128, c.shape).astype(np.int8)
    want = step(jnp.asarray(e), jnp.asarray(c))
    got = mp.dot16_ref(tensor(e), tensor(c))
    assert want.shape == (16, 112, 8)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_roll12_lanes_equals_ref_and_script(script, seed):
    """The kernel's schedule (shuffle stages with the select and the saved
    sh_{-1}, register stages cycle by cycle) gives the plain version's and
    the Pallas body's bits."""
    step, (x,) = script_step(script, "roll", 2)
    x = rand_u32(seed, x.shape)
    got = mp.roll12_lanes(tensor(x))
    assert np.array_equal(u32(got), step(jnp.asarray(x)))
    assert torch.equal(got, mp.roll12_ref(tensor(x)))


def _flipped_select(a, d):
    a = a.clone()
    lanes = torch.arange(32)
    src, own = (lanes - d) & 31, (lanes < d)[None, :]
    hi = wrap = a[:, src, 127]
    for i in range(127, -1, -1):
        lo = a[:, src, i - 1] if i else wrap
        a[:, :, i] = (a[:, :, i] + torch.where(own, hi, lo)) & mp.M32
        hi = lo
    return a


def _unsaved_wrap(a, d):
    a = a.clone()
    lanes = torch.arange(32)
    src, own = (lanes - d) & 31, (lanes >= d)[None, :]
    hi = a[:, src, 127]
    for i in range(127, -1, -1):
        lo = a[:, src, i - 1] if i else a[:, src, 127]   # a[127] is new
        a[:, :, i] = (a[:, :, i] + torch.where(own, hi, lo)) & mp.M32
        hi = lo
    return a


def _unsaved_top(a, D):
    a = a.clone()
    for r in range(D):
        for i in range(r + 128 - D, r + D - 1, -D):
            a[:, :, i] = (a[:, :, i] + a[:, :, i - D]) & mp.M32
        a[:, :, r] = (a[:, :, r] + a[:, :, r + 128 - D]) & mp.M32
    return a


def _lanes(x):
    """u32 [R, NJ] as the kernel holds it: [block rows, 32 lanes, 128
    registers], lane l's register i element l + 32 i."""
    return mp.i32_as_u32(x).view(-1, 128, 32).transpose(1, 2)


def _stage_ref(a, s):
    """One plain stage, acc[j] += acc[(j - 2^s) & 4095], in the lane
    layout."""
    acc = a.transpose(1, 2).reshape(a.shape[0], -1)
    acc = (acc + torch.roll(acc, 1 << s, dims=1)) & mp.M32
    return acc.view(a.shape[0], 128, 32).transpose(1, 2)


def _stage(a, s):
    return (mp.shuffle_stage(a, 1 << s) if s < mp.ROLL_LANE_STAGES
            else mp.register_stage(a, (1 << s) // 32))


@pytest.mark.parametrize("seed", [25, 26, 27])
def test_roll12_lanes_each_stage_is_a_plain_stage(seed):
    """The 12 stages' sums alone do not pin the schedule down (a stage
    that adds another permutation of the row can reach the same cyclic
    sums), so each stage is held against one plain stage."""
    a = _lanes(tensor(rand_u32(seed, (3, 4096))))
    for s in range(12):
        want = _stage_ref(a, s)
        a = _stage(a, s)
        assert torch.equal(a, want), s


@pytest.mark.parametrize("stage,mutant,stages", [
    ("shuffle_stage", _flipped_select, range(5)),
    ("shuffle_stage", _unsaved_wrap, range(5)),
    ("register_stage", _unsaved_top, range(5, 12))],
    ids=["select-flipped", "wrap-not-saved", "top-not-saved"])
def test_roll12_lanes_mutated_schedule_fails(monkeypatch, stage, mutant,
                                             stages):
    a = _lanes(tensor(rand_u32(28, (2, 4096))))
    for s in stages:
        assert torch.equal(_stage(a, s), _stage_ref(a, s))
    monkeypatch.setattr(mp, stage, mutant)
    for s in stages:
        assert not torch.equal(_stage(a, s), _stage_ref(a, s)), s


def _dot16_by_map(rank, cols):
    """dot16 run through the kernel's map: each atomic adds its col into
    its table word, then the store map reads the table out."""
    nb = rank.shape[0]
    words = mp.dot16_words(rank)                       # [nb, 8, 4, 8, 32]
    pos = mp.dot16_lanes()                             # [8, 4, 32]
    vals = cols[:, pos].permute(0, 1, 2, 4, 3).to(torch.int64)
    table = torch.zeros(nb, mp.DOT_NC * mp.DOT_STRIDE, dtype=torch.int64)
    keep = words >= 0
    for b in range(nb):
        table[b].index_add_(0, words[b][keep[b]], vals[b][keep[b]])
    out_w, tab_w = mp.dot16_store_map()
    out = torch.zeros(nb, mp.DOT_BO * mp.DOT_NC, dtype=torch.int64)
    out[:, out_w.reshape(-1)] = table[:, tab_w.reshape(-1)]
    return out.to(torch.int32).view(nb, mp.DOT_BO, mp.DOT_NC)


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_dot16_map_lands_each_position_once(seed):
    rng = np.random.default_rng(seed)
    rank = tensor(rng.integers(-20, 140, (3, 1024)).astype(np.int32))
    cols = tensor(rng.integers(-128, 128, (3, 1024, 8)).astype(np.int8))
    pos = mp.dot16_lanes()
    assert torch.equal(pos.reshape(-1).sort().values, torch.arange(1024))
    words = mp.dot16_words(rank)
    r = rank[:, pos].to(torch.int64)                   # [nb, 8, 4, 32]
    for c in range(8):
        w = words[:, :, :, c, :]
        kept = (r >= 0) & (r < 112)
        assert torch.equal(w[kept], c * mp.DOT_STRIDE + r[kept])
        assert bool((w[~kept] == -1).all())
    assert torch.equal(_dot16_by_map(rank, cols), mp.dot16_ref(rank, cols))


def _bank_ways(words):
    """Lanes that share a bank in each warp instruction's atomics (the
    most in any bank; 0 where no lane is active): [..., 32 lanes] ->
    [...]."""
    flat = words.reshape(-1, 32)
    ways = torch.zeros(flat.shape[0], dtype=torch.int64)
    for n, w in enumerate(flat):
        w = w[w >= 0]
        if w.numel():
            ways[n] = int(torch.bincount(w % 32).max())
    return ways.view(words.shape[:-1])


def test_dot16_bank_conflicts_as_the_header_says():
    """On the probe's ranks (arange % 117) no warp instruction's atomics
    share a bank, except where its 32 positions straddle the wrap at 117:
    at most 2-way there (csrc/mosaic_prims.cu's header).  Ranks as a
    compaction gives them share none."""
    rank, _cols = probe_mosaic_prims.inputs("dot16", 1 << 17, "cpu")
    ways = _bank_ways(mp.dot16_words(rank))            # [nb, 8, 4, 8]
    r = rank[:, mp.dot16_lanes()]                      # [nb, 8, 4, 32]
    straddles = (r[..., 1:] < r[..., :-1]).any(-1)[..., None].expand_as(ways)
    assert int(ways[~straddles].max()) == 1
    assert int(ways[straddles].max()) == 2
    # four consecutive positions a lane would give 4-way conflicts
    blocked = rank.view(-1, 8, 32, 4).transpose(2, 3)  # lane l: 4 l .. 4 l + 3
    words4 = torch.where(blocked < 112, blocked.to(torch.int64), -1)
    assert int(_bank_ways(words4).max()) == 4
    runs, _c = probe_mosaic_prims.run_ranks(64, "cpu")
    assert int(_bank_ways(mp.dot16_words(runs)).max()) == 1


def test_dot16_store_covers_out_once():
    out_w, tab_w = mp.dot16_store_map()
    n = mp.DOT_BO * mp.DOT_NC
    assert torch.equal(out_w.reshape(-1).sort().values, torch.arange(n))
    s, c = out_w // 8, out_w % 8               # out[b] is [s][c]
    assert torch.equal(tab_w, c * mp.DOT_STRIDE + s)
    # each int4 store is 4 consecutive words; each warp's k-th reads fall
    # in distinct banks
    assert bool((out_w[:, 1:] - out_w[:, :-1] == 1).all())
    for w0 in range(0, out_w.shape[0], 32):
        for k in range(4):
            banks = tab_w[w0:w0 + 32, k] % 32
            assert banks.unique().numel() == banks.numel()


def test_run_ranks_are_a_compaction():
    rank, cols = probe_mosaic_prims.run_ranks(5, "cpu")
    assert rank.dtype == torch.int32 and cols.dtype == torch.int8
    assert rank.shape == (5, 1024) and cols.shape == (5, 1024, 8)
    for row in rank:
        kept = row[row >= 0]
        assert torch.equal(kept, torch.arange(kept.numel(),
                                              dtype=torch.int32))
        assert bool((row >= -1).all())
    assert torch.equal(_dot16_by_map(rank, cols), mp.dot16_ref(rank, cols))


def _cases(seed):
    rng = np.random.default_rng(seed)
    i8 = rng.integers(-128, 128, (3, 1024, 8)).astype(np.int8)
    return {
        "tala16": (tensor(rand_u32(seed, (16, 256))),
                   tensor(rand_u32(seed + 1, (16, 256)))),
        "dot16": (tensor(rng.integers(-5, 120, (3, 1024)).astype(np.int32)),
                  tensor(i8)),
        "roll12": (tensor(rand_u32(seed, (2, 8192))),),
        "cumsum128": (tensor(i8.reshape(-1, 128)[:32]),)}


@pytest.mark.parametrize("name", ["tala16", "dot16", "roll12", "cumsum128"])
def test_wrapper_on_cpu_is_the_plain_version(name):
    args = _cases(11)[name]
    before = dict(_build.LAUNCHES)
    got = getattr(mp, name)(*args)
    want = getattr(mp, name + "_ref")(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert _build.LAUNCHES == before     # no kernel ran


def test_dot16_drops_ranks_outside_the_slots():
    rank = torch.full((1, 1024), 112, dtype=torch.int32)
    rank[0, :3] = torch.tensor([-1, 0, 111], dtype=torch.int32)
    cols = torch.ones((1, 1024, 8), dtype=torch.int8)
    out = mp.dot16(rank, cols)
    assert int(out.sum()) == 16
    assert out[0, 0].tolist() == [1] * 8 and out[0, 111].tolist() == [1] * 8


_I32, _I8 = torch.int32, torch.int8
BAD = [
    ("tala16", lambda: (torch.zeros(8, 128, dtype=_I32),
                        torch.zeros(8, 128, dtype=_I32))),
    ("tala16", lambda: (torch.zeros(16, 100, dtype=_I32),
                        torch.zeros(16, 100, dtype=_I32))),
    ("tala16", lambda: (torch.zeros(16, 128, dtype=torch.int64),
                        torch.zeros(16, 128, dtype=_I32))),
    ("tala16", lambda: (torch.zeros(16, 128, dtype=_I32),
                        torch.zeros(16, 256, dtype=_I32))),
    ("dot16", lambda: (torch.zeros(2, 512, dtype=_I32),
                       torch.zeros(2, 512, 8, dtype=_I8))),
    ("dot16", lambda: (torch.zeros(2, 1024, dtype=_I32),
                       torch.zeros(3, 1024, 8, dtype=_I8))),
    ("dot16", lambda: (torch.zeros(2, 1024, dtype=_I32),
                       torch.zeros(2, 1024, 8, dtype=_I32))),
    ("roll12", lambda: (torch.zeros(16, 2048, dtype=_I32),)),
    ("roll12", lambda: (torch.zeros(16, 8192, dtype=_I32)[:, ::2],)),
    ("cumsum128", lambda: (torch.zeros(24, 128, dtype=_I8),)),
    ("cumsum128", lambda: (torch.zeros(32, 64, dtype=_I8),)),
    ("cumsum128", lambda: (torch.zeros(32, 128, dtype=_I32),)),
]


@pytest.mark.parametrize("name,make", BAD,
                         ids=["%s-%d" % (n, i) for i, (n, _m) in
                              enumerate(BAD)])
def test_refused_shapes(name, make):
    with pytest.raises(ValueError, match=name):
        getattr(mp, name)(*make())


def test_unsupported_device_refused():
    x = torch.zeros(16, 128, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mp.tala16(x, x)


@pytest.mark.parametrize("argv,want", [
    (["--log2c", "16"], ["tala16", "roll", "cumsum128", "dot16"]),
    (["--log2c", "17", "dot16", "tala16"], ["dot16", "tala16"])])
def test_probe_runs_on_cpu(capsys, argv, want):
    assert probe_mosaic_prims.main(argv, device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["variant"] for x in lines] == want
    for x in lines:
        assert x["check"] == "match" and x["C"] == 1 << int(argv[1])
        assert x["device"] == "cpu" and x["ms"] is None


def test_probe_inputs_are_the_scripts(script):
    """At the script's sizes per grid step, the probe's inputs are the
    script's (dot16's one step of 16 blocks is the first 16 of C/1024)."""
    C = 1 << 17
    for name, grid in (("tala16", 2), ("roll", 2), ("cumsum128", 2),
                       ("dot16", 16)):
        _step, want = script_step(script, name, grid)
        got = probe_mosaic_prims.inputs(name, C, "cpu")
        for g, w in zip(got, want):
            w = np.asarray(w)
            g = g.numpy()[:w.shape[0]] if name == "dot16" else g.numpy()
            assert np.array_equal(g.view(w.dtype) if w.dtype == np.uint32
                                  else g, w), name


@pytest.mark.parametrize("argv", [["roll2"], ["--log2c", "15"],
                                  ["dot16", "--baseline", "old.cu"]])
def test_probe_bad_arguments_exit_nonzero(argv):
    with pytest.raises(SystemExit) as e:
        probe_mosaic_prims.main(argv, device="cpu")
    assert e.value.code not in (0, None)


_NO_JAX = r"""
import sys
from modimizer_tpu_torch.probes import probe_mosaic_prims
assert probe_mosaic_prims.main(["--log2c", "16"], device="cpu") == 0
assert "jax" not in sys.modules, "jax was imported"
sys.stderr.write("NO_JAX_OK\n")
"""


def test_probe_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stderr
