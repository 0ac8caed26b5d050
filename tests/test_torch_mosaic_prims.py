"""The plain versions of csrc/mosaic_prims.cu (ops/mosaic_prims.py) vs the
Pallas kernels of ``scripts/probe_mosaic_prims.py`` run in interpret mode,
bit for bit; the wrappers on CPU tensors; the shapes they refuse; the
probe's ``main(argv, device="cpu")``.  The script is loaded as it is, with
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


@pytest.mark.parametrize("argv", [["roll2"], ["--log2c", "15"]])
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
