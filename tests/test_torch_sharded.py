"""The port's one-device modset count (modimizer_tpu_torch/parallel/
sharded.py, on the CPU: the plain version of scan_compact) vs the JAX
package's n = 1 ``ShardedModsetBuilder`` on a one-device mesh: the fold
(``compact_core``, ``compact_local``), ``finalize``, ``total_emitted`` and
the state arrays on the same streams, snapshots resumed across the two
packages, and the port's ``modutils -a`` through the builder (threshold
lowered) against the JAX CLI's host path, byte for byte."""

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

import jax.numpy as jnp  # noqa: E402

from modimizer_tpu.core.seqhash import Seqhash  # noqa: E402
from modimizer_tpu.ops.seqhash import (ModimizerScanner,  # noqa: E402
                                       first_encounter_unique)
from modimizer_tpu.parallel import sharded as jsh  # noqa: E402
from modimizer_tpu_torch.parallel import sharded as tsh  # noqa: E402
from tests.util import random_fasta, random_fastq, strip_timing  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SEED = 17
# 25-30 chunks of 2^12 positions; the state starts at 2^12 rows and must
# grow; the buffer holds ~6 chunks of rows, so the builders fold many times
KW = dict(chunk_per_dev=1 << 12, state_size=1 << 12, max_buffer_rows=3456)
# (k, w, reads): enough reads at w = 31 for the state to outgrow 2^12 rows
KWS = [(16, 16, 300), (19, 31, 450), (16, 10, 300)]


def stream(seed, n_reads=300, poly_a=True):
    """Random reads of 100-600 bases; with poly_a, read 40 is 3000 A's (the
    k-mer 0 hashes to 0 and emits at every position: blocks overflow)."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, n).astype(np.uint8)
            for n in rng.integers(100, 600, n_reads)]
    if poly_a:
        seqs[40] = np.zeros(3000, np.uint8)
    lens = [len(s) for s in seqs]
    return (np.concatenate(seqs),
            np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))


def jax_builder(sh, **kw):
    return jsh.ShardedModsetBuilder(sh, jsh.build_mesh(n_devices=1),
                                    **dict(KW, **kw))


def port_builder(sh, **kw):
    return tsh.ShardedModsetBuilder(sh, "cpu", **dict(KW, **kw))


def port_state(b):
    return (b.state_k.numpy().view(np.uint64), b.state_d.numpy()
            .view(np.uint32), b.state_m.numpy().view(np.uint64))


def jax_state(b):
    return tuple(np.asarray(a).reshape(-1)
                 for a in (b.state_k, b.state_d, b.state_m))


def assert_same_state(jb, pb):
    for j, p in zip(jax_state(jb), port_state(pb)):
        assert np.array_equal(j, p)
    assert (jb.S, jb.total_emitted) == (pb.S, pb.total_emitted)


# ---------------------------------------------------------------- the fold

def fold_inputs(seed, S, n_state, n_batch):
    """A sorted state of n_state live rows padded to S and a batch with
    sentinels and k-mers that repeat, and that the state holds."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 62, 3 * (n_state + 8), dtype=np.int64)
    sk = np.full(S, -1, np.int64)
    sk[:n_state] = np.sort(rng.choice(pool, n_state, replace=False))
    sd = np.zeros(S, np.uint32)
    sd[:n_state] = rng.integers(1, 0xFFFF + 1, n_state)
    sm = np.full(S, -1, np.int64)
    sm[:n_state] = rng.integers(0, 1 << 40, n_state)
    bk = rng.choice(pool, n_batch)
    bk[rng.random(n_batch) < 0.2] = -1
    bm = np.where(bk != -1, rng.integers(0, 1 << 40, n_batch), -1)
    return sk, sd, sm, bk, bm


def u64(a):
    return np.asarray(a).view(np.uint64) if a.dtype == np.int64 else a


@pytest.mark.parametrize("seed,S,n_state,n_batch",
                         [(1, 256, 100, 300), (2, 64, 40, 300),
                          (3, 512, 0, 50), (4, 128, 128, 0)])
def test_compact_core_equals_jax(seed, S, n_state, n_batch):
    sk, sd, sm, bk, bm = fold_inputs(seed, S, n_state, n_batch)
    want = jsh._compact_core(*(jnp.asarray(u64(a)) for a in
                               (sk, sd, sm, bk, bm)), S)
    got = tsh.compact_core(*(torch.from_numpy(a.view(np.int32) if
                                              a.dtype == np.uint32 else a)
                             for a in (sk, sd, sm, bk, bm)), S)
    for w, g in zip(want[:3], got[:3]):
        assert np.array_equal(np.asarray(w), u64(g.numpy()).view(
            np.asarray(w).dtype))
    assert int(want[3]) == got[3] and bool(want[4]) == got[4]


def test_compact_core_saturates_depth():
    k = torch.tensor([5, 5, -1], dtype=torch.int64)
    out = tsh.compact_core(k, torch.tensor([0xFFF0, 0x20, 0],
                                           dtype=torch.int32),
                           torch.tensor([9, 3, -1]), torch.tensor([5]),
                           torch.tensor([1]), 2)
    assert out[0].tolist() == [5, -1] and out[1].tolist() == [0xFFFF, 0]
    assert out[2].tolist() == [1, -1] and out[3:] == (1, False)


def test_compact_local_equals_jax():
    rng = np.random.default_rng(9)
    S = 512
    sk, sd, sm, _bk, _bm = fold_inputs(9, S, 50, 0)
    recv_k, recv_p, bases = [], [], []
    for i in range(3):
        k = rng.integers(0, 1 << 40, 200, dtype=np.int64)
        k[rng.random(200) < 0.3] = -1
        recv_k.append(k)
        recv_p.append(np.where(k != -1, rng.integers(0, 1 << 31, 200),
                               -1).astype(np.int32))
        bases.append((1 << 33) * i + 5)
    want = jsh.compact_local(
        *(jnp.asarray(u64(a))[None] for a in (sk, sd, sm)),
        jnp.asarray(np.array(bases, np.uint64)),
        *[jnp.asarray(u64(k)) for k in recv_k],
        *[jnp.asarray(p.view(np.uint32)) for p in recv_p],
        S=S, n_recv=3)
    got = tsh.compact_local(
        *(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
          for a in (sk, sd, sm)), bases,
        [torch.from_numpy(k) for k in recv_k],
        [torch.from_numpy(p) for p in recv_p], S=S)
    for w, g in zip(want[:3], got[:3]):
        w = np.asarray(w)
        assert np.array_equal(w, g.numpy().view(w.dtype))
    assert int(want[3]) == got[3] and bool(want[4]) == got[4]


# ------------------------------------------------------------- the builder

@pytest.mark.parametrize("k,w,n_reads", KWS,
                         ids=["k%dw%d" % kw[:2] for kw in KWS])
def test_builder_equals_jax(k, w, n_reads):
    sh = Seqhash.create(k, w, SEED)
    codes, offsets = stream(k * 100 + w, n_reads)
    jb, pb = jax_builder(sh), port_builder(sh)
    bo0 = pb.bo
    jb.feed_stream(codes, offsets)
    pb.feed_stream(codes, offsets)
    want, got = jb.finalize(), pb.finalize()
    assert got[0].dtype == np.uint64 and got[1].dtype == np.uint32
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1])
    assert_same_state(jb, pb)
    # and both are the sequential build's insertion stream
    kmers = ModimizerScanner(sh, host_threshold=1 << 62).scan_stream(
        codes, offsets)[0]
    uniq, counts = first_encounter_unique(kmers)
    assert np.array_equal(got[0], uniq) and np.array_equal(got[1], counts)
    assert pb.total_emitted == len(kmers)
    # the paths under test ran: growth, several folds, the overflow replay
    assert pb.S > KW["state_size"] and pb.n_compact > 2
    assert pb.n_replay > 0 and pb.bo > bo0


def test_builder_with_base_and_empty_stream():
    sh = Seqhash.create(16, 16, SEED)
    codes, offsets = stream(5, n_reads=40, poly_a=False)
    pb = port_builder(sh)
    pb.feed_stream(np.zeros(0, np.uint8), np.zeros(1, np.int64))
    pb.feed_stream(codes, offsets, base=1000)
    jb = jax_builder(sh)
    jb.feed_stream(codes, offsets, base=1000)
    want, got = jb.finalize(), pb.finalize()
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
    assert_same_state(jb, pb)
    assert int(pb.state_m[pb.state_k != -1].min()) >= 1000


def test_max_state_size_refused():
    sh = Seqhash.create(16, 16, SEED)
    codes, offsets = stream(6, n_reads=60, poly_a=False)
    pb = port_builder(sh, state_size=256, max_state_size=512)
    with pytest.raises(RuntimeError, match="max_state_size"):
        pb.feed_stream(codes, offsets)
        pb.finalize()


@pytest.mark.parametrize("direction", ["jax-port", "port-jax", "port-port"])
def test_snapshot_resumes_across_packages(tmp_path, direction):
    sh = Seqhash.create(16, 16, SEED)
    codes, offsets = stream(31)
    full = port_builder(sh)
    full.feed_stream(codes, offsets)
    want = full.finalize()
    cut_seq = 120                 # past the poly-A read
    cut = int(offsets[cut_seq])
    first, second = direction.split("-")
    b1 = jax_builder(sh) if first == "jax" else port_builder(sh)
    b1.feed_stream(codes[:cut], offsets[:cut_seq + 1])
    snap = tmp_path / "build.snap"
    b1.save(str(snap), cursor=cut)
    if second == "jax":
        b2, cursor = jsh.ShardedModsetBuilder.restore(
            str(snap), sh, jsh.build_mesh(n_devices=1),
            max_buffer_rows=KW["max_buffer_rows"])
    else:
        b2, cursor = tsh.ShardedModsetBuilder.restore(
            str(snap), sh, "cpu", max_buffer_rows=KW["max_buffer_rows"])
    assert cursor == cut and b2.total_emitted == b1.total_emitted
    assert (b2.S, b2.bo, b2.chunk) == (b1.S, b1.bo, b1.chunk)
    b2.feed_stream(codes[cursor:], offsets[cut_seq:] - cut, base=cursor)
    got = b2.finalize()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert b2.total_emitted == full.total_emitted


def test_snapshot_mismatch_errors(tmp_path):
    sh = Seqhash.create(16, 16, SEED)
    codes, offsets = stream(32, n_reads=20, poly_a=False)
    b = port_builder(sh)
    b.feed_stream(codes, offsets)
    snap = tmp_path / "s.snap"
    b.save(str(snap))
    with pytest.raises(ValueError, match="does not match"):
        tsh.ShardedModsetBuilder.restore(str(snap), Seqhash.create(17, 16,
                                                                   SEED),
                                         "cpu")
    d = dict(np.load(snap))
    d["meta"] = d["meta"].copy()
    d["meta"][4] = 2                 # a two-shard snapshot
    with open(snap, "wb") as f:
        np.savez(f, **d)
    with pytest.raises(ValueError, match="re-shard"):
        tsh.ShardedModsetBuilder.restore(str(snap), sh, "cpu")


def test_more_than_one_device_refused():
    """A list of devices is one process's; the port runs one process a
    device, so more than one is refused, and a device, a list of one or a
    mesh with no group is the one-device path."""
    from modimizer_tpu_torch.parallel.mesh import Mesh, build_mesh
    with pytest.raises(ValueError, match="2 devices in one process"):
        tsh.ShardedModsetBuilder(Seqhash.create(16, 16, SEED), ["cpu", "cpu"])
    for dev in (["cpu"], "cpu", build_mesh("cpu"), Mesh("cpu")):
        b = tsh.ShardedModsetBuilder(Seqhash.create(16, 16, SEED), dev,
                                     state_size=16)
        assert b.device == torch.device("cpu")
        assert (b.n, b.routed, b.mesh.rank) == (1, False, 0)


def test_builder_on_a_mesh_without_a_group_equals_jax():
    """A Mesh with no group is the one-device path: the same finalize,
    state and snapshot as the JAX n = 1 builder."""
    from modimizer_tpu_torch.parallel.mesh import build_mesh
    sh = Seqhash.create(16, 16, SEED)
    codes, offsets = stream(7, n_reads=60, poly_a=False)
    pb = tsh.ShardedModsetBuilder(sh, build_mesh("cpu"), **KW)
    jb = jax_builder(sh)
    pb.feed_stream(codes, offsets)
    jb.feed_stream(codes, offsets)
    want, got = jb.finalize(), pb.finalize()
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
    assert_same_state(jb, pb)
    assert not pb.routed and pb.n_compact > 0


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sharded_cli")
    random_fasta(d / "reads.fa", 60, 400, seed=11, genome_len=6000)
    with open(d / "reads.fa", "a") as f:
        f.write(">polyA\n" + "A" * 2500 + "\n")
    random_fastq(d / "reads.fq", 30, 300, seed=12)
    return d


def _run(main, argv, **kw):
    out, old = io.StringIO(), (sys.stdout, sys.stderr)
    try:
        sys.stdout, sys.stderr = out, io.StringIO()
        ret = main([str(a) for a in argv], **kw)
    finally:
        sys.stdout, sys.stderr = old
    return strip_timing(out.getvalue()), ret


@pytest.mark.parametrize("params", [["20", "16", "16", "17"],
                                    ["20", "19", "31", "17"]],
                         ids=["k16w16", "k19w31"])
@pytest.mark.parametrize("no_count", [False, True],
                         ids=["builder", "scanner"])
def test_cli_device_count_matches_jax_host(reads, tmp_path, monkeypatch,
                                           params, no_count):
    from modimizer_tpu.cli import modutils as jax_cli
    from modimizer_tpu_torch.cli import modutils as port_cli
    outs = {}
    for tag in ("port", "jax"):
        argv = (["-c"] + params + ["-x", reads / "reads.fq",
                                   "-a", reads / "reads.fa",
                                   "-w", tmp_path / (tag + ".mod")])
        if tag == "port":
            monkeypatch.delenv("MODIMIZER_SCAN", raising=False)
            monkeypatch.setattr(port_cli, "DEVICE_COUNT_THRESHOLD", 4096)
            if no_count:
                monkeypatch.setenv("MODIMIZER_NO_DEVICE_COUNT", "1")
            builders = []
            outs[tag], _ = _run(port_cli.run, argv, device="cpu",
                                builders=builders)
            monkeypatch.delenv("MODIMIZER_NO_DEVICE_COUNT", raising=False)
            # both inputs counted on the device unless told not to
            assert len(builders) == 2
            assert all((b is None) == no_count for b in builders)
            if not no_count:
                assert builders[1].n_replay > 0
        else:
            monkeypatch.setenv("MODIMIZER_SCAN", "host")
            outs[tag], _ = _run(jax_cli.main, argv)
            monkeypatch.delenv("MODIMIZER_SCAN")
    assert "added 61 sequences" in outs["port"]
    assert outs["port"] == outs["jax"]
    assert ((tmp_path / "port.mod").read_bytes()
            == (tmp_path / "jax.mod").read_bytes())


_NO_JAX = r"""
import sys
from modimizer_tpu_torch.cli import modutils
modutils.DEVICE_COUNT_THRESHOLD = 4096
builders = []
modutils.run(sys.argv[1:], device="cpu", builders=builders)
assert builders and builders[0] is not None, "the builder did not run"
assert "jax" not in sys.modules, "jax was imported"
sys.stderr.write("NO_JAX_OK\n")
"""


def test_builder_path_never_imports_jax(reads, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("MODIMIZER_SCAN", None)
    env.pop("MODIMIZER_NO_DEVICE_COUNT", None)
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "-c", "20", "16", "16", "17",
         "-a", str(reads / "reads.fa"), "-w", str(tmp_path / "p.mod")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stderr
    assert "added 61 sequences" in r.stdout
