"""The rank side of tests/test_torch_dist.py: the port's mesh paths in a
gloo group on the CPU, one process a rank.

    python -m tests.torch_dist_ranks RANK WORLD INIT_FILE OUT_DIR
    python -m tests.torch_dist_ranks modutils OUT_DIR ARGS...

The first joins a group of WORLD ranks (``file://INIT_FILE``), runs every
case of ``CASES`` on ``build_mesh("cpu", group)`` and writes each case's
results to ``OUT_DIR/<case>.<rank>.npz``.  Nothing here imports jax or the JAX
package: the test compares the results with the JAX package's mesh, in
its own process.  The inputs are made from numpy seeds by the functions
below, which the test calls too; OUT_DIR/jax.snap (a JAX snapshot of the
first part of ``snap_stream``) is written by the test before the ranks
start.  The second runs ``modutils ARGS`` as one rank under torchrun's
variables (``modutils_rank``).
"""

import os
import sys
import traceback

import numpy as np

SEED = 17
# 2^10 positions a rank a step; the state starts at 2^9 rows and must grow;
# the buffer holds a few steps of routed rows, so the ranks fold often
KW = dict(chunk_per_dev=1 << 10, state_size=1 << 9, max_buffer_rows=1 << 13)
BUILDS = {"k16w16": (16, 16, 200), "k19w31": (19, 31, 400),
          "k16w10": (16, 10, 150)}
SNAP_CUT = 120                    # reads before the snapshot
OVERFLOW_CAP = 64                 # routing slots, to force the replay


def stream(seed, n_reads, lo=50, hi=400):
    """Random reads of lo..hi bases: (codes, offsets)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, n_reads)
    codes = np.concatenate([rng.integers(0, 4, n).astype(np.uint8)
                            for n in lens])
    return codes, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def snap_stream():
    return stream(31, 240)


def overflow_stream(scanner_cls, sh):
    """A homopolymer whose k-mer emits (6,000 bases) then 4,000 random
    bases, as the JAX package's cap-overflow test builds it (``scanner_cls``
    is either package's ModimizerScanner with a host scan)."""
    rng = np.random.default_rng(2)
    for b in range(4):
        codes = np.full(6000, b, np.uint8)
        kmers = scanner_cls(sh).scan_kmers(codes,
                                           np.array([0, 6000], np.int64))
        if len(kmers) > 3000:
            break
    codes = np.concatenate([codes, rng.integers(0, 4, 4000).astype(
        np.uint8)])
    return codes, np.array([0, len(codes)], np.int64)


def modsets(modset_cls, seqhash_cls, seed, n_a, n_b, shared, b_flags):
    """Two k16 w16 modsets (table bits 20) of random k-mers, depths and
    info (copy numbers and flag bits): B holds ``shared`` of A's k-mers
    and n_b - shared of its own; with ``b_flags`` its info carries flag
    bits (the merge clears them on k-mers new to A)."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(1 << 32, n_a + n_b, replace=False).astype(np.uint64)
    ka = pool[:n_a]
    kb = np.concatenate([rng.choice(ka, shared, replace=False),
                         pool[n_a:n_a + n_b - shared]])
    rng.shuffle(kb)
    out = []
    for ks, flags in ((ka, True), (kb, b_flags)):
        ms = modset_cls(seqhash_cls.create(16, 16, SEED), 20)
        ms.add_batch(ks, rng.integers(1, 300, len(ks)).astype(np.uint32))
        ms.depth[1:ms.max + 1] = rng.integers(1, 0xFFFF, ms.max)
        ms.depth[1:1 + ms.max // 50] = 0xFFF0        # saturating sums
        top = 64 if flags else 4
        ms.info[1:ms.max + 1] = rng.integers(0, top, ms.max).astype(
            np.uint8)
        out.append(ms)
    return out


MERGES = {"merge": (5, 3000, 2000, 700, True),
          "merge_flags": (6, 2500, 2500, 100, True)}


def lookup_queries(kmers, seed=11):
    rng = np.random.default_rng(seed)
    q = np.concatenate([rng.choice(kmers, 3000),
                        rng.integers(1 << 33, 1 << 40, 2000).astype(
                            np.uint64),
                        np.array([0xFFFFFFFFFFFFFFFF, 0], np.uint64)])
    rng.shuffle(q)
    return q


def dryrun_stream():
    rng = np.random.default_rng(1)
    lens = rng.integers(40, 300, size=64)
    codes = rng.integers(0, 4, size=int(lens.sum())).astype(np.uint8)
    return codes, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def fused_stream(blk):
    rng = np.random.default_rng(5)
    big = rng.integers(0, 4, size=64 * blk + 997).astype(np.uint8)
    return big, np.array([0, 31 * blk, 32 * blk, len(big)], np.int64)


# ---------------------------------------------------------------- the cases

def _builder_result(b, ks, ds):
    return dict(ks=ks, ds=ds, total=b.total_emitted, S=b.S, cap=b.cap,
                bo=b.bo, n_compact=b.n_compact, n_replay=b.n_replay,
                state_k=b.state_k.numpy().view(np.uint64),
                state_d=b.state_d.numpy().view(np.uint32),
                state_m=b.state_m.numpy().view(np.uint64))


def case_build(name):
    def run(mesh, out):
        from modimizer_tpu_torch.core.seqhash import Seqhash
        from modimizer_tpu_torch.parallel.sharded import ShardedModsetBuilder
        k, w, n_reads = BUILDS[name]
        codes, offsets = stream(k * 100 + w, n_reads)
        b = ShardedModsetBuilder(Seqhash.create(k, w, SEED), mesh, **KW)
        b.feed_stream(codes, offsets)
        return _builder_result(b, *b.finalize())
    return run


def case_overflow(mesh, out):
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.ops.seqhash import ModimizerScanner
    from modimizer_tpu_torch.parallel.sharded import ShardedModsetBuilder
    sh = Seqhash.create(16, 16, SEED)
    codes, offsets = overflow_stream(
        lambda s: ModimizerScanner(s, host=True), sh)
    b = ShardedModsetBuilder(sh, mesh, chunk_per_dev=1 << 10,
                             state_size=1 << 12, cap=OVERFLOW_CAP)
    b.feed_stream(codes, offsets)
    return _builder_result(b, *b.finalize())


def _resume(path, mesh, codes, offsets):
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.parallel.sharded import ShardedModsetBuilder
    b, cursor = ShardedModsetBuilder.restore(
        path, Seqhash.create(16, 16, SEED), mesh,
        max_buffer_rows=KW["max_buffer_rows"])
    got = dict(cursor=cursor, total0=b.total_emitted, S0=b.S, bo0=b.bo,
               cap0=b.cap, chunk0=b.chunk)
    b.feed_stream(codes[cursor:], offsets[SNAP_CUT:] - cursor, base=cursor)
    return dict(got, **_builder_result(b, *b.finalize()))


def case_snap_from_jax(mesh, out):
    return _resume(os.path.join(out, "jax.snap"), mesh, *snap_stream())


def case_snap_to_port(mesh, out):
    """The first part built here and saved (the test resumes it in the JAX
    package too), then resumed here."""
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.parallel.sharded import ShardedModsetBuilder
    codes, offsets = snap_stream()
    cut = int(offsets[SNAP_CUT])
    b = ShardedModsetBuilder(Seqhash.create(16, 16, SEED), mesh, **KW)
    b.feed_stream(codes[:cut], offsets[:SNAP_CUT + 1])
    path = os.path.join(out, "port.snap")
    b.save(path, cursor=cut)
    return dict(saved_total=b.total_emitted,
                **_resume(path, mesh, codes, offsets))


def case_snap_errors(mesh, out):
    """Restoring the port's snapshot with another seqhash, and a copy that
    claims one shard more than the mesh has, must raise."""
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.parallel.sharded import ShardedModsetBuilder
    path = os.path.join(out, "port.snap")
    wrong = os.path.join(out, "wrong_n.snap")
    if mesh.rank == 0:
        d = dict(np.load(path))
        d["meta"] = d["meta"].copy()
        d["meta"][4] += 1
        with open(wrong, "wb") as f:
            np.savez(f, **d)
    mesh.barrier()
    msgs = []
    for p, sh in ((path, Seqhash.create(17, 16, SEED)),
                  (wrong, Seqhash.create(16, 16, SEED))):
        try:
            ShardedModsetBuilder.restore(p, sh, mesh)
            msgs.append("")
        except ValueError as e:
            msgs.append(str(e))
    return dict(seqhash=msgs[0], shards=msgs[1])


def case_merge(name):
    def run(mesh, out):
        from modimizer_tpu_torch.core.modset import Modset
        from modimizer_tpu_torch.core.seqhash import Seqhash
        from modimizer_tpu_torch.parallel.sharded import sharded_merge
        ms_a, ms_b = modsets(Modset, Seqhash, *MERGES[name])
        mk, md, mi = sharded_merge(ms_a, ms_b, mesh)
        other = modsets(Modset, Seqhash, *MERGES[name])[1]
        other.hasher = Seqhash.create(16, 15, SEED)
        return dict(mk=mk, md=md, mi=mi,
                    other_hasher=sharded_merge(ms_a, other, mesh) is None)
    return run


def case_lookup(mesh, out):
    from modimizer_tpu_torch.core.modset import Modset
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.parallel.lookup import DeviceTable
    ms = modsets(Modset, Seqhash, *MERGES["merge"])[0]
    kmers = ms.value[1:ms.max + 1]
    dt = DeviceTable(kmers, np.arange(1, ms.max + 1, dtype=np.uint32),
                     ms.hasher, mesh)
    empty = DeviceTable(np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                        ms.hasher, mesh)
    q = lookup_queries(kmers)
    return dict(found=dt.find(q), none=dt.find(np.zeros(0, np.uint64)),
                empty=empty.find(q), n_keys=dt.keys.numel(),
                native=ms.find_batch(q))


def case_dryrun(mesh, out):
    """The port's counterpart of ``dryrun_multichip``
    (``__graft_entry__.py:38-136``): feed, snapshot, resume, finalize;
    merge; lookup; a feed at C = 32 BLK for k16 and k19."""
    from modimizer_tpu_torch.core.modset import Modset
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.ops.consts import BLK_COMPACT
    from modimizer_tpu_torch.parallel.lookup import DeviceTable
    from modimizer_tpu_torch.parallel.sharded import (ShardedModsetBuilder,
                                                      sharded_merge)
    sh = Seqhash.create(16, 16, SEED)
    codes, offsets = dryrun_stream()
    b = ShardedModsetBuilder(sh, mesh, chunk_per_dev=1 << 10,
                             state_size=1 << 12)
    half = 32
    cut = int(offsets[half])
    b.feed_stream(codes[:cut], offsets[:half + 1])
    snap = os.path.join(out, "dryrun.snap")
    b.save(snap, cursor=cut)
    b, cursor = ShardedModsetBuilder.restore(snap, sh, mesh)
    b.feed_stream(codes[cursor:], offsets[half:] - cursor, base=cursor)
    ks, ds = b.finalize()
    ms_a = Modset(Seqhash.create(16, 16, SEED), 20)
    ms_a.add_batch(ks, ds)
    ms_b = Modset(Seqhash.create(16, 16, SEED), 20)
    ms_b.add_batch(ks[::2].copy(), ds[::2].copy())
    mk, md, mi = sharded_merge(ms_a, ms_b, mesh)
    assert ms_a.merge(ms_b)
    dt = DeviceTable(ms_a.value[1:ms_a.max + 1],
                     np.arange(1, ms_a.max + 1, dtype=np.uint32),
                     ms_a.hasher, mesh)
    q = np.concatenate([ks[::3], ks[:16] ^ np.uint64(0x5A5A5A5)])
    got = dict(ks=ks, ds=ds, total=b.total_emitted, mk=mk, md=md, mi=mi,
               merged_k=ms_a.value[1:ms_a.max + 1],
               merged_d=ms_a.depth[1:ms_a.max + 1], found=dt.find(q),
               native=ms_a.find_batch(q))
    big, boffs = fused_stream(BLK_COMPACT)
    for kk in (16, 19):
        b2 = ShardedModsetBuilder(Seqhash.create(kk, 31, SEED), mesh,
                                  chunk_per_dev=32 * BLK_COMPACT,
                                  state_size=1 << 12)
        b2.feed_stream(big, boffs)
        got["fused_k%d" % kk], got["fused_d%d" % kk] = b2.finalize()
    return got


# ---------------------------------------- the multi-process build

MH_KW = dict(chunk_per_dev=1 << 11, state_size=1 << 12)
MH_SPLITS = ("even", "uneven")


def mh_stream():
    """tests/test_multihost.py's global stream: 120 reads of 60..400."""
    rng = np.random.default_rng(77)
    lens = rng.integers(60, 400, size=120)
    codes = rng.integers(0, 4, size=int(lens.sum())).astype(np.uint8)
    return codes, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def mh_splits(kind, n, first=0, last=120):
    """Read boundaries of n shards of reads [first, last): even, or the
    first shard to read 104 (test_multihost.py's uneven split) and the
    rest shared by the other ranks."""
    if kind == "even":
        return np.linspace(first, last, n + 1).round().astype(int)
    return np.concatenate([[first], np.linspace(104, last, n).round()]
                          ).astype(int)


def mh_shard(codes, offsets, splits, r):
    """Rank r's shard: (codes, offsets from 0, global base)."""
    a, b = splits[r], splits[r + 1]
    lo, hi = int(offsets[a]), int(offsets[b])
    return codes[lo:hi], offsets[a:b + 1] - lo, lo


def case_mh(kind):
    def run(mesh, out):
        from modimizer_tpu_torch.core.seqhash import Seqhash
        from modimizer_tpu_torch.parallel.multihost import (
            MultiHostModsetBuilder)
        codes, offsets = mh_stream()
        my_codes, my_off, base = mh_shard(
            codes, offsets, mh_splits(kind, mesh.n), mesh.rank)
        b = MultiHostModsetBuilder(Seqhash.create(16, 16, 17), mesh,
                                   **MH_KW)
        b.feed_stream(my_codes, my_off, base=base)
        return dict(_builder_result(b, *b.finalize()), shard=len(my_codes))
    return run


def case_mh_snapshot(mesh, out):
    """The preemption drill of test_multihost.py: every rank feeds half of
    its shard, the build is saved (collective, rank 0 writes), restored
    into a new builder, and every rank feeds the rest from its own
    cursor."""
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.parallel.multihost import MultiHostModsetBuilder
    sh = Seqhash.create(16, 16, 17)
    codes, offsets = mh_stream()
    my_codes, my_off, base = mh_shard(codes, offsets,
                                      mh_splits("even", mesh.n), mesh.rank)
    b = MultiHostModsetBuilder(sh, mesh, **MH_KW)
    cutr = (len(my_off) - 1) // 2
    cut = int(my_off[cutr])
    b.feed_stream(my_codes[:cut], my_off[:cutr + 1], base=base)
    snap = os.path.join(out, "mh.snap")
    b.save(snap, cursor=base + cut)
    b, cursor = MultiHostModsetBuilder.restore(snap, sh, mesh)
    b.feed_stream(my_codes[cut:], my_off[cutr:] - cut, base=base + cut)
    return dict(_builder_result(b, *b.finalize()), cursor=cursor,
                kind=type(b).__name__)


def case_mh_from_jax(mesh, out):
    """A JAX builder's snapshot of snap_stream's first SNAP_CUT reads
    restored here, and the other reads fed as one shard a rank."""
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.parallel.multihost import MultiHostModsetBuilder
    codes, offsets = snap_stream()
    b, cursor = MultiHostModsetBuilder.restore(
        os.path.join(out, "jax.snap"), Seqhash.create(16, 16, SEED), mesh,
        max_buffer_rows=KW["max_buffer_rows"])
    splits = mh_splits("even", mesh.n, SNAP_CUT, len(offsets) - 1)
    b.feed_stream(*mh_shard(codes, offsets, splits, mesh.rank))
    return dict(_builder_result(b, *b.finalize()), cursor=cursor)


CASES = {**{"build_" + n: case_build(n) for n in BUILDS},
         "overflow": case_overflow, "snap_from_jax": case_snap_from_jax,
         "snap_to_port": case_snap_to_port, "snap_errors": case_snap_errors,
         **{n: case_merge(n) for n in MERGES}, "lookup": case_lookup,
         "dryrun": case_dryrun,
         **{"mh_" + k: case_mh(k) for k in MH_SPLITS},
         "mh_snapshot": case_mh_snapshot, "mh_from_jax": case_mh_from_jax}


# ---------------------------------------- modutils under torchrun

MODUTILS_THRESHOLD = 1 << 12    # inputs of 4,096 bases or more: the builder
MODUTILS_CHUNK = 1 << 12        # its chunk a rank


def modutils_rank(out, argv):
    """One rank of ``modutils`` under torchrun's variables (WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) on the CPU: main() inits
    the gloo group itself.  The device-count threshold and the builder's
    chunk are lowered so that a small input takes the builder; each
    builder's (n, routed) goes to OUT/builders.<rank>.json and the rank's
    stdout to OUT/stdout.<rank>."""
    import contextlib
    import json
    from modimizer_tpu_torch.cli import modutils
    made = []

    class Builder(modutils.ShardedModsetBuilder):
        def __init__(self, sh, mesh, **kw):
            super().__init__(sh, mesh, chunk_per_dev=MODUTILS_CHUNK, **kw)
            made.append((self.n, self.routed))

    modutils.DEVICE_COUNT_THRESHOLD = MODUTILS_THRESHOLD
    modutils.ShardedModsetBuilder = Builder
    rank = int(os.environ["RANK"])
    with open(os.path.join(out, "stdout.%d" % rank), "w") as f:
        with contextlib.redirect_stdout(f):
            modutils.main(argv, device="cpu")
    with open(os.path.join(out, "builders.%d.json" % rank), "w") as f:
        json.dump(made, f)


def main(argv):
    if argv[0] == "modutils":
        modutils_rank(argv[1], argv[2:])
        assert "jax" not in sys.modules
        return
    rank, world, init_file, out = (int(argv[0]), int(argv[1]), argv[2],
                                   argv[3])
    import datetime
    import torch.distributed as dist
    from modimizer_tpu_torch.parallel.mesh import build_mesh
    # a rank that fails a case leaves the others in a collective: they
    # give up after the timeout, and the test reads the error
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = build_mesh("cpu", dist.group.WORLD)
        assert (mesh.n, mesh.rank) == (world, rank)
        for name, case in CASES.items():
            try:
                got = case(mesh, out)
            except Exception:            # recorded; the test fails on it
                got = dict(error=traceback.format_exc())
            with open(os.path.join(out, "%s.%d.npz" % (name, rank)),
                      "wb") as f:
                np.savez(f, **got)
    finally:
        dist.destroy_process_group()
    assert "jax" not in sys.modules and "modimizer_tpu" not in sys.modules


if __name__ == "__main__":
    main(sys.argv[1:])
