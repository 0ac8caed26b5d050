"""The port's mesh paths (modimizer_tpu_torch/parallel/mesh.py, the routed
builder, the sharded merge and the mesh DeviceTable) against the JAX
package's on the conftest's virtual CPU mesh.

In one process: ``div_mod_owner``; ``route_rows_ref`` against a numpy
oracle, and a replay of ``csrc/route.cu``'s two launches (ticketed tiles
whose blocks advance interleaved, warp ranks from ballots or match groups,
the decoupled look-back over a scratch an earlier call left, the pads)
against it, with three mutated schedules that must fail;
``merge_reduce_ref`` and a
replay of ``csrc/merge.cu``'s slots; ``sharded_merge_step`` at n = 1
against JAX's on a one-device mesh, exactly; ``build_mesh`` without a
group.  Then, for gloo groups of 2 and 4 ranks, each spawned once
(``tests/torch_dist_ranks.py``, which imports no jax): the routed build
against JAX's ``ShardedModsetBuilder`` on a mesh of the same size
(``finalize``, ``total_emitted`` and each shard's state) and the
sequential build, the cap-overflow replay, snapshots both ways and their
mismatch errors, ``sharded_merge`` against JAX's and the native merge
(``to_bytes`` of the replayed table), the mesh ``DeviceTable`` against
JAX's and the native table, and the counterpart of ``dryrun_multichip``.
"""

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

from modimizer_tpu.core.modset import Modset as JaxModset  # noqa: E402
from modimizer_tpu.core.seqhash import Seqhash  # noqa: E402
from modimizer_tpu.ops.packed import (  # noqa: E402
    div_mod_owner as jax_div_mod_owner)
from modimizer_tpu.ops.seqhash import (ModimizerScanner,  # noqa: E402
                                       first_encounter_unique)
from modimizer_tpu.parallel import sharded as jsh  # noqa: E402
from modimizer_tpu.parallel.lookup import (  # noqa: E402
    DeviceTable as JaxDeviceTable)
from modimizer_tpu_torch.ops.merge import (ROWS_PER_BLOCK,  # noqa: E402
                                           merge_reduce, merge_reduce_ref)
from modimizer_tpu_torch.ops.packed import div_mod_owner  # noqa: E402
from modimizer_tpu_torch.ops.route import (  # noqa: E402
    MAX_SHARDS, TILE_ROWS, WARPS, route_rows, route_rows_ref)
from modimizer_tpu_torch.parallel import sharded as tsh  # noqa: E402
from modimizer_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh, as_mesh, build_mesh)
from tests import torch_dist_ranks as R  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ALL_ONES = 0xFFFFFFFFFFFFFFFF
U64 = np.uint64


def t64(a):
    """A u64 numpy array as an int64 tensor (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a, U64).view(np.int64))


# ------------------------------------------------------------- the owner

@pytest.mark.parametrize("w", [1, 2, 16, 10, 31, (1 << 32) + 1])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 5])
def test_div_mod_owner_equals_jax(w, n):
    rng = np.random.default_rng(w * 10 + n)
    h = rng.integers(0, 1 << 64, 4000, dtype=U64)
    h[:4] = [0, 1, ALL_ONES, 1 << 63]
    h[4:2004] >>= U64(2)              # canonical hashes are < 2^62
    want = np.asarray(jax_div_mod_owner(jnp.asarray(h), w, n))
    got = div_mod_owner(t64(h), w, n)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------- route_rows

def np_owners(kmers, n, mode, k=16, w=16, factor1=0):
    """Each row's owner by numpy u64 arithmetic; -1 for a sentinel row that
    stays home."""
    x = np.asarray(kmers, U64).copy()
    if mode != "merge":
        x = (x * U64(factor1)) >> U64(64 - 2 * k)
    else:
        w = 1
    q = x // U64(w)
    own = (q % U64(n)).astype(np.int64)
    if mode != "lookup":
        own[np.asarray(kmers, U64) == U64(ALL_ONES)] = -1
    return own


def route_oracle(kmers, n, cap, mode, **kw):
    """Slot o*cap + r holds the r-th row (input order) that owner o takes."""
    own = np_owners(kmers, n, mode, **kw)
    index = np.full(n * cap, -1, np.int32)
    counts = np.zeros(n, np.int32)
    for o in range(n):
        rows = np.nonzero(own == o)[0]
        counts[o] = len(rows)
        index[o * cap:o * cap + min(cap, len(rows))] = rows[:cap]
    return index, counts, bool((counts > cap).any())


def route_inputs(seed, N, sentinel_share=0.1):
    rng = np.random.default_rng(seed)
    kmers = rng.integers(0, 1 << 32, N).astype(U64)
    kmers[rng.random(N) < sentinel_share] = ALL_ONES
    kmers[:3] = [0, ALL_ONES, 7][:N]
    pos = rng.integers(-1, 1 << 31, N).astype(np.int32)
    return kmers, pos


SH = Seqhash.create(16, 16, 17)
ROUTES = [("builder", 2, 1 << 12), ("builder", 3, 700), ("merge", 4, 1000),
          ("merge", 5, 200), ("lookup", 8, 600), ("lookup", 1, 5000),
          ("builder", 7, 40), ("merge", MAX_SHARDS, 8)]


@pytest.mark.parametrize("mode,n,cap", ROUTES)
def test_route_rows_ref_equals_oracle(mode, n, cap):
    kmers, pos = route_inputs(n * 7 + cap, 5000)
    hkw = {} if mode == "merge" else dict(k=SH.k, w=SH.w,
                                          factor1=SH.factor1)
    extra = dict(pos=torch.from_numpy(pos), base=(1 << 40) + 3) \
        if mode == "builder" else {}
    got = route_rows_ref(t64(kmers), n, cap, mode, **hkw, **extra)
    index, counts, over = route_oracle(kmers, n, cap, mode, **hkw)
    assert np.array_equal(got.index.numpy(), index)
    assert np.array_equal(got.counts.numpy(), counts)
    assert bool(got.overflow) == over
    if mode == "builder":
        live = index >= 0
        want_k = np.where(live, kmers.view(np.int64)[index], -1)
        want_p = np.where(live, (pos[index].astype(np.int64) & 0xFFFFFFFF)
                          + (1 << 40) + 3, -1)
        assert np.array_equal(got.send_k.numpy(), want_k)
        assert np.array_equal(got.send_p.numpy(), want_p)
    else:
        assert got.send_k is None and got.send_p is None
    # the wrapper takes the plain version for CPU tensors
    same = route_rows(t64(kmers), n, cap, mode, **hkw, **extra)
    assert all(a is b is None or torch.equal(a, b)
               for a, b in zip(same, got))


@pytest.mark.parametrize("mode", ["builder", "merge", "lookup"])
def test_route_rows_ref_no_rows(mode):
    hkw = {} if mode == "merge" else dict(k=SH.k, w=SH.w,
                                          factor1=SH.factor1)
    extra = dict(pos=torch.zeros(0, dtype=torch.int32), base=5) \
        if mode == "builder" else {}
    got = route_rows(t64(np.zeros(0, U64)), 3, 4, mode, **hkw, **extra)
    assert (got.index == -1).all() and got.index.numel() == 12
    assert not got.counts.any() and not bool(got.overflow)
    if mode == "builder":
        assert (got.send_k == -1).all() and (got.send_p == -1).all()


def test_route_rows_refuses_bad_arguments():
    k = t64(np.arange(10, dtype=U64))
    with pytest.raises(ValueError, match="n_shards"):
        route_rows(k, MAX_SHARDS + 1, 4, "merge")
    with pytest.raises(ValueError, match="mode"):
        route_rows(k, 2, 4, "scan")
    with pytest.raises(ValueError, match="builder mode"):
        route_rows(k, 2, 4, "merge", pos=torch.zeros(10, dtype=torch.int32))
    with pytest.raises(ValueError, match="int64"):
        route_rows(k.to(torch.int32), 2, 4, "merge")


class RouteScratch:
    """csrc/route.cu's scratch, kept across calls: the ticket, a flag word
    a tile (seq << 2 | status) and each tile's n aggregates and n inclusive
    prefixes."""

    def __init__(self, tiles, n):
        self.ticket = 0
        self.flags = np.zeros(tiles, np.int64)
        self.agg = np.zeros((tiles, n), np.int64)
        self.incl = np.zeros((tiles, n), np.int64)


AGGREGATE, PREFIX = 1, 2


def ballot(pred):
    """The 32 lanes' predicate as a mask (bit l: lane l)."""
    return int((np.asarray(pred, bool) << np.arange(32)).sum())


def rank_step(own, n, tally, lane_tally):
    """One step of a warp's ranking, as route.cu does it: each lane's rank
    among its owner's rows so far.  For n a power of two up to 32 the
    tallies are lane registers (``lane_tally``: lane o counts owner o) and
    the groups ballots of the owner's bits (a lane's own owner's group, and
    the group of the owner equal to the lane's number); else
    __match_any_sync groups whose first lane advances ``tally``, the
    warp's tallies in shared memory."""
    lanes = np.arange(32)
    below = (1 << lanes) - 1
    if n & (n - 1) == 0 and n <= 32:
        same = np.full(32, ballot(own >= 0), np.int64)
        ours = same.copy()
        for b in range(n.bit_length() - 1):
            v = ballot((own >> b) & 1)
            same &= np.where((own >> b) & 1, v, ~v & 0xFFFFFFFF)
            ours &= np.where((lanes >> b) & 1, v, ~v & 0xFFFFFFFF)
        hv = lane_tally[own & 31]
        lane_tally += popc(ours)
        return hv + popc(same & below)
    m = np.array([ballot(own == o) for o in own])
    lead = np.array([(int(v) & -int(v)).bit_length() - 1 for v in m])
    hv = np.zeros(32, np.int64)
    for lane in np.nonzero((own >= 0) & (lead == lanes))[0]:
        hv[lane] = tally[own[lane]]
        tally[own[lane]] += popc([m[lane]])[0]
    return hv[lead & 31] + popc(m & below)


def popc(x):
    return np.array([bin(int(v) & 0xFFFFFFFF).count("1") for v in x])


def route_tiles_lanes(kmers, n, cap, mode, scratch, seq, order, mutant=None,
                      **kw):
    """csrc/route.cu's two launches, lane by lane, with the tiles' blocks
    interleaved: ``order`` is a numpy Generator (the next block to advance
    drawn at random among those that can) or "reverse" (every block draws
    its ticket, then the latest that can advance does).  A block advances
    one phase at a time: its ticket; its tallies and published aggregates
    (tile 0: its prefix); its look-back, which waits while a flag of its
    window lacks this call's ``seq``; its published prefix (and the last
    tile's counts); its stores.  ``scratch`` (a RouteScratch) may hold an
    earlier call's descriptors.  Then the pad launch.  Returns (index,
    counts, overflow).  Mutants: "aggregate_as_prefix" (the look-back stops
    at the first ready flag and takes its aggregate as a prefix),
    "stale_seq" (a flag of any seq is ready), "pad_live" (the pads start
    one slot early)."""
    own_all = np_owners(kmers, n, mode, **kw)
    N, T = len(kmers), TILE_ROWS[mode]
    R = T // (32 * WARPS)
    ntiles = max(1, -(-N // T))
    index = np.full(n * cap, -2, np.int64)
    out = {}

    def ready(q):
        f = int(scratch.flags[q])
        return f & 3 if (mutant == "stale_seq" or f >> 2 == seq) else 0

    def block():
        t = scratch.ticket                                   # atomicInc
        scratch.ticket = 0 if t >= ntiles - 1 else t + 1
        yield True
        rows = t * T + np.arange(T).reshape(WARPS, R, 32)
        own = np.where(rows < N, own_all[np.minimum(rows, max(N - 1, 0))]
                       if N else -1, -1)
        tally = np.zeros((WARPS, n), np.int64)
        rank = np.zeros_like(rows)
        for w in range(WARPS):
            lane_tally = np.zeros(32, np.int64)
            for s in range(R):
                rank[w, s] = rank_step(own[w, s], n, tally[w], lane_tally)
            if n & (n - 1) == 0 and n <= 32:
                tally[w] = lane_tally[:n]
        base = np.cumsum(tally, 0) - tally                   # warp bases
        agg = tally.sum(0)
        if t == 0:
            scratch.incl[0] = agg
            scratch.flags[0] = seq << 2 | PREFIX
        else:
            scratch.agg[t] = agg
            scratch.flags[t] = seq << 2 | AGGREGATE
        yield True
        ex = np.zeros(n, np.int64)
        p = t - 1
        while p >= 0:
            window = range(p, max(p - LOOKBACK, -1), -1)
            while not all(ready(q) for q in window):
                yield False                                  # spinning
            if mutant == "aggregate_as_prefix":
                ex += scratch.agg[p]            # the nearest tile's, alone
                break
            st = [ready(q) for q in window]
            last = next((i for i, v in enumerate(st) if v == PREFIX), None)
            found = last is not None
            last = last if found else len(st) - 1
            for i in range(last):
                ex += scratch.agg[p - i]
            ex += (scratch.incl if found else scratch.agg)[p - last]
            p = -1 if found else p - last - 1
        yield True
        incl = ex + agg
        if t > 0:
            scratch.incl[t] = incl
            scratch.flags[t] = seq << 2 | PREFIX
        if t == ntiles - 1:
            out["counts"] = incl.copy()
        yield True
        for w in range(WARPS):
            for s in range(R):
                for lane in range(32):
                    o = own[w, s, lane]
                    if o < 0:
                        continue
                    r = ex[o] + base[w, o] + rank[w, s, lane]
                    if r < cap:
                        assert index[o * cap + r] == -2, "a slot twice"
                        index[o * cap + r] = rows[w, s, lane]

    waiting = [block() for _ in range(ntiles)]
    live = []
    if order == "reverse":             # every ticket drawn first
        for b in waiting:
            next(b)
        live, waiting = waiting, []
    while live or waiting:
        if order == "reverse":         # the latest block that can advance
            for b in reversed(live):
                went = next(b, None)
                if went is None:
                    live.remove(b)
                if went is not False:
                    break
            else:
                raise AssertionError("every block spins: a deadlock")
            continue
        i = int(order.integers(len(live) + bool(waiting)))
        if i == len(live):
            live.append(waiting.pop(0))
        if next(live[i], None) is None:
            live.pop(i)
    assert scratch.ticket == 0, "the ticket is not left 0"
    counts = out["counts"]
    for o in range(n):                                       # route_pad
        c = min(int(counts[o]), cap)
        if mutant == "pad_live":
            c = max(c - 1, 0)
        gx = min(-(-cap // PAD_TPB), max(1, PAD_BLOCKS // n))
        starts = c + np.arange(gx * PAD_TPB)
        for r0 in starts[starts < cap]:
            sl = slice(o * cap + r0, (o + 1) * cap, gx * PAD_TPB)
            assert (index[sl] == -2).all(), "a live slot padded"
            index[sl] = -1
    assert (index != -2).all(), "a slot never written"
    return (index.astype(np.int32), counts.astype(np.int32),
            bool((counts > cap).any()))


PAD_TPB, PAD_BLOCKS = 256, 132 * 8
LOOKBACK = 32 * WARPS      # tiles a look-back step reads
SCHEDULES = [("builder", 3, 2000, 4000), ("merge", 4, 300, 2500),
             ("lookup", 2, 5000, 3000), ("merge", 1, 1000, 0),
             ("merge", 1, 3 * 8192 + 5, 3 * 8192 + 5),
             ("merge", MAX_SHARDS, 12, 9000), ("builder", 8, 1400, 9000)]


def replay_twice(mode, n, cap, N, order, mutant=None):
    """An earlier call's route on the same scratch (other rows, a third of
    them sentinels, so its descriptors differ), then this one's: each
    against the oracle unless it is the mutant's."""
    hkw = {} if mode == "merge" else dict(k=SH.k, w=SH.w,
                                          factor1=SH.factor1)
    tiles = max(1, -(-N // TILE_ROWS[mode]))
    scratch = RouteScratch(tiles, n)
    stale, _ = route_inputs(N + 99, tiles * TILE_ROWS[mode], 0.3)
    got = route_tiles_lanes(stale, n, cap, mode, scratch, 1, order, **hkw)
    assert all(np.array_equal(a, b) for a, b in
               zip(got, route_oracle(stale, n, cap, mode, **hkw)))
    kmers, _pos = route_inputs(N + n, N)
    want = route_oracle(kmers, n, cap, mode, **hkw)
    got = route_tiles_lanes(kmers, n, cap, mode, scratch, 2, order,
                            mutant=mutant, **hkw)
    return got, want


@pytest.mark.parametrize("mode,n,cap,N", SCHEDULES)
def test_route_kernel_schedule_equals_ref(mode, n, cap, N):
    for order in (np.random.default_rng(N + n), "reverse"):
        (index, counts, over), want = replay_twice(mode, n, cap, N, order)
        assert np.array_equal(index, want[0])
        assert np.array_equal(counts, want[1])
        assert over == want[2]


@pytest.mark.parametrize("mutant", ["aggregate_as_prefix", "stale_seq",
                                    "pad_live"])
def test_route_kernel_schedule_mutants_fail(mutant):
    try:
        (index, counts, _over), want = replay_twice(
            "merge", 3, 12000, 4 * 8192 + 7, "reverse", mutant=mutant)
    except AssertionError:
        return
    assert not (np.array_equal(index, want[0])
                and np.array_equal(counts, want[1]))


# --------------------------------------------------------- merge_reduce

def merge_rows(case, seed=3, n=3000):
    """Received rows as the merge makes them: k-mers, depth, info (B's
    rows marked by bit 8) and rank (A's ranks below B's), in one shuffled
    order, sentinel-padded to 1,024 slots past the rows."""
    rng = np.random.default_rng(seed)
    ka = rng.choice(1 << 32, n, replace=False).astype(U64)
    kb = {"a_only": ka[:0], "b_only": rng.choice(1 << 32, n, replace=False)
          .astype(U64) | U64(1 << 33), "both": ka.copy(),
          "saturate": ka.copy(), "flags": ka[::2].copy(),
          "mixed": np.concatenate([ka[::3], rng.integers(1 << 33, 1 << 34,
                                                          500).astype(U64)])
          }[case]
    if case == "b_only":
        ka = ka[:0]
    rng.shuffle(kb)
    k = np.concatenate([ka, kb])
    d = rng.integers(1, 300, len(k)).astype(np.uint32)
    if case == "saturate":
        d[:] = rng.integers(0x8000, 0xFFFF, len(k))
    info = rng.integers(0, 256 if case == "flags" else 64,
                        len(k)).astype(np.uint32)
    info[len(ka):] |= 0x100
    rank = np.arange(len(k), dtype=U64)
    cap = max(1024, len(k) + 1024)
    pad = cap - len(k)
    return (np.concatenate([k, np.full(pad, ALL_ONES, U64)]),
            np.concatenate([d, np.zeros(pad, np.uint32)]),
            np.concatenate([info, np.zeros(pad, np.uint32)]),
            np.concatenate([rank, np.full(pad, ALL_ONES, U64)]), cap)


def jax_merge_step(k, d, i, r, cap):
    out = jsh.sharded_merge_step(*(jnp.asarray(a)[None] for a in
                                   (k, d, i, r)), n_shards=1, cap=cap,
                                 mesh=jsh.build_mesh(n_devices=1))
    return [np.asarray(a).reshape(-1) for a in out]


def port_merge_step(k, d, i, r, cap):
    out = tsh.sharded_merge_step(t64(k), torch.from_numpy(d.view(np.int32)),
                                 torch.from_numpy(i.view(np.int32)), t64(r),
                                 cap=cap, mesh=build_mesh("cpu"))
    return ([out[0].numpy().view(U64), out[1].numpy().view(np.uint32),
             out[2].numpy().view(np.uint32), out[3].numpy().view(U64)],
            bool(out[4]))


@pytest.mark.parametrize("case", ["a_only", "b_only", "both", "saturate",
                                  "flags", "mixed"])
def test_sharded_merge_step_n1_equals_jax(case):
    k, d, i, r, cap = merge_rows(case)
    want = jax_merge_step(k, d, i, r, cap)
    got, over = port_merge_step(k, d, i, r, cap)
    for a, b in zip(want[:4], got):
        assert np.array_equal(a, b)
    assert over == bool(want[4][0]) is False
    n_live = int((k != U64(ALL_ONES)).sum())
    assert (got[0] != U64(ALL_ONES)).sum() == len(np.unique(k[:n_live]))
    if case == "saturate":
        assert (got[1][got[0] != U64(ALL_ONES)] == 0xFFFF).all()


def merge_lanes(k, d, i, r, out_len):
    """csrc/merge.cu's slots: heads counted per block of ROWS_PER_BLOCK,
    the counts scanned, a head's slot its block's start plus its earlier
    lanes' heads (a ballot) plus the earlier warps' counts; its segment
    walked for the smaller and larger rank."""
    m = len(k)
    head = np.ones(m, bool)
    head[1:] = k[1:] != k[:-1]
    nb = max(1, -(-m // ROWS_PER_BLOCK))
    hb = np.zeros(nb * ROWS_PER_BLOCK, bool)
    hb[:m] = head
    bcnt = hb.reshape(nb, -1).sum(1)
    boff = np.cumsum(bcnt) - bcnt
    out = [np.full(out_len, -1, np.int64), np.zeros(out_len, np.int64),
           np.zeros(out_len, np.int64), np.full(out_len, -1, np.int64)]
    for j in np.nonzero(head)[0]:
        b, t = divmod(j, ROWS_PER_BLOCK)
        warp, lane = divmod(t, 32)
        row = hb[b * ROWS_PER_BLOCK:(b + 1) * ROWS_PER_BLOCK]
        slot = boff[b] + row[warp * 32:warp * 32 + lane].sum() \
            + row[:warp * 32].sum()
        e, p, q = j + 1, j, j
        while e < m and k[e] == k[j]:
            p = e if r[e] < r[p] else p
            q = e if r[e] > r[q] else q
            e += 1
        dp, ip = int(d[p]), int(i[p])
        if e - j > 1:
            dd = min((dp + int(d[q])) & 0xFFFFFFFF, 0xFFFF)
            ii = (ip & 3) | min((ip & 3) + (int(i[q]) & 3), 3)
        else:
            dd, ii = min(dp, 0xFFFF), ip & 3 if ip >> 8 & 1 else ip & 0xFF
        if slot < out_len:
            out[0][slot], out[1][slot], out[2][slot] = k[j], dd, ii
            out[3][slot] = r[p]
    return out, int(head.sum()) if m else 0


@pytest.mark.parametrize("case", ["mixed", "both", "b_only"])
def test_merge_kernel_slots_equal_ref(case):
    k, d, i, r, cap = merge_rows(case, n=700)
    live = k != U64(ALL_ONES)
    o = np.argsort(k[live], kind="stable")
    cols = [k[live][o].view(np.int64), d[live][o].view(np.int32),
            i[live][o].view(np.int32), r[live][o].view(np.int64)]
    got = merge_reduce_ref(*(torch.from_numpy(c) for c in cols), cap)
    want, nh = merge_lanes(*cols, cap)
    for a, b in zip(got[:4], want):
        assert np.array_equal(a.numpy().astype(np.int64), b)
    assert int(got[4]) == nh
    # the wrapper takes the plain version for CPU tensors; out_len cuts
    cut = merge_reduce(*(torch.from_numpy(c) for c in cols), nh // 2)
    assert torch.equal(cut[0], got[0][:nh // 2]) and int(cut[4]) == nh


def test_merge_reduce_ref_empty():
    e64 = torch.zeros(0, dtype=torch.int64)
    e32 = torch.zeros(0, dtype=torch.int32)
    out = merge_reduce_ref(e64, e32, e32, e64, 5)
    assert out[0].tolist() == [-1] * 5 and out[1].tolist() == [0] * 5
    assert out[3].tolist() == [-1] * 5 and int(out[4]) == 0


# ------------------------------------------------------------- the mesh

def test_build_mesh_without_a_group():
    m = build_mesh("cpu")
    assert (m.n, m.rank, m.distributed) == (1, 0, False)
    assert m.device == torch.device("cpu")
    x = torch.arange(6)
    assert m.all_to_all(x) is x
    assert m.all_gather(x).shape == (1, 6)
    assert m.any(torch.tensor(True)) and not m.any(False)
    assert (m.sum(torch.tensor(5)), m.max(3)) == (5, 3)
    m.barrier()
    assert build_mesh(["cpu"]).device == torch.device("cpu")
    assert isinstance(as_mesh("cpu"), Mesh)


def test_build_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsh.ShardedModsetBuilder(Seqhash.create(16, 16, 17))


def test_sharded_merge_without_a_group_equals_native():
    ms_a, ms_b = R.modsets(JaxModset, Seqhash, *R.MERGES["merge"])
    mk, md, mi = tsh.sharded_merge(ms_a, ms_b, "cpu")
    assert ms_a.merge(ms_b)
    assert np.array_equal(mk, ms_a.value[1:ms_a.max + 1])
    assert np.array_equal(md, ms_a.depth[1:ms_a.max + 1])
    assert np.array_equal(mi, ms_a.info[1:ms_a.max + 1])


# ------------------------------------------------ gloo groups of 2 and 4

class Run:
    def __init__(self, n, out):
        self.n, self.out = n, out

    def load(self, case):
        """Every rank's results for ``case``."""
        got = []
        for r in range(self.n):
            with np.load(self.out / ("%s.%d.npz" % (case, r))) as f:
                d = {k: f[k] for k in f.files}
            assert "error" not in d, "rank %d:\n%s" % (r, d.get("error"))
            got.append(d)
        return got


def jax_builder(n, sh, **kw):
    return jsh.ShardedModsetBuilder(sh, jsh.build_mesh(n), **kw)


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def run(request, tmp_path_factory):
    """Spawns the ranks once per world size; each writes its results."""
    n = request.param
    out = tmp_path_factory.mktemp("torch_dist_n%d" % n)
    codes, offsets = R.snap_stream()
    cut = int(offsets[R.SNAP_CUT])
    jb = jax_builder(n, Seqhash.create(16, 16, R.SEED), **R.KW)
    jb.feed_stream(codes[:cut], offsets[:R.SNAP_CUT + 1])
    jb.save(str(out / "jax.snap"), cursor=cut)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []
    for r in range(n):
        with open(out / ("rank%d.log" % r), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_dist_ranks", str(r),
                 str(n), str(out / "init"), str(out)], cwd=str(REPO),
                env=env, stdout=log, stderr=subprocess.STDOUT))
    rcs = [p.wait(timeout=600) for p in procs]
    logs = [(out / ("rank%d.log" % r)).read_text()[-3000:]
            for r in range(n)]
    assert rcs == [0] * n, "\n".join(logs)
    return Run(n, out)


def sequential(sh, codes, offsets):
    kmers = ModimizerScanner(sh, host_threshold=1 << 62).scan_stream(
        codes, offsets)[0]
    return first_encounter_unique(kmers), len(kmers)


def assert_replicated(got, *keys):
    for k in keys:
        for g in got[1:]:
            assert np.array_equal(g[k], got[0][k]), k


@pytest.mark.parametrize("name", sorted(R.BUILDS))
def test_build_equals_jax_and_sequential(run, name):
    k, w, n_reads = R.BUILDS[name]
    sh = Seqhash.create(k, w, R.SEED)
    codes, offsets = R.stream(k * 100 + w, n_reads)
    jb = jax_builder(run.n, sh, **R.KW)
    jb.feed_stream(codes, offsets)
    jks, jds = jb.finalize()
    got = run.load("build_" + name)
    assert_replicated(got, "ks", "ds", "total", "S")
    assert np.array_equal(got[0]["ks"], jks)
    assert np.array_equal(got[0]["ds"], jds)
    assert int(got[0]["total"]) == jb.total_emitted
    assert int(got[0]["S"]) == jb.S > R.KW["state_size"]
    for r, g in enumerate(got):
        for key in ("state_k", "state_d", "state_m"):
            assert np.array_equal(g[key], np.asarray(getattr(jb, key))[r]), \
                (r, key)
        assert int(g["n_compact"]) > 2
    (uniq, counts), n_emit = sequential(sh, codes, offsets)
    assert np.array_equal(got[0]["ks"], uniq)
    assert np.array_equal(got[0]["ds"], counts)
    assert int(got[0]["total"]) == n_emit


def test_cap_overflow_replay(run):
    sh = Seqhash.create(16, 16, R.SEED)
    codes, offsets = R.overflow_stream(
        lambda s: ModimizerScanner(s, host_threshold=1 << 62), sh)
    jb = jax_builder(run.n, sh, chunk_per_dev=1 << 10, state_size=1 << 12,
                     cap=R.OVERFLOW_CAP)
    jb.feed_stream(codes, offsets)
    jks, jds = jb.finalize()
    got = run.load("overflow")
    assert_replicated(got, "ks", "ds", "total", "cap", "bo", "n_replay")
    (uniq, counts), n_emit = sequential(sh, codes, offsets)
    assert np.array_equal(got[0]["ks"], uniq) and np.array_equal(jks, uniq)
    assert np.array_equal(got[0]["ds"], counts) and np.array_equal(jds,
                                                                   counts)
    assert int(got[0]["total"]) == jb.total_emitted == n_emit
    assert int(got[0]["cap"]) > R.OVERFLOW_CAP and jb.cap > R.OVERFLOW_CAP
    assert int(got[0]["n_replay"]) > 0


def test_snapshot_from_jax(run):
    codes, offsets = R.snap_stream()
    sh = Seqhash.create(16, 16, R.SEED)
    meta = np.load(run.out / "jax.snap")["meta"]
    got = run.load("snap_from_jax")
    assert_replicated(got, "ks", "ds", "total")
    g = got[0]
    assert (int(g["cursor"]), int(g["total0"]), int(g["S0"]), int(g["bo0"]),
            int(g["cap0"]), int(g["chunk0"])) == (
        int(meta[10]), int(meta[9]), int(meta[5]), int(meta[6]),
        int(meta[7]), int(meta[8]))
    (uniq, counts), n_emit = sequential(sh, codes, offsets)
    assert np.array_equal(g["ks"], uniq) and np.array_equal(g["ds"], counts)
    assert int(g["total"]) == n_emit


def test_snapshot_to_jax_and_back(run):
    codes, offsets = R.snap_stream()
    sh = Seqhash.create(16, 16, R.SEED)
    (uniq, counts), n_emit = sequential(sh, codes, offsets)
    got = run.load("snap_to_port")
    assert_replicated(got, "ks", "ds", "total", "saved_total")
    assert np.array_equal(got[0]["ks"], uniq)
    assert int(got[0]["total"]) == n_emit
    snap = np.load(run.out / "port.snap")
    assert snap["state_k"].shape == (run.n, int(snap["meta"][5]))
    jb, cursor = jsh.ShardedModsetBuilder.restore(
        str(run.out / "port.snap"), sh, jsh.build_mesh(run.n),
        max_buffer_rows=R.KW["max_buffer_rows"])
    assert jb.total_emitted == int(got[0]["saved_total"])
    jb.feed_stream(codes[cursor:], offsets[R.SNAP_CUT:] - cursor,
                   base=cursor)
    jks, jds = jb.finalize()
    assert np.array_equal(jks, uniq) and np.array_equal(jds, counts)
    assert jb.total_emitted == n_emit


def test_snapshot_mismatch_errors(run):
    got = run.load("snap_errors")
    for g in got:
        assert "does not match" in str(g["seqhash"])
        assert "re-shard" in str(g["shards"])
        assert "has %d shards but the mesh has %d" % (run.n + 1, run.n) \
            in str(g["shards"])


@pytest.mark.parametrize("name", sorted(R.MERGES))
def test_sharded_merge_equals_jax_and_native(run, name):
    got = run.load(name)
    assert_replicated(got, "mk", "md", "mi")
    assert all(bool(g["other_hasher"]) for g in got)
    ms_a, ms_b = R.modsets(JaxModset, Seqhash, *R.MERGES[name])
    jk, jd, ji = jsh.sharded_merge(ms_a, ms_b, jsh.build_mesh(run.n))
    g = got[0]
    assert np.array_equal(g["mk"], jk) and np.array_equal(g["md"], jd)
    assert np.array_equal(g["mi"], ji)
    new_b = ~np.isin(ms_b.value[1:ms_b.max + 1], ms_a.value[1:ms_a.max + 1])
    flagged = ms_b.info[1:ms_b.max + 1][new_b] > 3
    assert flagged.any()                      # B's flags on new k-mers
    assert ms_a.merge(ms_b)
    assert np.array_equal(g["mk"], ms_a.value[1:ms_a.max + 1])
    assert np.array_equal(g["md"], ms_a.depth[1:ms_a.max + 1])
    assert np.array_equal(g["mi"], ms_a.info[1:ms_a.max + 1])
    assert (g["md"] == 0xFFFF).any()
    ms_c = JaxModset(Seqhash.create(16, 16, R.SEED), 20)
    ms_c.add_batch(g["mk"], np.zeros(len(g["mk"]), np.uint32))
    ms_c.depth[1:ms_c.max + 1] = g["md"]
    ms_c.info[1:ms_c.max + 1] = g["mi"]
    assert ms_c.to_bytes() == ms_a.to_bytes()


def test_device_table_equals_jax_and_native(run):
    got = run.load("lookup")
    assert_replicated(got, "found", "empty")
    ms = R.modsets(JaxModset, Seqhash, *R.MERGES["merge"])[0]
    kmers = ms.value[1:ms.max + 1]
    q = R.lookup_queries(kmers)
    jt = JaxDeviceTable(kmers, np.arange(1, ms.max + 1, dtype=np.uint32),
                        ms.hasher, jsh.build_mesh(run.n))
    want = jt.find(q)
    g = got[0]
    assert g["found"].dtype == np.uint32
    assert np.array_equal(g["found"], want)
    assert np.array_equal(g["found"], ms.find_batch(q))
    assert np.array_equal(g["native"], want)
    assert (g["found"][np.isin(q, kmers)] > 0).all()
    assert g["found"][q == U64(ALL_ONES)].tolist() == [0]
    assert all(len(x["none"]) == 0 for x in got)
    assert not g["empty"].any()
    assert sum(int(x["n_keys"]) for x in got) == ms.max
    assert all(int(x["n_keys"]) < ms.max for x in got)


def test_dryrun_multichip_counterpart(run):
    got = run.load("dryrun")
    assert_replicated(got, "ks", "ds", "total", "mk", "md", "found",
                      "fused_k16", "fused_k19")
    g = got[0]
    sh = Seqhash.create(16, 16, R.SEED)
    codes, offsets = R.dryrun_stream()
    (uniq, counts), n_emit = sequential(sh, codes, offsets)
    assert np.array_equal(g["ks"], uniq) and np.array_equal(g["ds"], counts)
    assert int(g["total"]) == n_emit
    assert np.array_equal(g["mk"], g["merged_k"])
    assert np.array_equal(g["md"], g["merged_d"])
    assert np.array_equal(g["found"], g["native"])
    from modimizer_tpu_torch.ops.consts import BLK_COMPACT
    big, boffs = R.fused_stream(BLK_COMPACT)
    for kk in (16, 19):
        (u2, c2), _ = sequential(Seqhash.create(kk, 31, R.SEED), big, boffs)
        assert np.array_equal(g["fused_k%d" % kk], u2)
        assert np.array_equal(g["fused_d%d" % kk], c2)
