"""Overlap discovery for modasm on one torch device (port of
``modimizer_tpu/parallel/overlaps.py``; reference: findOverlaps,
modasm.c:314-418).

Phase 1 of findOverlaps is a self-join of the hit table on the mod id:
for every read x and every first-occurrence copy-1 hit h of x, every hit
row of h's inverse list (every read y holding h) counts one for the
candidate pair (x, y); the strand-agreement bit rides along (the
orientation vote, modasm.c:361-365), and the first-encounter rank is
min-reduced so candidates can be ordered like the reference's stable sort
by descending count over first-encounter order (modasm.c:300-304,353).

``overlap_pairs`` runs it on the device in four steps:
  1. sort the hit rows by hkey (h where the row is a counted copy-1 row,
     else 0xFFFFFFFF), stably: they arrive in (x, j) order, so this is the
     JAX package's (h, x, j) order (``torch.sort``);
  2. and 3. count each group and write every pair row once at its exact
     slot: the CUDA kernel ``csrc/overlaps.cu`` (``pair_rows``; its plain
     PyTorch version is ``pair_rows_ref``);
  4. sort the pair keys and reduce each key to its row count, its sum of
     strand agreement and its smallest rank (``torch.sort``,
     ``unique_consecutive``, ``cumsum``, ``scatter_reduce_``).
The JAX device program enumerates the pairs by offset (1 + 2 (dmax - 1)
rolled copies of every row, widening dmax until it covers the largest
group); the pair rows here are the ones that sweep keeps once it is wide
enough, so the result is the same for any group size.  ``dmax`` and
``pair_cap`` stay in the signatures for the API and do not bound anything.

The host preparation (first occurrences, n_repeat, the depth gate) and the
final candidate order are the JAX package's code.  Hits carry TOPBIT
(strand) and are masked on the host; x < 2^31 keeps every pair key
positive in int64, and the rank keeps the JAX packing (j << 20) | k.
"""

import numpy as np
import torch

from .. import _build
from ..utils import profiling
from .sharded import _one_device

TOPBIT = np.uint32(0x80000000)
TOPMASK = np.uint32(0x7FFFFFFF)
HNONE = 0xFFFFFFFF             # hkey of a row that is in no group
_I64_MAX = (1 << 63) - 1


def _check_rows(h, xs, js, st, first):
    n = h.shape[0]
    for name, t, dt in (("h", h, torch.int64), ("xs", xs, torch.int32),
                        ("js", js, torch.int32), ("st", st, torch.uint8),
                        ("first", first, torch.uint8)):
        if t.dtype != dt or t.shape != (n,) or not t.is_contiguous():
            raise ValueError("pair_rows: %s must be contiguous %s [%d]"
                             % (name, dt, n))
        if t.device != h.device:
            raise ValueError("pair_rows: inputs on different devices")


def pair_rows_ref(h, xs, js, st, first):
    """Plain PyTorch version of the pair kernel.  Rows sorted by hkey ``h``
    (int64); ``xs``, ``js`` int32, ``st`` and ``first`` uint8.  Returns
    (key int64, rank int64, agree uint8) with one row for every x-side row
    a (live and first) and every row b of a's group, in (a, b) order, and
    max_group (the largest live group, at least 1, as the JAX program
    reports it)."""
    _check_rows(h, xs, js, st, first)
    n = h.shape[0]
    dev = h.device
    start = torch.searchsorted(h, h)
    end = torch.searchsorted(h, h, right=True)
    live = h != HNONE
    g = torch.where(live, end - start, torch.zeros_like(start))
    cnt = torch.where(first.bool(), g, torch.zeros_like(g))
    max_group = max(1, int(g.max()) if n else 0)
    incl = torch.cumsum(cnt, 0)
    total = int(incl[-1]) if n else 0
    a = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    kb = torch.arange(total, device=dev) - (incl - cnt)[a]
    b = start[a] + kb
    key = (xs[a].to(torch.int64) << 32) | xs[b].to(torch.int64)
    rank = (js[a].to(torch.int64) << 20) | kb
    agree = (st[a] == st[b]).to(torch.uint8)
    return key, rank, agree, max_group


def count_launch(h, first):
    """Launch 1 of csrc/overlaps.cu on CUDA rows: (krank, cnt int32 [n],
    the largest live group as int32 [1])."""
    n, dev = h.shape[0], h.device
    krank = torch.empty(n, dtype=torch.int32, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    mg = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.check(_build.lib().mz_overlap_count(
            h.data_ptr(), first.data_ptr(), n, krank.data_ptr(),
            cnt.data_ptr(), mg.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream),
            "overlap_pairs (count)")
    return krank, cnt, mg


def emit_launch(xs, js, st, krank, cnt, incl, total):
    """Launch 2 of csrc/overlaps.cu: the ``total`` pair rows (key, rank
    int64, agree uint8), ``incl`` the inclusive prefix of ``cnt``."""
    dev = xs.device
    key = torch.empty(total, dtype=torch.int64, device=dev)
    rank = torch.empty(total, dtype=torch.int64, device=dev)
    agree = torch.empty(total, dtype=torch.uint8, device=dev)
    if total:
        with torch.cuda.device(dev):
            _build.check(_build.lib().mz_overlap_emit(
                xs.data_ptr(), js.data_ptr(), st.data_ptr(),
                krank.data_ptr(), cnt.data_ptr(), incl.data_ptr(),
                xs.shape[0], key.data_ptr(), rank.data_ptr(),
                agree.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
                "overlap_pairs (emit)")
    return key, rank, agree


def pair_rows(h, xs, js, st, first):
    """The pair kernel: launches csrc/overlaps.cu (two kernels, with a
    torch.cumsum and one read of the total between them) for CUDA tensors,
    runs pair_rows_ref for CPU tensors."""
    if h.device.type == "cpu":
        return pair_rows_ref(h, xs, js, st, first)
    if h.device.type != "cuda":
        raise ValueError("pair_rows: unsupported device %s" % h.device)
    _check_rows(h, xs, js, st, first)
    if h.shape[0] == 0:
        e = torch.empty(0, dtype=torch.int64, device=h.device)
        return e, e.clone(), torch.empty(0, dtype=torch.uint8,
                                         device=h.device), 1
    krank, cnt, mg = count_launch(h, first)
    incl = torch.cumsum(cnt, 0)
    total, max_group = torch.stack([incl[-1], mg[0].to(torch.int64)]
                                   ).tolist()
    key, rank, agree = emit_launch(xs, js, st, krank, cnt, incl, total)
    _build.LAUNCHES["overlap_pairs"] += 1
    return key, rank, agree, max(1, max_group)


def sort_rows(xs, js, hs, strand, is_c1, firstc1):
    """Step 1: hit rows (in (x, j) order) sorted by hkey, stably; returns
    pair_rows' inputs (h, xs, js, st, first)."""
    hkey = torch.where(is_c1.bool(), hs.to(torch.int64),
                       torch.full_like(hs, HNONE, dtype=torch.int64))
    h, order = torch.sort(hkey, stable=True)
    return (h, xs[order].contiguous(), js[order].contiguous(),
            strand[order].to(torch.uint8).contiguous(),
            firstc1[order].to(torch.uint8).contiguous())


def reduce_pairs(key, rank, agree):
    """Step 4: per distinct key (ascending), (key, row count, sum of agree,
    smallest rank), all int64."""
    if key.numel() == 0:
        e = torch.empty(0, dtype=torch.int64, device=key.device)
        return e, e.clone(), e.clone(), e.clone()
    sk, order = torch.sort(key)
    r = rank[order]
    uniq, inv, counts = torch.unique_consecutive(sk, return_inverse=True,
                                                 return_counts=True)
    ends = torch.cumsum(counts, 0)
    cs = torch.cumsum(agree[order], 0)
    n_agree = cs[ends - 1] - torch.cat([cs.new_zeros(1), cs[ends[:-1] - 1]])
    first = torch.full_like(uniq, _I64_MAX).scatter_reduce_(0, inv, r,
                                                            "amin")
    return uniq, counts, n_agree, first


def _overlap_pairs(pairs, xs, js, hs, strand, is_c1, firstc1):
    rows = sort_rows(xs, js, hs, strand, is_c1, firstc1)
    key, rank, agree, max_group = pairs(*rows)
    keys, counts, n_agree, first = reduce_pairs(key, rank, agree)
    return keys, counts, n_agree, first, keys.numel(), max_group


def overlap_pairs(xs, js, hs, strand, is_c1, firstc1, *, dmax=64,
                  pair_cap=None):
    """Pair enumeration and reduction on the rows' device (the kernel on
    the card).  Per hit row: xs, js, hs int32 (h masked to 31 bits),
    strand, is_c1, firstc1 (bool or uint8).  Returns (keys (x << 32) | y,
    counts, n_agree, first_rank; int64, one per distinct pair, ascending
    key), n_pairs and max_group.  Exact for any group size; ``dmax`` and
    ``pair_cap`` are accepted for the API only."""
    return _overlap_pairs(pair_rows, xs, js, hs, strand, is_c1, firstc1)


def overlap_pairs_ref(xs, js, hs, strand, is_c1, firstc1, *, dmax=64,
                      pair_cap=None):
    """overlap_pairs with the kernel's plain version (pair_rows_ref) on
    any device."""
    return _overlap_pairs(pair_rows_ref, xs, js, hs, strand, is_c1,
                          firstc1)


def overlap_inputs(readset):
    """The host preparation of overlap_counts (the JAX package's code):
    per hit row (x, j, h, strand, is_c1_cnt, firstc1_cnt), and per read
    n_repeat and bad_repeat."""
    hits = np.ascontiguousarray(readset.hits, np.uint32)
    off = np.asarray(readset.hit_off, np.int64)
    n_reads = len(off) - 1
    info = readset.ms.info
    h = hits & TOPMASK
    strand = (hits >> np.uint32(31)).astype(np.uint32)
    x = np.repeat(np.arange(n_reads, dtype=np.uint32), np.diff(off))
    j = (np.arange(len(hits), dtype=np.uint32)
         - np.repeat(off[:-1], np.diff(off)).astype(np.uint32))
    is_c1 = (info[h] & 3) == 1
    # saturated-depth mods have no inv list (rs_inv_build / modasm.c:269)
    # and their inv walk is skipped on the x side too — exclude them from
    # COUNTING everywhere (they still participate in hmap/dup semantics)
    depth_ok = readset.ms.depth[h] != np.uint16(0xFFFF)

    # first-occurrence-within-read of each copy1 mod (modasm.c:335-338):
    # order (x, j) within (x, h) groups picks the smallest j as first
    o = np.lexsort((j, h, x))
    xo, ho, c1o = x[o], h[o], is_c1[o]
    same = np.concatenate([[False], (xo[1:] == xo[:-1]) & (ho[1:] == ho[:-1])])
    firstc1 = np.zeros(len(hits), bool)
    firstc1[o] = (~same) & c1o
    dup_c1 = np.zeros(len(hits), bool)
    dup_c1[o] = same & c1o
    n_repeat = np.bincount(x[dup_c1], minlength=n_reads).astype(np.int32)
    bad_repeat = n_repeat > 0
    return ((x, j, h, strand, is_c1 & depth_ok, firstc1 & depth_ok),
            n_repeat, bad_repeat)


def overlap_counts(readset, dmax: int = 64, pair_cap: int = None,
                   device=None):
    """Batched findOverlaps phase 1 for ALL reads at once, on ``device``
    (a torch.device or its name; None: the readset's device, else the CUDA
    card).

    readset: object with hits (u32 mod|TOPBIT), hit_off (i64 CSR), and the
    modset info/depth arrays (copy-number bits, modset.h:44-56).

    Returns dict with per-pair arrays (x, y, n_hit, n_agree, first_rank)
    sorted by (x, -n_hit, first-encounter order) — the reference's olap
    order after its stable sort (modasm.c:300-304,353) — plus per-read
    n_repeat and bad_repeat.  Stage timers (MODIMIZER_STAGES=1):
    overlaps.prep, overlaps.device (upload, the four steps, download),
    overlaps.order."""
    if device is None:
        device = getattr(readset, "device", None)
    dev = _one_device(device, "overlap_counts")
    with profiling.stage("overlaps.prep"):
        rows, n_repeat, bad_repeat = overlap_inputs(readset)
    with profiling.stage("overlaps.device"):
        x, j, h, strand, is_c1_cnt, firstc1_cnt = (
            torch.from_numpy(np.ascontiguousarray(a).view(
                np.int32 if a.dtype == np.uint32 else np.uint8)).to(dev)
            for a in rows)
        keys, cnt, plus, rank, _n, _mg = overlap_pairs(
            x, j, h, strand, is_c1_cnt, firstc1_cnt, dmax=dmax,
            pair_cap=pair_cap)
        keys = keys.cpu().numpy().view(np.uint64)
        cnt = cnt.cpu().numpy().astype(np.uint32)
        plus = plus.cpu().numpy().astype(np.uint32)
        rank = rank.cpu().numpy().view(np.uint64)
    with profiling.stage("overlaps.order"):
        px = (keys >> 32).astype(np.uint32)
        py = (keys & 0xFFFFFFFF).astype(np.uint32)
        # reference candidate order: per x, stable sort by descending count
        # over first-encounter order
        oo = np.lexsort((rank, (~cnt).astype(np.uint32), px))
    return {
        "x": px[oo], "y": py[oo], "n_hit": cnt[oo],
        "n_agree": plus[oo], "first_rank": rank[oo],
        "n_repeat": n_repeat, "bad_repeat": bad_repeat,
    }
