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

The plain version ``overlap_pairs_ref`` does it in three steps: sort the
hit rows by hkey (h where the row is a counted copy-1 row, else
0xFFFFFFFF), stably, so that rows arriving in (x, j) order are in the JAX
package's (h, x, j) order (``sort_rows``); write every pair row
(``pair_rows_ref``); sort the pair keys and reduce each to its row count,
its sum of strand agreement and its smallest rank (``reduce_pairs``).
``overlap_pairs`` on the card stores no pair row (``overlap_join``, the
CUDA kernels of ``csrc/overlaps.cu``): the same stable ``torch.sort``, a
launch that gives every row its group's bounds, then a join that reduces
each read's pairs in a shared-memory table as it enumerates them, in a
count pass and an emit pass around a ``cumsum`` of the per-read counts
(and, for a read with more distinct partners than the table holds, the
same walk into a table in device memory).

The JAX device program enumerates the pairs by offset (1 + 2 (dmax - 1)
rolled copies of every row, widening dmax until it covers the largest
group); the pairs here are the ones that sweep keeps once it is wide
enough, so the result is the same for any group size.  ``dmax`` and
``pair_cap`` stay in the signatures for the API and do not bound anything.

The host preparation (first occurrences, n_repeat, the depth gate) is one
native pass, ``overlap_inputs``; the final candidate order is the JAX
package's code.  Hits carry the strand in their top bit and are masked on
the host; x < 2^31 keeps every pair key positive in int64, and the rank
keeps the JAX packing (j << 20) | k.
"""

import numpy as np
import torch

from .. import _build
from ..native import lib as native_lib
from ..utils import profiling
from .mesh import as_device

HNONE = 0xFFFFFFFF             # hkey of a row that is in no group
_I64_MAX = (1 << 63) - 1
# distinct partners a read keeps in the join's shared-memory table; a read
# with more takes the overflow path (csrc/overlaps.cu)
TABLE_CAP = 512
MAX_CAP = 4096          # the largest cap whose table fits (overlaps.cu)
# the overflow path's tables: at most this many blocks and bytes
DENSE_BLOCKS = 264
DENSE_BYTES = 1 << 28


def _check_rows(h, xs, js, st, first):
    n = h.shape[0]
    for name, t, dt in (("h", h, torch.int64), ("xs", xs, torch.int32),
                        ("js", js, torch.int32), ("st", st, torch.uint8),
                        ("first", first, torch.uint8)):
        if t.dtype != dt or t.shape != (n,) or not t.is_contiguous():
            raise ValueError("pair_rows_ref: %s must be contiguous %s [%d]"
                             % (name, dt, n))
        if t.device != h.device:
            raise ValueError("pair_rows_ref: inputs on different devices")


def pair_rows_ref(h, xs, js, st, first):
    """Every pair row, in the plain version of overlap_pairs.  Rows sorted
    by hkey ``h`` (int64); ``xs``, ``js`` int32, ``st`` and ``first``
    uint8.  Returns (key int64, rank int64, agree uint8) with one row for
    every x-side row a (live and first) and every row b of a's group, in
    (a, b) order, and max_group (the largest live group, at least 1, as the
    JAX program reports it)."""
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


def _hkey(hs, is_c1):
    return torch.where(is_c1.bool(), hs.to(torch.int64),
                       torch.full_like(hs, HNONE, dtype=torch.int64))


def _u8(t):
    return t if t.dtype == torch.uint8 else t.to(torch.uint8)


def _check_inputs(xs, js, hs, strand, is_c1, firstc1):
    n = xs.shape[0]
    for name, t in (("xs", xs), ("js", js), ("hs", hs), ("strand", strand),
                    ("is_c1", is_c1), ("firstc1", firstc1)):
        if name in ("xs", "js", "hs") and t.dtype != torch.int32:
            raise ValueError("overlap_pairs: %s must be int32" % name)
        if t.shape != (n,) or not t.is_contiguous():
            raise ValueError("overlap_pairs: %s must be contiguous [%d]"
                             % (name, n))
        if t.device != xs.device:
            raise ValueError("overlap_pairs: inputs on different devices")


def sort_rows(xs, js, hs, strand, is_c1, firstc1):
    """Step 1: hit rows (in (x, j) order) sorted by hkey, stably; returns
    pair_rows_ref's inputs (h, xs, js, st, first)."""
    h, order = torch.sort(_hkey(hs, is_c1), stable=True)
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


def _launch(name, dev, *args):
    """C entry point mz_<name> of csrc/overlaps.cu on ``dev``'s stream,
    counted in _build.LAUNCHES[name]."""
    with torch.cuda.device(dev):
        _build.check(getattr(_build.lib(), "mz_" + name)(
            *args, torch.cuda.current_stream(dev).cuda_stream),
            "overlap_pairs (%s)" % name)
    _build.LAUNCHES[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def sort_key(hs, is_c1):
    """The 32-bit key the card sorts the rows by: h | 0x80000000 (negative)
    for a counted copy-1 row, 0 for the rest; a stable sort by it is the
    stable sort by hkey (csrc/overlaps.cu ``live_key``)."""
    return torch.where(is_c1.bool(), hs | torch.iinfo(torch.int32).min,
                       torch.zeros_like(hs))


def group_rows(xs, hs, st, is_c1):
    """Step A on the card: the rows sorted stably by ``sort_key``
    (``torch.sort``), then launch 1 of csrc/overlaps.cu.  Returns (grp int32
    [n, 2]: each input row's group start in sorted order and its group
    size, 0 outside a group; yb int32 [n]: each sorted row's (x << 1) |
    strand; the largest live group as int32 [1])."""
    n, dev = xs.shape[0], xs.device
    h, order = torch.sort(sort_key(hs, is_c1), stable=True)
    grp = torch.empty((n, 2), dtype=torch.int32, device=dev)
    yb = torch.empty(n, dtype=torch.int32, device=dev)
    mg = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch("overlap_groups", dev, h.data_ptr(), order.data_ptr(),
            xs.data_ptr(), st.data_ptr(), n, grp.data_ptr(), yb.data_ptr(),
            mg.data_ptr())
    return grp, yb, mg


def join_pass(rows, groups, cap, dcnt, flags=None, nflag=None, incl=None,
              out=(None,) * 4):
    """Launch 2 (``incl`` None: the count pass, into ``dcnt``, ``flags``
    and ``nflag``) or launch 4 (the emit pass into ``out``) of
    csrc/overlaps.cu.  ``rows`` = (xs, js, st, first) in input order,
    ``groups`` = (grp, yb)."""
    xs = rows[0]
    _launch("overlap_join", xs.device,
            *[t.data_ptr() for t in rows + groups], xs.shape[0], cap,
            dcnt.data_ptr(), _ptr(flags), _ptr(nflag), _ptr(incl),
            *[_ptr(t) for t in out])


def dense_pass(rows, groups, flags, nflag, nid, blocks, table, dcnt,
               incl=None, out=(None,) * 4):
    """Launch 3 (``incl`` None: the flagged reads' counts into ``dcnt``) or
    launch 5 (their rows into ``out``): the overflow path, ``blocks``
    blocks with a table of ``nid`` ids each in ``table``."""
    xs = rows[0]
    _launch("overlap_dense", xs.device,
            *[t.data_ptr() for t in rows + groups], xs.shape[0],
            flags.data_ptr(), nflag.data_ptr(), nid, blocks,
            table.data_ptr(), dcnt.data_ptr(), _ptr(incl),
            *[_ptr(t) for t in out])


def dense_blocks(nid, n_flagged):
    """Blocks of the overflow path: one a flagged read, at most DENSE_BLOCKS
    and at most what DENSE_BYTES holds of tables of nid ids (16 B an id)."""
    return max(1, min(n_flagged, DENSE_BLOCKS, DENSE_BYTES // (16 * nid)))


def overlap_join(xs, js, hs, strand, is_c1, firstc1, *, cap=TABLE_CAP):
    """overlap_pairs on CUDA rows through csrc/overlaps.cu, with no tensor
    sized by the pair rows: returns its six results and the number of
    reads that had more than ``cap`` distinct partners (the overflow
    path)."""
    _check_inputs(xs, js, hs, strand, is_c1, firstc1)
    if not 1 <= cap <= MAX_CAP:
        raise ValueError("overlap_join: cap must be in [1, %d]" % MAX_CAP)
    n, dev = xs.shape[0], xs.device
    if n == 0:
        e = torch.empty(0, dtype=torch.int64, device=dev)
        return e, e.clone(), e.clone(), e.clone(), 0, 1, 0
    rows = (xs, js, _u8(strand), _u8(firstc1))
    grp, yb, mg = group_rows(xs, hs, rows[2], is_c1)
    groups = (grp, yb)
    dcnt = torch.zeros(n, dtype=torch.int32, device=dev)
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    nflag = torch.zeros(1, dtype=torch.int32, device=dev)
    join_pass(rows, groups, cap, dcnt, flags, nflag)
    incl = torch.cumsum(dcnt, 0)
    total, n_ovf, max_group, last_x = torch.stack(
        [incl[-1], nflag[0].to(torch.int64), mg[0].to(torch.int64),
         xs[-1].to(torch.int64)]).tolist()
    table = None
    if n_ovf:
        nid = last_x + 1
        blocks = dense_blocks(nid, n_ovf)
        table = torch.empty(2 * nid * blocks, dtype=torch.int64, device=dev)
        dense_pass(rows, groups, flags, nflag, nid, blocks, table, dcnt)
        incl = torch.cumsum(dcnt, 0)
        total = int(incl[-1])
    out = tuple(torch.empty(total, dtype=torch.int64, device=dev)
                for _ in range(4))
    if total:
        join_pass(rows, groups, cap, dcnt, incl=incl, out=out)
        if n_ovf:
            dense_pass(rows, groups, flags, nflag, nid, blocks, table, dcnt,
                       incl, out)
    return (*out, total, max(1, max_group), n_ovf)


def _overlap_pairs(pairs, xs, js, hs, strand, is_c1, firstc1):
    rows = sort_rows(xs, js, hs, strand, is_c1, firstc1)
    key, rank, agree, max_group = pairs(*rows)
    keys, counts, n_agree, first = reduce_pairs(key, rank, agree)
    return keys, counts, n_agree, first, keys.numel(), max_group


def overlap_pairs(xs, js, hs, strand, is_c1, firstc1, *, dmax=64,
                  pair_cap=None):
    """Pair enumeration and reduction on the rows' device: csrc/overlaps.cu
    for CUDA tensors (``overlap_join``), overlap_pairs_ref for CPU tensors.
    Per hit row: xs, js, hs int32 (h masked to 31 bits), strand, is_c1,
    firstc1 (0 or 1, any integer type or bool).  Returns (keys (x << 32) |
    y, counts, n_agree, first_rank; int64, one per distinct pair, ascending
    key), n_pairs and max_group.  Exact for any group size; ``dmax`` and
    ``pair_cap`` are accepted for the API only."""
    if xs.device.type == "cpu":
        return overlap_pairs_ref(xs, js, hs, strand, is_c1, firstc1)
    if xs.device.type != "cuda":
        raise ValueError("overlap_pairs: unsupported device %s" % xs.device)
    return overlap_join(xs, js, hs, strand, is_c1, firstc1)[:6]


def overlap_pairs_ref(xs, js, hs, strand, is_c1, firstc1, *, dmax=64,
                      pair_cap=None):
    """Plain PyTorch version of overlap_pairs, on any device: sort_rows,
    pair_rows_ref (every pair row), reduce_pairs (a sort and a segment
    reduce)."""
    return _overlap_pairs(pair_rows_ref, xs, js, hs, strand, is_c1,
                          firstc1)


def overlap_inputs(readset):
    """The host preparation of overlap_counts, one native pass over the hit
    rows (``rs_overlap_inputs``, native/modasm_native.cpp): per hit row
    (x, j, h, strand uint32; is_c1_cnt, firstc1_cnt bool), per read
    n_repeat (int32) and bad_repeat.  firstc1 is the first row of a copy-1
    mod in its read (modasm.c:335-338), n_repeat counts the copy-1 rows
    after it; mods of saturated depth have no inv list (rs_inv_build,
    modasm.c:269), so both row masks leave them out, n_repeat not.  A mod
    id past the modset's arrays raises IndexError."""
    hits = np.ascontiguousarray(readset.hits, np.uint32)
    off = np.ascontiguousarray(readset.hit_off, np.int64)
    info = np.ascontiguousarray(readset.ms.info, np.uint8)
    depth = np.ascontiguousarray(readset.ms.depth, np.uint16)
    n, n_reads = len(hits), len(off) - 1
    if n_reads < 0 or off[0] != 0 or off[-1] != n or (np.diff(off) < 0).any():
        raise ValueError("overlap_inputs: hit_off must rise from 0 to %d" % n)
    ms_max = min(len(info), len(depth)) - 1
    x, j, h, strand = (np.empty(n, np.uint32) for _ in range(4))
    is_c1, firstc1 = np.empty(n, bool), np.empty(n, bool)
    n_repeat = np.empty(n_reads, np.int32)
    h_max = native_lib().rs_overlap_inputs(
        hits, off, n_reads, info, depth, ms_max, x, j, h, strand,
        is_c1.view(np.uint8), firstc1.view(np.uint8), n_repeat)
    if h_max > ms_max:
        raise IndexError("overlap_inputs: mod %d past the modset's %d "
                         "entries" % (h_max, ms_max + 1))
    profiling.count("overlaps.prep_rows", n)
    return (x, j, h, strand, is_c1, firstc1), n_repeat, n_repeat > 0


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
    overlaps.prep, overlaps.device (upload, overlap_pairs, download),
    overlaps.order; counter overlaps.prep_rows (the hit rows prepared)."""
    if device is None:
        device = getattr(readset, "device", None)
    dev = as_device(device, "overlap_counts")
    with profiling.span("overlaps.prep"):
        rows, n_repeat, bad_repeat = overlap_inputs(readset)
    with profiling.span("overlaps.device"):
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
    with profiling.span("overlaps.order"):
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
