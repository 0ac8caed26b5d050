"""Routing of rows to the shard that owns them: the CUDA kernel
``csrc/route.cu`` (``route_rows``) and its plain PyTorch version.

Replaces the pad-to-cap sort and gather that three JAX programs share
(``modimizer_tpu/parallel/sharded.py:1692-1715`` in ``sharded_scan_route``,
``:2101-2128`` in ``sharded_merge_step``, ``modimizer_tpu/parallel/
lookup.py:136-157`` in ``_sharded_find``): each row's owner, then ``cap``
slots an owner, filled with the owner's rows and padded.  The TPU has no
vector scatter, so JAX sorts the rows with ``n*cap`` pad rows and gathers
each group's first ``cap``; here each row is ranked among its owner's rows
and stored in its slot.

Modes (the owner rule and which rows route):
- ``"builder"``: owner ``div_mod_owner((kmer * factor1) >> (64 - 2k), w,
  n)``; sentinel rows stay home.  Also forms the routed columns: the k-mer
  and the global position ``base + (pos & 0xFFFFFFFF)`` (JAX
  ``sharded.py:1694``), pads ``SENTINEL`` and ``POS_INF``.
- ``"merge"``: owner ``div_mod_owner(kmer, 1, n)``, by the k-mer itself
  (``sharded.py:2101``; deliberately not the builder's rule); sentinel
  rows stay home.
- ``"lookup"``: the builder's owner; every row routes (a sentinel query
  answers 0 where it lands).

Outputs: ``index`` int32 [n*cap], the input row of each slot, -1 for a
pad (slot ``o*cap + r`` holds owner o's r-th row); ``counts`` int32 [n],
each owner's rows, including those past ``cap``; ``overflow`` bool scalar,
any count above ``cap`` (the rows past ``cap`` are dropped and the caller
widens and routes again); in builder mode ``send_k``, ``send_p`` int64
[n*cap].  Rows keep their input order within an owner, so the output is
deterministic (JAX's unstable sort is not, and nothing downstream depends
on that order).  ``gather_rows`` fills a payload column through the index.
"""

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _build
from .packed import as_i64, div_mod_owner, lsr

MODES = {"builder": 0, "merge": 1, "lookup": 2}
# owners whose per-warp tallies csrc/route.cu keeps in shared memory: eight
# warps a block, 4 bytes an owner, 32 KB
MAX_SHARDS = 1024
SEG = 1024              # rows a warp's segment in csrc/route.cu
SENTINEL = -1
_M32 = 0xFFFFFFFF


class Routed(NamedTuple):
    index: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor
    send_k: Optional[torch.Tensor]
    send_p: Optional[torch.Tensor]


def _check(kmers, n_shards, cap, mode, k, w, factor1, pos):
    if mode not in MODES:
        raise ValueError("route_rows: mode %r is not one of %s"
                         % (mode, sorted(MODES)))
    if not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(
            "route_rows: n_shards=%d outside [1, %d] (csrc/route.cu keeps "
            "an owner's tally in shared memory)" % (n_shards, MAX_SHARDS))
    if cap < 1 or n_shards * cap >= 1 << 31:
        raise ValueError("route_rows: cap=%d outside [1, 2^31 / n)" % cap)
    if kmers.dtype != torch.int64 or kmers.dim() != 1 or \
            not kmers.is_contiguous():
        raise ValueError("route_rows: kmers must be contiguous int64 [N]")
    if kmers.numel() >= 1 << 31:
        raise ValueError("route_rows: %d rows; at most 2^31 - 1"
                         % kmers.numel())
    if mode != "merge":
        if not 1 <= k <= 31 or not 1 <= w < 1 << 64 or \
                not 0 <= factor1 < 1 << 64:
            raise ValueError("route_rows: k=%d, w=%d or factor1 out of "
                             "range" % (k, w))
    if (pos is None) != (mode != "builder"):
        raise ValueError("route_rows: positions go with builder mode only")
    if pos is not None and (pos.dtype != torch.int32 or pos.shape !=
                            kmers.shape or not pos.is_contiguous()
                            or pos.device != kmers.device):
        raise ValueError("route_rows: pos must be contiguous int32 [N] on "
                         "the k-mers' device")


def owners(kmers, n_shards, mode, *, k=0, w=1, factor1=0):
    """Each row's owner (int64), by ``mode``'s rule."""
    if mode == "merge":
        return div_mod_owner(kmers, 1, n_shards)
    return div_mod_owner(lsr(kmers * as_i64(factor1), 64 - 2 * k), w,
                         n_shards)


def route_rows_ref(kmers, n_shards, cap, mode, *, k=0, w=1, factor1=0,
                   pos=None, base=0):
    """Plain PyTorch version of the route_rows kernel (any device)."""
    _check(kmers, n_shards, cap, mode, k, w, factor1, pos)
    dev = kmers.device
    n = n_shards
    owner = owners(kmers, n, mode, k=k, w=w, factor1=factor1)
    rows = torch.arange(kmers.numel(), dtype=torch.int64, device=dev)
    if mode != "lookup":
        live = kmers != SENTINEL
        owner, rows = owner[live], rows[live]
    owner, order = torch.sort(owner, stable=True)
    rows = rows[order]
    counts = torch.bincount(owner, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    r = torch.arange(owner.numel(), dtype=torch.int64, device=dev) \
        - start[owner]
    keep = r < cap
    index = torch.full((n * cap,), -1, dtype=torch.int32, device=dev)
    index[owner[keep] * cap + r[keep]] = rows[keep].to(torch.int32)
    send_k = send_p = None
    if mode == "builder":
        send_k = gather_rows(index, kmers, SENTINEL)
        gpos = (pos.to(torch.int64) & _M32) + as_i64(base)
        send_p = gather_rows(index, gpos, -1)
    return Routed(index, counts.to(torch.int32), (counts > cap).any(),
                  send_k, send_p)


def gather_rows(index, col, pad):
    """``col`` through a route's index: col[index], ``pad`` in pad slots."""
    got = col[index.clamp(min=0).to(torch.int64)]
    return torch.where(index >= 0, got, torch.full_like(got, pad))


def route_rows(kmers, n_shards, cap, mode, *, k=0, w=1, factor1=0,
               pos=None, base=0):
    """Route N rows to ``n_shards`` owners, ``cap`` slots each: launches
    csrc/route.cu for CUDA tensors, runs route_rows_ref for CPU tensors.
    Returns a ``Routed`` on the k-mers' device."""
    if kmers.device.type == "cpu":
        return route_rows_ref(kmers, n_shards, cap, mode, k=k, w=w,
                              factor1=factor1, pos=pos, base=base)
    if kmers.device.type != "cuda":
        raise ValueError("route_rows: unsupported device %s" % kmers.device)
    _check(kmers, n_shards, cap, mode, k, w, factor1, pos)
    dev = kmers.device
    n, N = n_shards, kmers.numel()
    nseg = max(1, -(-N // SEG))
    scratch = torch.empty(n * nseg, dtype=torch.int32, device=dev)
    index = torch.empty(n * cap, dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    send_k = send_p = None
    if mode == "builder":
        send_k = torch.empty(n * cap, dtype=torch.int64, device=dev)
        send_p = torch.empty(n * cap, dtype=torch.int64, device=dev)
    shift = 0 if mode == "merge" else 64 - 2 * k
    if mode == "merge":
        w, factor1 = 1, 0               # owner by the k-mer: no hash
    L = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.mz_route_rows(
            kmers.data_ptr(), None if pos is None else pos.data_ptr(),
            ctypes.c_uint64(base & ((1 << 64) - 1)), N, MODES[mode],
            ctypes.c_uint64(factor1), shift, ctypes.c_uint64(w),
            n, cap, nseg, scratch.data_ptr(), index.data_ptr(),
            counts.data_ptr(), overflow.data_ptr(),
            None if send_k is None else send_k.data_ptr(),
            None if send_p is None else send_p.data_ptr(), stream)
    _build.check(rc, "route_rows")
    _build.LAUNCHES["route_rows"] += 1
    return Routed(index, counts, overflow, send_k, send_p)
