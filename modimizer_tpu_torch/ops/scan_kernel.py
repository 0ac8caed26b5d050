"""Scan + emit + in-block compaction of one chunk: the CUDA kernel
``csrc/scan_compact.cu`` and its plain PyTorch version.

Port of the JAX package's scan+compact step, whose contract is
``parallel/sharded.py::_scan_compact_core(..., posmajor=True)`` (the XLA
program on the JAX main path) and whose TPU kernels are
``ops/scan_kernel.py::scan_compact_tiles`` and
``ops/scan_kernel_mxu.py::scan_compact_mxu``.  Compaction blocks are ``blk``
consecutive positions (default ``BLK_COMPACT``, as the JAX package blocks);
rows leave each block in stream order.

Tensors: ``sw`` int64 [C/32 + 2] (big-endian-per-word packed bases, halo
included), ``vbits`` int64 [C/64] (bit p = position p is valid).  Outputs:
``out_k`` int64 [C/blk * bo] (u64 k-mers, -1 = sentinel), ``out_meta`` int32
(u32 p or (p << 1) | isF, -1 = sentinel; None with ``with_meta=False``,
the k-mers-only call, which stores no meta), ``cnt`` int32 [C/blk] full
per-block emit counts, ``n_emit`` int64 scalar, ``overflow`` bool scalar.
"""

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from .consts import BLK_COMPACT, MAX_BLK
from .packed import (as_i64, canonical_hashes, derive_tw, emit_test,
                     expand_bits, extract_kmers)


class KernelParams(NamedTuple):
    k: int
    w: int
    factor1: int        # u64, as the kernel takes it (ctypes.c_uint64)
    factor1_i64: int    # the same bits as a signed int64 (plain torch)
    shift: int          # 64 - 2k: hash = (kmer * factor1) >> shift
    mask: int           # 4^k - 1: the k-mer bits


def _params(k: int, w: int, factor1: int) -> KernelParams:
    if not 1 <= k <= 31:
        raise ValueError("scan_compact: k=%d outside [1, 31]" % k)
    if not 1 <= w < (1 << 64):
        raise ValueError("scan_compact: w=%d outside [1, 2^64)" % w)
    if not 0 <= factor1 < (1 << 64):
        raise ValueError("scan_compact: factor1 is not a u64")
    return KernelParams(k, w, factor1, as_i64(factor1), 64 - 2 * k,
                        (1 << (2 * k)) - 1)


def kernel_params(sh) -> KernelParams:
    """A core.seqhash.Seqhash as the kernel's arguments."""
    p = _params(sh.k, sh.w, sh.factor1)
    if (p.shift, p.mask) != (sh.shift1, sh.mask):
        raise ValueError("Seqhash shift1/mask disagree with k=%d" % sh.k)
    return p


def _check_inputs(sw, vbits, C, bo, blk, meta_isf):
    if blk & (blk - 1) or not 128 <= blk <= MAX_BLK:
        raise ValueError("scan_compact: blk=%d is not a power of two in "
                         "[128, %d]" % (blk, MAX_BLK))
    if C <= 0 or C % blk:
        raise ValueError("scan_compact: C=%d is not a positive multiple of "
                         "blk=%d" % (C, blk))
    if meta_isf and C > 1 << 31:
        raise ValueError("scan_compact: C=%d too large for (p << 1) | isF "
                         "in 32 bits" % C)
    if not 1 <= bo <= blk:
        raise ValueError("scan_compact: bo=%d outside [1, blk]" % bo)
    for name, t, n in (("sw", sw, C // 32 + 2), ("vbits", vbits, C // 64)):
        if t.dtype != torch.int64 or t.shape != (n,):
            raise ValueError("scan_compact: %s must be int64 [%d], got %s %s"
                             % (name, n, t.dtype, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("scan_compact: %s is not contiguous" % name)
    if sw.device != vbits.device:
        raise ValueError("scan_compact: sw and vbits on different devices")


def _divisible(hashes, w: int):
    """hashes % w == 0 by division: canonical hashes are below 2^62, so
    int64 ``%`` is exact for w < 2^63, and above that only 0 is a
    multiple."""
    if w < 1 << 63:
        return hashes % w == 0
    return hashes == 0


def scan_compact_ref(sw, vbits, *, k, w, factor1, C, bo, meta_isf,
                     blk=BLK_COMPACT, with_meta=True):
    """Plain PyTorch version of the scan_compact kernel (any device)."""
    _check_inputs(sw, vbits, C, bo, blk, meta_isf)
    p = _params(k, w, factor1)
    dev = sw.device
    h, hrc = extract_kmers(sw, derive_tw(sw), k, C)
    hashes, kmers, isF = canonical_hashes(h, hrc, k, p.factor1)
    emit = expand_bits(vbits, C) & _divisible(hashes, w)
    nb = C // blk
    e2 = emit.view(nb, blk)
    csum = torch.cumsum(e2, dim=1, dtype=torch.int32)
    cnt = csum[:, -1].contiguous()
    keep = e2 & (csum <= bo)                 # rank = csum - 1 < bo
    slot = (torch.arange(nb, dtype=torch.int64, device=dev)[:, None] * bo
            + (csum - 1))[keep]
    out_k = torch.full((nb * bo,), -1, dtype=torch.int64, device=dev)
    out_k[slot] = kmers.view(nb, blk)[keep]
    out_meta = None
    if with_meta:
        pos = torch.arange(C, dtype=torch.int64, device=dev)
        meta = (pos << 1) | isF.to(torch.int64) if meta_isf else pos
        out_meta = torch.full((nb * bo,), -1, dtype=torch.int32, device=dev)
        out_meta[slot] = meta.view(nb, blk)[keep].to(torch.int32)
    n_emit = cnt.sum(dtype=torch.int64)
    return out_k, out_meta, cnt, n_emit, (cnt > bo).any()


def scan_compact(sw, vbits, *, k, w, factor1, C, bo, meta_isf,
                 blk=BLK_COMPACT, with_meta=True):
    """Scan+compact one chunk: launches csrc/scan_compact.cu for CUDA
    tensors, runs scan_compact_ref for CPU tensors.  Returns
    (out_k, out_meta, cnt, n_emit, overflow) on sw's device; out_meta is
    None with ``with_meta=False``."""
    if sw.device.type == "cpu":
        return scan_compact_ref(sw, vbits, k=k, w=w, factor1=factor1, C=C,
                                bo=bo, meta_isf=meta_isf, blk=blk,
                                with_meta=with_meta)
    if sw.device.type != "cuda":
        raise ValueError("scan_compact: unsupported device %s" % sw.device)
    _check_inputs(sw, vbits, C, bo, blk, meta_isf)
    p = _params(k, w, factor1)
    # k <= 16: k-mers and hashes fit 32 bits, and so does the emit test
    et = emit_test(w, 32 if k <= 16 else 64)
    L = _build.lib()
    dev = sw.device
    nb = C // blk
    out_k = torch.empty(nb * bo, dtype=torch.int64, device=dev)
    out_meta = (torch.empty(nb * bo, dtype=torch.int32, device=dev)
                if with_meta else None)
    meta_ptr = None if out_meta is None else out_meta.data_ptr()
    cnt = torch.empty(nb, dtype=torch.int32, device=dev)
    n_emit = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.mz_scan_compact(
            sw.data_ptr(), vbits.data_ptr(), C, p.k,
            ctypes.c_uint64(p.factor1), ctypes.c_uint64(et.minv), et.rot,
            ctypes.c_uint64(et.limit), blk, bo, int(bool(meta_isf)),
            out_k.data_ptr(), meta_ptr, cnt.data_ptr(),
            n_emit.data_ptr(), overflow.data_ptr(), stream)
    _build.check(rc, "scan_compact")
    _build.LAUNCHES["scan_compact"] += 1
    return out_k, out_meta, cnt, n_emit, overflow
