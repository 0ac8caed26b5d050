"""Per-chunk device programs: scan+compact, then densify into one dense
stream-order prefix (port of ``modimizer_tpu/ops/device_scan.py``).

``densify`` is the CUDA kernel ``csrc/densify.cu`` (contract of the JAX
package's ``_densify_cols_search``); ``densify_ref`` is its plain PyTorch
version.  ``scan_chunk`` is the scanner's one chunk program: with
``with_meta`` it is the JAX package's ``_scan_chunk`` (the ``(pos << 1) |
isF`` meta path of ``scan_stream``), without it ``_scan_chunk_kmers`` (k-mers
alone, ``modutils -a``).  Validity always rides as dense bit-words, the
chunk's slice of ``pk_valid_words``; the JAX package's prefix mask, its
sparse-exception upload and its ``lax.scan`` chunk grouping are not ported.
"""

import torch

from .. import _build
from .scan_kernel import scan_compact

DENSIFY_TILE = 256     # compaction blocks a tile of csrc/densify.cu


def _check_rows(out_k, out_meta, cnt, bo):
    nb = cnt.shape[0]
    if cnt.dtype != torch.int32 or cnt.dim() != 1:
        raise ValueError("densify: cnt must be int32 [nb]")
    if out_k.dtype != torch.int64 or out_k.shape != (nb * bo,):
        raise ValueError("densify: out_k must be int64 [%d]" % (nb * bo))
    if out_meta is not None and (out_meta.dtype != torch.int32
                                 or out_meta.shape != (nb * bo,)):
        raise ValueError("densify: out_meta must be int32 [%d]" % (nb * bo))
    for t in (out_k, out_meta, cnt):
        if t is not None and (not t.is_contiguous()
                              or t.device != out_k.device):
            raise ValueError("densify: inputs must be contiguous and on "
                             "one device")


def _block_bases(cnt, bo):
    """(live rows per block, exclusive prefix sum of them) as int64."""
    live = cnt.to(torch.int64).clamp_(max=bo)
    return live, torch.cumsum(live, 0) - live


def densify_ref(out_k, out_meta, cnt, *, bo, cap):
    """Plain PyTorch version of the densify kernel: returns (dense_k [cap],
    dense_meta [cap] or None) with -1 sentinels past the live rows."""
    _check_rows(out_k, out_meta, cnt, bo)
    nb = cnt.shape[0]
    dev = out_k.device
    live, base = _block_bases(cnt, bo)
    j = torch.arange(bo, dtype=torch.int64, device=dev)
    dst = base[:, None] + j
    sel = (j < live[:, None]) & (dst < cap)
    dst = dst[sel]
    dk = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    dk[dst] = out_k.view(nb, bo)[sel]
    if out_meta is None:
        return dk, None
    dm = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    dm[dst] = out_meta.view(nb, bo)[sel]
    return dk, dm


def densify(out_k, out_meta, cnt, *, bo, cap):
    """Dense stream-order prefix of the block rows: launches
    csrc/densify.cu for CUDA tensors, runs densify_ref for CPU tensors.
    out_meta may be None (kmers only).  On the card the call is two kernel
    launches and nothing else: the outputs and the per-tile scratch are
    ``torch.empty``, and the kernels write every slot."""
    if out_k.device.type == "cpu":
        return densify_ref(out_k, out_meta, cnt, bo=bo, cap=cap)
    if out_k.device.type != "cuda":
        raise ValueError("densify: unsupported device %s" % out_k.device)
    _check_rows(out_k, out_meta, cnt, bo)
    L = _build.lib()
    dev = out_k.device
    nb = cnt.shape[0]
    dk = torch.empty(cap, dtype=torch.int64, device=dev)
    dm = (None if out_meta is None
          else torch.empty(cap, dtype=torch.int32, device=dev))
    agg = torch.empty(-(-nb // DENSIFY_TILE), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.mz_densify(
            out_k.data_ptr(), None if dm is None else out_meta.data_ptr(),
            cnt.data_ptr(), agg.data_ptr(), nb, bo, cap, dk.data_ptr(),
            None if dm is None else dm.data_ptr(), stream)
    _build.check(rc, "densify")
    _build.LAUNCHES["densify"] += 1
    return dk, dm


def _total(n_emit, overflow, cap):
    """Emit count as int32, or -1 when a block or the dense cap overflowed
    (the caller retries wider, then rescans on the host)."""
    bad = overflow | (n_emit > cap)
    return torch.where(bad, torch.full_like(n_emit, -1), n_emit).to(
        torch.int32)


def scan_chunk(sw, vbits, *, k, w, factor1, bo, cap, with_meta):
    """One chunk of C = 32 (len(sw) - 2) positions, those whose bit of
    ``vbits`` is set live: (dense k-mers int64 [cap] in exact stream order,
    dense meta int32 [cap] = (pos << 1) | isF or None without
    ``with_meta``, total int32 scalar; total < 0 flags overflow)."""
    C = 32 * (sw.shape[0] - 2)
    out_k, out_meta, cnt, n_emit, overflow = scan_compact(
        sw, vbits, k=k, w=w, factor1=factor1, C=C, bo=bo,
        meta_isf=with_meta, with_meta=with_meta)
    cap = min(cap, out_k.shape[0])
    dk, dm = densify(out_k, out_meta, cnt, bo=bo, cap=cap)
    return dk, dm, _total(n_emit, overflow, cap)
