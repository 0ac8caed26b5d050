"""Device k-mer table lookup on one device (port of the n = 1 path of
``modimizer_tpu/parallel/lookup.py``: ``DeviceTable`` and
``_find_sorted_local``).

The table is a sorted k-mer column with a parallel value column; a batch of
queries is answered by one binary search per query, an equality test, and
the value or 0 where absent (modsetIndexFind with isAdd = false).  On the
card that is the CUDA kernel ``csrc/lookup.cu`` (``find_sorted``); on the
CPU its plain PyTorch version ``find_sorted_ref``.

u64 k-mers ride in int64: the keys are sorted in int64 order and searched
with signed compares, so every u64 query finds its equal key.  The JAX
table pads with one all-ones sentinel row (value 0) so that its search can
clamp; in int64 that pad is -1 and would sort first, so the port keeps the
live rows only and answers 0 past them.  The mesh-sharded table
(``_sharded_find``) is not ported: more than one device raises.
"""

import numpy as np
import torch

from .. import _build
from .sharded import _one_device


def _check(keys, vals, q):
    for name, t, dt in (("keys", keys, torch.int64), ("vals", vals,
                                                       torch.int32),
                        ("q", q, torch.int64)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("find_sorted: %s must be contiguous %s [n]"
                             % (name, dt))
        if t.device != keys.device:
            raise ValueError("find_sorted: inputs on different devices")
    if vals.shape != keys.shape:
        raise ValueError("find_sorted: keys and vals differ in length")


def find_sorted_ref(keys, vals, q):
    """Plain PyTorch version of the lookup kernel: keys int64 [n] ascending,
    vals int32 [n], q int64 [nq] -> int32 [nq], vals[p] where keys[p] == q,
    else 0."""
    _check(keys, vals, q)
    if keys.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    pos = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    hit = keys[pos] == q
    return torch.where(hit, vals[pos], torch.zeros_like(vals[pos]))


def find_sorted(keys, vals, q):
    """The lookup: launches csrc/lookup.cu for CUDA tensors, runs
    find_sorted_ref for CPU tensors.  An empty query launches nothing."""
    if keys.device.type == "cpu":
        return find_sorted_ref(keys, vals, q)
    if keys.device.type != "cuda":
        raise ValueError("find_sorted: unsupported device %s" % keys.device)
    _check(keys, vals, q)
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    if q.numel() == 0:
        return out
    L = _build.lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = L.mz_find_sorted(keys.data_ptr(), vals.data_ptr(), keys.numel(),
                              q.data_ptr(), q.numel(), out.data_ptr(),
                              stream)
    _build.check(rc, "find_sorted")
    _build.LAUNCHES["find_sorted"] += 1
    return out


class DeviceTable:
    """Sorted-k-mer table on one torch device, built from host (kmers,
    values); queries are answered in input order.  ``device``: a
    torch.device or its name, or a list of one; None takes the CUDA card."""

    def __init__(self, kmers: np.ndarray, values: np.ndarray, hasher,
                 device=None):
        self.device = _one_device(device, "DeviceTable")
        self.n = 1
        self.sh = hasher
        kmers = np.ascontiguousarray(kmers, np.uint64).view(np.int64)
        values = np.ascontiguousarray(values, np.uint32).view(np.int32)
        keys = torch.from_numpy(kmers).to(self.device)
        self.keys, order = torch.sort(keys, stable=True)
        self.vals = torch.from_numpy(values).to(self.device)[order]

    def find(self, q_kmers: np.ndarray) -> np.ndarray:
        """Batched lookup; returns u32 values aligned with q_kmers, 0 where
        absent (modsetIndexFind isAdd=false semantics)."""
        q_kmers = np.ascontiguousarray(q_kmers, np.uint64)
        if len(q_kmers) == 0:
            return np.zeros(0, np.uint32)
        q = torch.from_numpy(q_kmers.view(np.int64)).to(self.device)
        out = find_sorted(self.keys, self.vals, q)
        return out.cpu().numpy().view(np.uint32)
