"""Device k-mer table lookup, on one device or over a shard mesh (port of
``modimizer_tpu/parallel/lookup.py``: ``DeviceTable``,
``_find_sorted_local`` and ``_sharded_find``).

The table is a sorted k-mer column with a parallel value column; a batch of
queries is answered by a lower-bound search per query, an equality test,
and the value or 0 where absent (modsetIndexFind with isAdd = false).  On
the card that is the CUDA kernel ``csrc/lookup.cu`` (``find_sorted``), which
searches a B+-tree of 16-key nodes laid over the column: its upper levels
(every 16th key, every 256th, ...: ``search_index``) are built once with
the table.  On the CPU it is the plain PyTorch version ``find_sorted_ref``,
which ignores the index.

u64 k-mers ride in int64: the keys are sorted in int64 order and searched
with signed compares, so every u64 query finds its equal key.  The JAX
table pads with one all-ones sentinel row (value 0) so that its search can
clamp; in int64 that pad is -1 and would sort first, so the port keeps the
live rows only and answers 0 past them.

On a mesh over a process group (``parallel/mesh.py``) rank r keeps the
keys it owns, by the builder's hash partition (``div_mod_owner`` of the
canonical hash), sorted with their own search index.  ``find`` is SPMD:
every rank passes the whole query array and takes its slice of ``qcap``
queries; ``route_rows`` (lookup mode: every slot routes) sends each query
to its owner with one ``all_to_all``, the owner answers with
``find_sorted``, the answers ride the inverse exchange back to the slots
they came from, and the route's own index stores them in input order (the
JAX program sorts by a carried slot id instead).  A gather gives every
rank the whole answer.
"""

import numpy as np
import torch

from .. import _build
from ..ops.route import SENTINEL, gather_rows, route_rows
from ..utils import profiling
from .mesh import as_mesh


def count_lookup(answers):
    """The job's ``lookup.queries`` and ``lookup.hits`` (answers not 0)."""
    if profiling.recording():
        profiling.count("lookup.queries", len(answers))
        profiling.count("lookup.hits", np.count_nonzero(answers))


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


FAN = 16          # keys a node of the search (csrc/lookup.cu)
TOP = 8192        # entries of its top level, held in shared memory


def index_levels(n):
    """The search's levels above the keys (lookup_index::levels): the
    length of each level k >= 1, keys[::16^k], up to the first of at most
    TOP entries."""
    lens = []
    m = n
    while m > TOP:
        m = (m + FAN - 1) // FAN
        lens.append(m)
    return lens


def search_index(keys):
    """The search index of an ascending int64 key column: levels 1..K
    (every 16th key, every 256th, ...) in one int64 tensor, each level but
    the last padded with zeros to a multiple of 16 entries (the kernel's
    nodes are 128-byte lines); empty when the keys fit the top level."""
    lens = index_levels(keys.numel())
    parts = []
    for k, m in enumerate(lens, 1):
        parts.append(keys[::FAN ** k])
        if k < len(lens) and m % FAN:
            parts.append(keys.new_zeros(FAN - m % FAN))
    return torch.cat(parts) if parts else keys.new_empty(0)


def find_sorted_ref(keys, vals, q, index=None):
    """Plain PyTorch version of the lookup kernel: keys int64 [n] ascending,
    vals int32 [n], q int64 [nq] -> int32 [nq], vals[p] where keys[p] == q,
    else 0.  ``index`` is ignored."""
    _check(keys, vals, q)
    if keys.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    pos = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    hit = keys[pos] == q
    return torch.where(hit, vals[pos], torch.zeros_like(vals[pos]))


def find_sorted(keys, vals, q, index=None):
    """The lookup: launches csrc/lookup.cu for CUDA tensors, runs
    find_sorted_ref for CPU tensors.  ``index`` is ``search_index(keys)``
    (built here when None).  An empty query launches nothing."""
    if keys.device.type == "cpu":
        return find_sorted_ref(keys, vals, q)
    if keys.device.type != "cuda":
        raise ValueError("find_sorted: unsupported device %s" % keys.device)
    _check(keys, vals, q)
    if index is None:
        index = search_index(keys)
    lens = index_levels(keys.numel())
    want = sum(-(-m // FAN) * FAN for m in lens[:-1]) + sum(lens[-1:])
    if (index.dtype != torch.int64 or index.device != keys.device
            or index.shape != (want,) or not index.is_contiguous()):
        raise ValueError("find_sorted: index is not search_index(keys)")
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    if q.numel() == 0:
        return out
    L = _build.lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = L.mz_find_sorted(keys.data_ptr(), vals.data_ptr(), keys.numel(),
                              index.data_ptr() if index.numel() else None,
                              q.data_ptr(), q.numel(), out.data_ptr(),
                              stream)
    _build.check(rc, "find_sorted")
    _build.LAUNCHES["find_sorted"] += 1
    return out


class DeviceTable:
    """Sorted-k-mer table on a mesh (a ``Mesh``, or a device for one rank:
    a torch.device or its name, or a list of one; None takes the CUDA
    card), built from host (kmers, values); queries are answered in input
    order."""

    def __init__(self, kmers: np.ndarray, values: np.ndarray, hasher,
                 device=None):
        self.mesh = as_mesh(device)
        self.device = self.mesh.device
        self.n = self.mesh.n
        self.sh = hasher
        kmers = np.ascontiguousarray(kmers, np.uint64)
        values = np.ascontiguousarray(values, np.uint32)
        if self.mesh.distributed:
            mine = self._owner(kmers) == self.mesh.rank
            kmers, values = kmers[mine], values[mine]
        keys = torch.from_numpy(kmers.view(np.int64)).to(self.device)
        self.keys, order = torch.sort(keys, stable=True)
        self.vals = torch.from_numpy(values.view(np.int32)).to(
            self.device)[order]
        self.index = search_index(self.keys)

    def _owner(self, kmers):
        """The rank that owns each k-mer (the JAX table's host rule)."""
        h = (kmers * np.uint64(self.sh.factor1)) >> np.uint64(self.sh.shift1)
        w = self.sh.w
        if w & (w - 1) == 0:
            q = h >> np.uint64(w.bit_length() - 1)
        else:
            q = h // np.uint64(w)
        return (q % np.uint64(self.n)).astype(np.int64)

    def find(self, q_kmers: np.ndarray) -> np.ndarray:
        """Batched lookup; returns u32 values aligned with q_kmers, 0 where
        absent (modsetIndexFind isAdd=false semantics).  On a mesh every
        rank passes the same queries and gets the whole answer."""
        q_kmers = np.ascontiguousarray(q_kmers, np.uint64)
        out = self._find(q_kmers)
        count_lookup(out)
        return out

    def _find(self, q_kmers):
        nq = len(q_kmers)
        if nq == 0:
            return np.zeros(0, np.uint32)
        if not self.mesh.distributed:
            q = torch.from_numpy(q_kmers.view(np.int64)).to(self.device)
            out = find_sorted(self.keys, self.vals, q, self.index)
            return out.cpu().numpy().view(np.uint32)
        mesh, sh = self.mesh, self.sh
        qcap = -(-nq // self.n)
        mine = np.full(qcap, SENTINEL, np.int64)
        part = q_kmers[mesh.rank * qcap:(mesh.rank + 1) * qcap]
        mine[:len(part)] = part.view(np.int64)
        q = torch.from_numpy(mine).to(self.device)
        # a rank sends qcap queries, so qcap slots an owner never overflow
        # (the JAX program checks the flag and widens)
        rt = route_rows(q, self.n, qcap, "lookup", k=sh.k, w=sh.w,
                        factor1=sh.factor1)
        recv = mesh.all_to_all(gather_rows(rt.index, q, SENTINEL))
        ans = find_sorted(self.keys, self.vals, recv, self.index)
        ans = torch.where(recv != SENTINEL, ans, torch.zeros_like(ans))
        back = mesh.all_to_all(ans)
        sent = rt.index >= 0
        out = torch.zeros(qcap, dtype=torch.int32, device=self.device)
        out[rt.index[sent].to(torch.int64)] = back[sent]
        out = mesh.all_gather(out).reshape(-1)[:nq]
        return out.cpu().numpy().view(np.uint32)
