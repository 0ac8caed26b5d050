"""Per-k-mer reduction of the sharded modset merge: the CUDA kernel
``csrc/merge.cu`` (``merge_reduce``) and its plain PyTorch version.

Replaces the reduction half of ``modimizer_tpu/parallel/sharded.py::
sharded_merge_step`` (``:2131-2162``), modsetMerge's math (modset.c:
106-128) on the rows a shard received.  Input: the live rows only (the
int64 sentinel -1 would sort first: drop the pads before sorting), sorted
by k-mer: ``kmers`` int64 [m], ``depth`` and ``info`` int32 [m] (u32
bits), ``rank`` int64 [m].  A k-mer has one row or two (one from each
modset, A's with the smaller rank); the reduction picks the smaller-rank
row p of each segment itself, so the rows need no lexicographic sort.  Per
segment, with q its larger-rank row:
- depth ``min(d_p + d_q, 0xFFFF)`` (a u32 add; d_q = 0 for a single row);
- info ``(i_p & 3) | min((i_p & 3) + (i_q & 3), 3)`` with two rows, else
  ``i_p & 3`` for a row with B's marker (bit 8) and ``i_p & 0xFF`` for
  A's;
- rank ``rank_p``.
Output: the heads in k-mer order in the first slots of ``out_len``-row
columns (k-mer and rank -1, depth and info 0 past them) and ``n_heads``
(int64 scalar tensor).
"""

import torch

from .. import _build

ROWS_PER_BLOCK = 512      # csrc/merge.cu's TPB: a thread a row
SENTINEL = -1
_M32 = 0xFFFFFFFF
_I64_MAX = (1 << 63) - 1


def _check(kmers, depth, info, rank, out_len):
    for name, t, dt in (("kmers", kmers, torch.int64),
                        ("depth", depth, torch.int32),
                        ("info", info, torch.int32),
                        ("rank", rank, torch.int64)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("merge_reduce: %s must be contiguous %s [m]"
                             % (name, dt))
        if t.shape != kmers.shape or t.device != kmers.device:
            raise ValueError("merge_reduce: %s differs from kmers in shape "
                             "or device" % name)
    if kmers.numel() >= 1 << 31 or out_len < 0:
        raise ValueError("merge_reduce: m=%d rows, out_len=%d"
                         % (kmers.numel(), out_len))


def merge_reduce_ref(kmers, depth, info, rank, out_len):
    """Plain PyTorch version of the merge_reduce kernel (any device):
    (out_k, out_d, out_i, out_r, n_heads)."""
    _check(kmers, depth, info, rank, out_len)
    dev, m = kmers.device, kmers.numel()
    out = (torch.full((out_len,), SENTINEL, dtype=torch.int64, device=dev),
           torch.zeros(out_len, dtype=torch.int32, device=dev),
           torch.zeros(out_len, dtype=torch.int32, device=dev),
           torch.full((out_len,), -1, dtype=torch.int64, device=dev))
    head = torch.ones(m, dtype=torch.bool, device=dev)
    head[1:] = kmers[1:] != kmers[:-1]
    seg = torch.cumsum(head, 0) - 1
    nh = int(head.sum())
    rows = torch.arange(m, dtype=torch.int64, device=dev)

    def first_row(where):      # a segment's first row where ``where``
        return torch.full((nh,), _I64_MAX, dtype=torch.int64,
                          device=dev).scatter_reduce_(0, seg[where],
                                                      rows[where], "amin")
    rmin = torch.full((nh,), _I64_MAX, dtype=torch.int64, device=dev)
    rmin.scatter_reduce_(0, seg, rank, "amin")
    rmax = torch.full((nh,), -_I64_MAX - 1, dtype=torch.int64, device=dev)
    rmax.scatter_reduce_(0, seg, rank, "amax")
    p = first_row(rank == rmin[seg])
    q = first_row(rank == rmax[seg])
    both = torch.bincount(seg, minlength=nh) > 1
    dp, ip = depth[p].to(torch.int64) & _M32, info[p].to(torch.int64) & _M32
    dq = torch.where(both, depth[q].to(torch.int64) & _M32, 0)
    iq = info[q].to(torch.int64) & _M32
    d = ((dp + dq) & _M32).clamp(max=0xFFFF)
    c_sum = ((ip & 3) + (iq & 3)).clamp(max=3)
    single = torch.where(((ip >> 8) & 1) == 1, ip & 3, ip & 0xFF)
    i = torch.where(both, (ip & 3) | c_sum, single)
    h = min(nh, out_len)
    for o, v in zip(out, (kmers[p], d.to(torch.int32), i.to(torch.int32),
                          rank[p])):
        o[:h] = v[:h]
    return (*out, torch.tensor(nh, dtype=torch.int64, device=dev))


def merge_reduce(kmers, depth, info, rank, out_len):
    """The merge's reduction: launches csrc/merge.cu for CUDA tensors, runs
    merge_reduce_ref for CPU tensors.  Returns (out_k, out_d, out_i, out_r,
    n_heads) on the rows' device."""
    if kmers.device.type == "cpu":
        return merge_reduce_ref(kmers, depth, info, rank, out_len)
    if kmers.device.type != "cuda":
        raise ValueError("merge_reduce: unsupported device %s" % kmers.device)
    _check(kmers, depth, info, rank, out_len)
    dev, m = kmers.device, kmers.numel()
    nb = max(1, -(-m // ROWS_PER_BLOCK))
    bcnt = torch.empty(nb, dtype=torch.int32, device=dev)
    out_k = torch.empty(out_len, dtype=torch.int64, device=dev)
    out_d = torch.empty(out_len, dtype=torch.int32, device=dev)
    out_i = torch.empty(out_len, dtype=torch.int32, device=dev)
    out_r = torch.empty(out_len, dtype=torch.int64, device=dev)
    n_heads = torch.empty((), dtype=torch.int64, device=dev)
    L = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.mz_merge_reduce(
            kmers.data_ptr(), depth.data_ptr(), info.data_ptr(),
            rank.data_ptr(), m, out_len, nb, bcnt.data_ptr(),
            out_k.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            out_r.data_ptr(), n_heads.data_ptr(), stream)
    _build.check(rc, "merge_reduce")
    _build.LAUNCHES["merge_reduce"] += 1
    return out_k, out_d, out_i, out_r, n_heads
