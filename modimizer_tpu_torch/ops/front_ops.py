"""The scan front's micro-ops, one at a time: the CUDA kernel
``csrc/front_ops.cu`` and its plain PyTorch version.

Port of ``scripts/probe_front.py`` (the JAX package), whose ``mk`` runs one
body over u32 [T, 128, 1024] tiles on a (T, 16) grid that revisits each
output block for r = 0 .. 15, so the body runs 16 times per element and what
it leaves is ``body(x[t], r=15)``.  The kernel does the same for
r = 0 .. ``r`` (default 15) and keeps the last:

  copy      x
  static16  x << 14 | x >> 18               (a constant funnel rotate)
  dyn       x << 2r | x >> (32 - 2r), x at r = 0  (``dynf``; at r = 15 a
            rotate by 30)
  mul10     ten steps of x = x * 0x9E3779B9 + 1
  iota      x + 16 (col * L + row)           (``iotas``; row < L, col < R)

u32 values ride in int32 tensors as their bit patterns.
"""

import torch

from .. import _build
from .front_kernel import M32, i32_as_u32, u32_as_i32

OPS = ("copy", "static16", "dyn", "mul10", "iota")
R_LAST = 15            # the grid's last r: the one whose body is kept
THREADS = 1024         # one uint4 (4 elements) a thread


def _check(x, op, r):
    if not 0 <= r <= R_LAST:
        raise ValueError("front_ops: r=%r not in 0..%d" % (r, R_LAST))
    if op not in OPS:
        raise ValueError("front_ops: op %r not in %s" % (op, OPS))
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[2] % 4:
        raise ValueError("front_ops: x must be int32 [T, L, R] with R a "
                         "multiple of 4, got %s %s"
                         % (x.dtype, tuple(x.shape)))
    if not x.is_contiguous():
        raise ValueError("front_ops: x is not contiguous")


def front_ops_ref(x, op, r=R_LAST):
    """Plain PyTorch version of the front_ops kernel (any device): the body
    at ``r`` alone, which is what the kernel's last pass leaves."""
    _check(x, op, r)
    u = i32_as_u32(x)
    if op == "copy":
        out = u
    elif op == "static16":
        out = ((u << 14) & M32) | (u >> 18)
    elif op == "dyn":
        s = 2 * r
        out = u if r == 0 else ((u << s) & M32) | (u >> (32 - s))
    elif op == "mul10":
        out = u
        for _ in range(10):
            out = (out * 0x9E3779B9 + 1) & M32
    else:
        L, R = x.shape[1], x.shape[2]
        row = torch.arange(L, dtype=torch.int64, device=x.device)[:, None]
        col = torch.arange(R, dtype=torch.int64, device=x.device)[None, :]
        out = (u + 16 * (col * L + row)) & M32
    return u32_as_i32(out)


def front_ops(x, op, r=R_LAST):
    """One micro-op over int32 [T, L, R], its body run for r = 0 .. ``r``:
    launches csrc/front_ops.cu for a CUDA tensor, runs front_ops_ref for a
    CPU tensor."""
    if x.device.type == "cpu":
        return front_ops_ref(x, op, r)
    if x.device.type != "cuda":
        raise ValueError("front_ops: unsupported device %s" % x.device)
    _check(x, op, r)
    L = _build.lib()
    out = torch.empty_like(x)
    nblocks = max(1, -(-(x.numel() // 4) // THREADS))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = L.mz_front_ops(x.data_ptr(), x.numel(), OPS.index(op),
                            x.shape[1], x.shape[2], r, nblocks,
                            out.data_ptr(), stream)
    _build.check(rc, "front_ops")
    _build.LAUNCHES["front_ops"] += 1
    return out
