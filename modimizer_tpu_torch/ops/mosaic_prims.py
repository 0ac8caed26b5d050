"""The compaction primitives of ``scripts/probe_mosaic_prims.py``: the CUDA
kernels of ``csrc/mosaic_prims.cu`` and their plain PyTorch versions.

  tala16     out[r, j] = x[idx[r, j] & 15, j] for r < 8 (the per-lane row
             gather of ``probe_tala16``); x, idx int32 [16, NJ] -> [8, NJ]
  dot16      one-hot compaction of 1024-position blocks (``probe_dot16``):
             out[b, s, c] = sum_p [rank[b, p] == s] cols[b, p, c], s < 112;
             rank int32 [nb, 1024], cols int8 [nb, 1024, 8] -> int32
             [nb, 112, 8] (ranks outside 0..111 land nowhere)
  roll12     12 stages acc += roll(acc, 2^s) along each 4096-wide block of a
             row (``probe_roll``, ``jnp.roll``'s direction), u32 wraparound;
             int32 [R, NJ] -> the same
  cumsum128  inclusive prefix sum of each row of 128 (``probe_cumsum128``'s
             ``e @ UT128``); int8 [R, 128] -> int32 [R, 128]

u32 values ride in int32 tensors as their bit patterns, and the plain
versions do u32 arithmetic in int64 masked to 32 bits.  Each plain version
runs on any device (PyTorch has no integer matmul on CUDA, so the products
are an ``index_add_`` and a ``cumsum``).
"""

import torch

from .. import _build
from .front_kernel import M32, i32_as_u32, u32_as_i32

TALA_ROWS, TALA_OUT, TALA_TJ = 16, 8, 128
DOT_BLK, DOT_BO, DOT_NC = 1024, 112, 8
ROLL_W, ROLL_STAGES = 4096, 12
CS_W, CS_ROWS = 128, 16


def _check(name, t, dtype, shape_ok, what):
    if t.dtype != dtype or not shape_ok(t.shape):
        raise ValueError("%s: %s must be %s, got %s %s"
                         % (name, what[0], what[1], t.dtype, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s: %s is not contiguous" % (name, what[0]))


def _check_tala16(x, idx):
    def ok(s):
        return (len(s) == 2 and s[0] == TALA_ROWS and s[1] > 0
                and s[1] % TALA_TJ == 0)
    for nm, t in (("x", x), ("idx", idx)):
        _check("tala16", t, torch.int32, ok,
               (nm, "int32 [16, NJ] with NJ a positive multiple of 128"))
    if x.shape != idx.shape or x.device != idx.device:
        raise ValueError("tala16: x and idx differ in shape or device")


def _check_dot16(rank, cols):
    _check("dot16", rank, torch.int32,
           lambda s: len(s) == 2 and s[0] > 0 and s[1] == DOT_BLK,
           ("rank", "int32 [nb, 1024]"))
    _check("dot16", cols, torch.int8,
           lambda s: tuple(s) == (rank.shape[0], DOT_BLK, DOT_NC),
           ("cols", "int8 [nb, 1024, 8] with rank's nb"))
    if rank.device != cols.device:
        raise ValueError("dot16: rank and cols on different devices")


def _check_roll12(x):
    _check("roll12", x, torch.int32,
           lambda s: (len(s) == 2 and s[0] > 0 and s[1] > 0
                      and s[1] % ROLL_W == 0),
           ("x", "int32 [R, NJ] with NJ a positive multiple of 4096"))


def _check_cumsum128(e):
    _check("cumsum128", e, torch.int8,
           lambda s: (len(s) == 2 and s[1] == CS_W and s[0] > 0
                      and s[0] % CS_ROWS == 0),
           ("e", "int8 [R, 128] with R a positive multiple of 16"))


def tala16_ref(x, idx):
    _check_tala16(x, idx)
    return torch.gather(x, 0, (idx[:TALA_OUT] & 15).to(torch.int64))


def dot16_ref(rank, cols):
    _check_dot16(rank, cols)
    nb = rank.shape[0]
    keep = (rank >= 0) & (rank < DOT_BO)
    blk = torch.arange(nb, dtype=torch.int64, device=rank.device)[:, None]
    dest = (blk * DOT_BO + rank.to(torch.int64))[keep]
    out = torch.zeros(nb * DOT_BO, DOT_NC, dtype=torch.int32,
                      device=rank.device)
    out.index_add_(0, dest, cols[keep].to(torch.int32))
    return out.view(nb, DOT_BO, DOT_NC)


def roll12_ref(x):
    _check_roll12(x)
    R, NJ = x.shape
    acc = i32_as_u32(x).view(R, NJ // ROLL_W, ROLL_W)
    for s in range(ROLL_STAGES):
        acc = (acc + torch.roll(acc, 1 << s, dims=2)) & M32
    return u32_as_i32(acc.reshape(R, NJ))


def cumsum128_ref(e):
    _check_cumsum128(e)
    return torch.cumsum(e, dim=1, dtype=torch.int32)


def _launch(name, out, *args):
    """Call mz_<name>(*args, out, stream) on out's device; count it."""
    L = _build.lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = getattr(L, "mz_" + name)(*args, out.data_ptr(), stream)
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return out


def _device(name, t):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (name, t.device))
    return t.device.type == "cuda"


def tala16(x, idx):
    """Per-lane gather of 8 of 16 rows: launches the kernel for CUDA
    tensors, runs tala16_ref for CPU tensors."""
    if not _device("tala16", x):
        return tala16_ref(x, idx)
    _check_tala16(x, idx)
    out = torch.empty((TALA_OUT, x.shape[1]), dtype=torch.int32,
                      device=x.device)
    return _launch("tala16", out, x.data_ptr(), idx.data_ptr(), x.shape[1])


def dot16(rank, cols):
    """One-hot compaction by s8 tensor-core products: launches the kernel
    for CUDA tensors, runs dot16_ref for CPU tensors."""
    if not _device("dot16", rank):
        return dot16_ref(rank, cols)
    _check_dot16(rank, cols)
    nb = rank.shape[0]
    out = torch.empty((nb, DOT_BO, DOT_NC), dtype=torch.int32,
                      device=rank.device)
    return _launch("dot16", out, rank.data_ptr(), cols.data_ptr(), nb)


def roll12(x):
    """12 roll-and-add stages in 4096-wide blocks: launches the kernel for
    a CUDA tensor, runs roll12_ref for a CPU tensor."""
    if not _device("roll12", x):
        return roll12_ref(x)
    _check_roll12(x)
    out = torch.empty_like(x)
    return _launch("roll12", out, x.data_ptr(), x.shape[0], x.shape[1])


def cumsum128(e):
    """Row prefix sums over 128 columns by s8 tensor-core products against
    the upper triangle: launches the kernel for a CUDA tensor, runs
    cumsum128_ref for a CPU tensor."""
    if not _device("cumsum128", e):
        return cumsum128_ref(e)
    _check_cumsum128(e)
    out = torch.empty(e.shape, dtype=torch.int32, device=e.device)
    return _launch("cumsum128", out, e.data_ptr(), e.shape[0])
