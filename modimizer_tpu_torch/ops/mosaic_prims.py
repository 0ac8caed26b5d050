"""The compaction primitives of ``scripts/probe_mosaic_prims.py``: the CUDA
kernels of ``csrc/mosaic_prims.cu`` and their plain PyTorch versions.

  tala16     out[r, j] = x[idx[r, j] & 15, j] for r < 8 (the per-lane row
             gather of ``probe_tala16``); x, idx int32 [16, NJ] -> [8, NJ]
  dot16      compaction of 1024-position blocks (``probe_dot16``'s one-hot
             product; a segment sum in shared memory on the card):
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

``roll12_lanes`` and ``dot16_lanes`` / ``dot16_words`` / ``dot16_store_map``
write the two kernels' maps out as plain functions, for the CPU tests to
rehearse: nothing on a path calls them.
"""

import torch

from .. import _build
from .front_kernel import M32, i32_as_u32, u32_as_i32

TALA_ROWS, TALA_OUT, TALA_TJ = 16, 8, 128
DOT_BLK, DOT_BO, DOT_NC = 1024, 112, 8
ROLL_W, ROLL_STAGES = 4096, 12
ROLL_REGS = ROLL_W // 32          # elements a lane holds in roll12
ROLL_LANE_STAGES = 5              # stages 2^s < 32: shuffles
DOT_THREADS = 256                 # dot16: 8 warps of 128 positions
DOT_PER = DOT_BLK // DOT_THREADS  # positions a lane
DOT_STRIDE = DOT_BO + 4           # words a row of dot16's [c][s] table
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


def shuffle_stage(a, d):
    """One roll12 stage with 2^s = d < 32 as the kernel runs it on a
    [row-blocks, 32 lanes, 128 registers] u32 (int64) tensor: register i
    is shuffled once from lane src = (l - d) & 31 (sh_i), and lane l adds
    sh_i if l >= d, else sh_{i-1}; sh_{-1} is the shuffled old a[127],
    saved before the walk from i = 127 down to 0."""
    a = a.clone()
    lanes = torch.arange(32, device=a.device)
    src, own = (lanes - d) & 31, (lanes >= d)[None, :]
    wrap = a[:, src, ROLL_REGS - 1]
    hi = wrap
    for i in range(ROLL_REGS - 1, -1, -1):
        lo = a[:, src, i - 1] if i else wrap
        a[:, :, i] = (a[:, :, i] + torch.where(own, hi, lo)) & M32
        hi = lo
    return a


def register_stage(a, D):
    """One roll12 stage with 2^s = 32 D as the kernel runs it, within each
    lane: a[i] += a[(i - D) mod 128], each of the D cycles r, r + D, ...
    walked downward after its top's old value is saved."""
    a = a.clone()
    for r in range(D):
        top = a[:, :, r + ROLL_REGS - D].clone()
        for i in range(r + ROLL_REGS - D, r + D - 1, -D):
            a[:, :, i] = (a[:, :, i] + a[:, :, i - D]) & M32
        a[:, :, r] = (a[:, :, r] + top) & M32
    return a


def roll12_lanes(x):
    """roll12 by the kernel's schedule: lane l of a block row's warp holds
    elements l + 32 i in register i; five shuffle stages, then seven
    register stages.  Equals roll12_ref."""
    _check_roll12(x)
    R, NJ = x.shape
    a = i32_as_u32(x).view(-1, ROLL_REGS, 32).transpose(1, 2)
    for s in range(ROLL_LANE_STAGES):
        a = shuffle_stage(a, 1 << s)
    for s in range(ROLL_LANE_STAGES, ROLL_STAGES):
        a = register_stage(a, (1 << s) // 32)
    return u32_as_i32(a.transpose(1, 2).reshape(R, NJ))


def dot16_lanes():
    """dot16's map of a block's positions: [8 warps, 4, 32 lanes], the
    position lane l of warp w holds in its i-th register, 128 w + l +
    32 i."""
    w, i, l = torch.meshgrid(torch.arange(DOT_THREADS // 32),
                             torch.arange(DOT_PER), torch.arange(32),
                             indexing="ij")
    return 128 * w + l + 32 * i


def dot16_words(rank):
    """The table word each of dot16's atomics adds into: [nb, 8 warps, 4,
    8 c, 32 lanes] = c * DOT_STRIDE + the rank at lane l's i-th position,
    -1 where that rank is outside 0..111 (no atomic).  One (b, w, i, c) is
    one warp instruction."""
    r = rank[:, dot16_lanes()].to(torch.int64)[:, :, :, None, :]
    c = torch.arange(DOT_NC)[:, None]
    return torch.where((r >= 0) & (r < DOT_BO), c * DOT_STRIDE + r, -1)


def dot16_store_map():
    """dot16's store: [224 threads, 4] (the words of out[b], the table
    words they are read from); thread t stores out words 4t..4t+3, those
    of slot s = t // 2 and columns c = 4 (t % 2) + k, k < 4."""
    t = torch.arange(DOT_BO * DOT_NC // 4)[:, None]
    k = torch.arange(4)[None, :]
    s, c = t // 2, 4 * (t % 2) + k
    return 4 * t + k, c * DOT_STRIDE + s


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
    """Compaction as a segment sum into a shared-memory table: launches
    the kernel for CUDA tensors, runs dot16_ref for CPU tensors."""
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
