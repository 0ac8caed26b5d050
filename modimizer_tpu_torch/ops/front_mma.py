"""The k = 16 front with both strands' hashes from one tensor-core product
of byte limbs: the CUDA kernel ``csrc/front_mma.cu`` and its plain PyTorch
version.

Port of ``scripts/probe_front_mxu.py::kern_mxu``.  ``hash32_hi(a)`` = hi32(a
Fl) + lo32(a Fh) is linear in the four byte limbs of a: with bl, bh the
bytes of Fl and Fh, the partial sums

    p[s] = sum_i a_i bl[s - i]   (s < 7)   and   p[7 + s] = sum_i a_i bh[s - i]
    (s < 4), over 0 <= s - i < 4,

are one product of the [24, 8] limb weights (``limb_weights``, the port of
``make_W``: rows 0-10 strand f, 11-21 strand r, 22-23 zero; columns the 4
kf limbs then the 4 kr limbs) with the 8 limbs of a position, and a u32
carry chain (``carries``) rebuilds each hash.  Each product is at most 255^2
and a partial at most 4 x 255^2, so an integer product is exact.  The
outputs are the planes of ``front_planes(variant="full")``: (km int32 [C],
em int8 [C]) in position order.

The kernel's fragment map (``csrc/front_mma.cu``'s header) is written here
as plain functions the CPU tests rehearse it with: ``tile_weights`` (B, the
[16, 48] u8 matrix of its 6 ``m16n8k16`` tiles, each run once a strand),
``b_fragments`` (each lane's B registers as the kernel builds them) and
``d_slot`` (the accumulator register that holds a partial).
"""

import ctypes

import torch

from .. import _build
from .front_kernel import (_check, funnel16, i32_as_u32, planes,
                           select_emit)

M32 = 0xFFFFFFFF


def limb_weights(factor1: int):
    """int32 [24, 8]: the limb weights of ``make_W`` (which returns the same
    values as f32)."""
    bl = [(factor1 >> (8 * j)) & 0xFF for j in range(4)]
    bh = [(factor1 >> (32 + 8 * j)) & 0xFF for j in range(4)]
    W1 = torch.zeros((11, 4), dtype=torch.int32)
    for s in range(11):
        b, t = (bl, s) if s < 7 else (bh, s - 7)
        for i in range(4):
            if 0 <= t - i < 4:
                W1[s, i] = b[t - i]
    W = torch.zeros((24, 8), dtype=torch.int32)
    W[:11, :4] = W1
    W[11:22, 4:] = W1
    return W


TILES = 6               # m16n8k16 tiles of B; each runs once a strand
BLOCKS_PER_SM = 4       # the kernel's launch bound (4 warps a block)


def tile_weights(factor1: int):
    """uint8 [16, 48]: B of the kernel's 6 tiles side by side.  Tile i,
    column c: partial p = 2 i + c % 2 of word c // 2; the column holds
    W1[p] (the [11, 4] block of ``limb_weights``) at rows 4 (c // 2) ..
    + 3, zero elsewhere and for p = 11.  A strand's A (its k-mers' limbs,
    rows the 16 phases, columns 4 words x 4 limbs) times B gives its
    partials."""
    W1 = limb_weights(factor1)[:11, :4]
    B = torch.zeros((16, 8 * TILES), dtype=torch.uint8)
    for i in range(TILES):
        for c in range(8):
            p, word = 2 * i + c % 2, c // 2
            if p < 11:
                B[4 * word:4 * word + 4, 8 * i + c] = W1[p].to(torch.uint8)
    return B


def b_fragments(factor1: int):
    """int64 [32, 6] u32 values: lane (g, t)'s B register of tile i, as the
    kernel builds it from the packed [24, 8] weights: word 2 p (bytes 0-3
    of row p) where t == g // 2 and p = 2 i + g % 2 < 11, else 0."""
    rows = limb_weights(factor1).to(torch.int64)
    words = (rows[:, 0] | rows[:, 1] << 8 | rows[:, 2] << 16
             | rows[:, 3] << 24)          # W.w[2 p] for p < 24
    out = torch.zeros((32, TILES), dtype=torch.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i in range(TILES):
            p = 2 * i + g % 2
            if t == g // 2 and p < 11:
                out[lane, i] = words[p]
    return out


def d_slot(p: int, half: int):
    """(tile, accumulator register) that holds a strand's partial p at
    phase g (half 0) or g + 8 (half 1) in lane (g, t): D rows g (registers
    0, 1) and g + 8 (2, 3), columns 2t, 2t + 1."""
    return p // 2, 2 * half + p % 2


def carries(p):
    """hash32_hi from the 11 partials of one strand (``carries`` of the
    probe); every intermediate fits u32 except the sums into hi and lo,
    where u32 wraps, so int64 and a final mask give the same bits."""
    c01 = p[0] + (p[1] << 8)
    c23 = p[2] + (p[3] << 8)
    mid = (c01 >> 16) + c23
    hi = (mid >> 16) + p[4] + (p[5] << 8) + (p[6] << 16)
    lo = p[7] + (p[8] << 8) + (p[9] << 16) + (p[10] << 24)
    return (hi + lo) & M32


def front_mma_ref(pa, pb, za, zb, *, factor1, w, k=16):
    """Plain PyTorch version of the front_mma kernel (any device): the limb
    product in int64, then the carry chain."""
    _check(pa, pb, za, zb, factor1=factor1, w=w, variant="full", k=k,
           mj=128, seed=0)
    kf, kr = funnel16(*(i32_as_u32(t) for t in (pa, pb, za, zb)))
    W = limb_weights(factor1).to(device=pa.device, dtype=torch.int64)
    P = torch.zeros(kf.shape + (24,), dtype=torch.int64, device=pa.device)
    for i in range(8):
        limb = ((kf if i < 4 else kr) >> (8 * (i % 4))) & 0xFF
        P += limb[..., None] * W[:, i]
    hf = carries([P[..., s] for s in range(11)])
    hr = carries([P[..., 11 + s] for s in range(11)])
    return planes(*select_emit(hf, hr, kf, kr, w))


def launch(L, pa, pb, za, zb, NJ, *, factor1, w, nblocks):
    """(km, em) from ``L.mz_front_mma`` on the current stream: the current
    kernel (``_build.lib()``) or an earlier source's library.  Raises on a
    launch error."""
    dev = pa.device
    # the [24][8] u8 weights go to the kernel by value, from host memory
    wts = ctypes.create_string_buffer(
        limb_weights(factor1).to(torch.uint8).numpy().tobytes(), 24 * 8)
    km = torch.empty(16 * NJ, dtype=torch.int32, device=dev)
    em = torch.empty(16 * NJ, dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.mz_front_mma(pa.data_ptr(), pb.data_ptr(), za.data_ptr(),
                            zb.data_ptr(), NJ, wts, w - 1, nblocks,
                            km.data_ptr(), em.data_ptr(), stream)
    _build.check(rc, "front_mma")
    return km, em


def front_mma(pa, pb, za, zb, *, factor1, w, k=16):
    """The limb-product front: launches csrc/front_mma.cu for CUDA tensors,
    runs front_mma_ref for CPU tensors.  Returns (km, em) on pa's
    device."""
    if pa.device.type == "cpu":
        return front_mma_ref(pa, pb, za, zb, factor1=factor1, w=w, k=k)
    if pa.device.type != "cuda":
        raise ValueError("front_mma: unsupported device %s" % pa.device)
    NJ = _check(pa, pb, za, zb, factor1=factor1, w=w, variant="full", k=k,
                mj=128, seed=0)
    sms = torch.cuda.get_device_properties(pa.device).multi_processor_count
    out = launch(_build.lib(), pa, pb, za, zb, NJ, factor1=factor1, w=w,
                 nblocks=BLOCKS_PER_SM * sms)
    _build.LAUNCHES["front_mma"] += 1
    return out
