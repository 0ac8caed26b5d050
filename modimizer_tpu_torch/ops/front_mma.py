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
    L = _build.lib()
    dev = pa.device
    # the [24][8] u8 weights go to the kernel by value, from host memory
    wts = ctypes.create_string_buffer(
        limb_weights(factor1).to(torch.uint8).numpy().tobytes(), 24 * 8)
    km = torch.empty(16 * NJ, dtype=torch.int32, device=dev)
    em = torch.empty(16 * NJ, dtype=torch.int8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.mz_front_mma(pa.data_ptr(), pb.data_ptr(), za.data_ptr(),
                            zb.data_ptr(), NJ, wts, w - 1, 8 * sms,
                            km.data_ptr(), em.data_ptr(), stream)
    _build.check(rc, "front_mma")
    _build.LAUNCHES["front_mma"] += 1
    return km, em
