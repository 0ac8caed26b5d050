"""The k = 16 u32 scan front and its ablations: the CUDA kernels
``csrc/front_planes.cu`` (the variants that store planes) and
``csrc/front_reduce.cu`` (the read-only reductions ``noout`` and
``count``), and their plain PyTorch version.

Port of the scan-front probe kernels of the JAX package's ``scripts/``:
``probe_chain_time.py::kern_front``, ``probe_pallas_parts.py::kern_full``,
``kern_kmonly``, ``kern_emonly``, ``kern_noin``, ``kern_noout``,
``probe_pallas_front.py::plane_kernel``, ``timing_kernel`` and
``probe_front_mxu.py::kern_nohash``, ``kern_mul16``.  All of them compute
one front over four u32 streams (``make_streams``): for word j and phase
s in [0, 16), position p = 16 j + s,

    kf = pa[j] << 2s | pb[j] >> (32 - 2s)        (s = 0: pa[j])
    kr = za[j] >> 2s | zb[j] << (32 - 2s)        (s = 0: za[j])
    hf, hr = hash32_hi(kf), hash32_hi(kr)        (bits 32..63 of x * factor1)
    isF = hf < hr;  km = isF ? kf : kr;  emit = (min-by-isF hash & (w-1)) == 0

exactly as the probes compute it: k = 16 (no ``kshift``) and a power-of-two
w.  Outputs are flat in position order ([C], C = 16 NJ), not the TPU's
[16, NJ] sublane layout.  u32 values ride in int32 tensors as their bit
patterns; the plain version computes in int64 with masks, since CPU PyTorch
has no unsigned shifts or compares.

Variants (the probe kernels each stands for) and their outputs, a tuple:
  full    kern_front, kern_full, plane_kernel, kern_mul16   (km, em)
  nohash  kern_front(hashed=False), kern_nohash: emit = ((kf ^ kr) & 15)
          == 0, km = emit ? kf : kr                          (km, em)
  kmonly  kern_kmonly: emit ? km : ~km                       (km,)
  emonly  kern_emonly: emit & (km != 0)                      (em,)
  noin    kern_noin: streams made from the block's lane iota l and
          base = l + (seed + g) * 2654435761 (g = j // mj) (km, em)
  noout   kern_noout: sum of (km & 0xFFFF) + 65536 emit over s in
          {r, r + 8} and j = lane (mod 128)                   (acc int64 [8, 128],)
  count   timing_kernel: the number of emits                 (n int64 [],)

``noout`` and ``count`` are exact int64.  The TPU kernels sum in f32, which
is exact only below 2^24 (and then independent of the order of the sum): at
the test sizes (C = 2^14) the two agree exactly; at C = 2^24 the f32 sums
would have rounded.  Both take at most ``REDUCE_MAX_NJ`` = 2^31 words, the
most at which front_reduce's u32 partials cannot wrap;
``front_reduce_lanes`` runs that kernel's schedule on the CPU.
"""

import ctypes

import torch

from .. import _build
from .packed import as_i64, derive_tw, lsr

VARIANTS = ("full", "nohash", "kmonly", "emonly", "noin", "noout", "count")
OUTPUTS = {"full": ("km", "em"), "nohash": ("km", "em"), "kmonly": ("km",),
           "emonly": ("em",), "noin": ("km", "em"), "noout": ("acc",),
           "count": ("acc",)}
M32 = 0xFFFFFFFF
# kern_noin's stream constants
NOIN_SEED_MUL = 2654435761
NOIN_MULS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
THREADS = 512          # csrc/front_planes.cu: 128 words x 4 quads a block
# csrc/front_reduce.cu: one word a thread, 1024 threads a block, u32 row
# partials.  A row sum gains at most 2 x 0xFFFF a word, so a thread takes at
# most REDUCE_MAX_WORDS words; the grid has at least REDUCE_MIN_THREADS
# threads (reduce_grid), so NJ <= REDUCE_MAX_NJ = 2^31 words is safe.
REDUCE_VARIANTS = ("noout", "count")
REDUCE_THREADS = 1024
REDUCE_MAX_WORDS = 32768
REDUCE_MIN_THREADS = 65536
REDUCE_MAX_NJ = REDUCE_MAX_WORDS * REDUCE_MIN_THREADS
REDUCE_ARRIVALS = 44   # a scratch word: blocks arrived << 44 | their sum
ACC = 8 * 128          # the noout sums, and the scratch's u64 words
_SCRATCH = {}          # (device index, stream) -> front_reduce's scratch
_BLOCKS_PER_SM = {}    # (device index, variant) -> the occupancy


def u32_as_i32(x):
    """int64 holding u32 values -> int32 with the same bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def i32_as_u32(x):
    """int32 bit patterns -> their u32 values in int64."""
    return x.to(torch.int64) & M32


def make_streams(sw, NJ: int):
    """(pa, pb, za, zb) int32 [NJ] carrying u32 bits from the int64 packed
    stream ``sw`` (>= NJ/2 + 1 words): P = the (hi, lo) halves of each sw
    word in turn, Z = the (lo, hi) halves of tw = ~grev64(sw); pa = P[:NJ],
    pb = P[1:NJ+1], za = Z[:NJ], zb = Z[1:NJ+1] (``make_streams`` of
    ``scripts/probe_pallas_parts.py``)."""
    if NJ <= 0 or NJ % 2:
        raise ValueError("make_streams: NJ=%d is not a positive even number"
                         % NJ)
    if sw.dtype != torch.int64 or sw.dim() != 1 or sw.numel() < NJ // 2 + 1:
        raise ValueError("make_streams: sw must be int64 [>= %d], got %s %s"
                         % (NJ // 2 + 1, sw.dtype, tuple(sw.shape)))
    tw = derive_tw(sw)
    P = torch.stack([lsr(sw, 32), sw & M32], dim=1).reshape(-1)
    Z = torch.stack([tw & M32, lsr(tw, 32)], dim=1).reshape(-1)
    return tuple(u32_as_i32(x).contiguous()
                 for x in (P[:NJ], P[1:NJ + 1], Z[:NJ], Z[1:NJ + 1]))


def _check(pa, pb, za, zb, *, factor1, w, variant, k, mj, seed):
    if k != 16:
        raise ValueError("front_planes: k=%d; the probes' front is k = 16"
                         % k)
    if not (1 <= w <= 1 << 32 and w & (w - 1) == 0):
        raise ValueError("front_planes: w=%d is not a power of two in "
                         "[1, 2^32]" % w)
    if not 0 <= factor1 < 1 << 64:
        raise ValueError("front_planes: factor1 is not a u64")
    if variant not in VARIANTS:
        raise ValueError("front_planes: variant %r not in %s"
                         % (variant, VARIANTS))
    if not 0 <= seed < 1 << 31:
        raise ValueError("front_planes: seed=%d outside [0, 2^31)" % seed)
    NJ = pa.shape[0] if pa.dim() == 1 else -1
    for name, t in (("pa", pa), ("pb", pb), ("za", za), ("zb", zb)):
        if t.dtype != torch.int32 or t.shape != (NJ,):
            raise ValueError("front_planes: %s must be int32 [NJ], got %s %s"
                             % (name, t.dtype, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("front_planes: %s is not contiguous" % name)
        if t.device != pa.device:
            raise ValueError("front_planes: streams on different devices")
    if mj <= 0 or mj % 128 or NJ % mj:
        raise ValueError("front_planes: mj=%d must be a positive multiple "
                         "of 128 dividing NJ=%d" % (mj, NJ))
    if variant in REDUCE_VARIANTS and NJ > REDUCE_MAX_NJ:
        raise ValueError("front_planes: %s takes NJ <= %d words, got %d "
                         "(above it front_reduce's u32 partials could wrap)"
                         % (variant, REDUCE_MAX_NJ, NJ))
    return NJ


def noin_streams(NJ: int, mj: int, seed: int, device):
    """kern_noin's streams, as int64 u32 values [NJ]: word j of grid block
    g = j // mj at lane l = j % mj has base = l + (seed + g) * 2654435761."""
    j = torch.arange(NJ, dtype=torch.int64, device=device)
    g = j // mj
    base = ((j - g * mj) + ((seed + g) & M32) * NOIN_SEED_MUL) & M32
    return tuple((base * m) & M32 for m in NOIN_MULS)


def hash32_hi(a, factor1: int):
    """Bits 32..63 of (a * factor1) mod 2^64 for u32 a in int64: the k <= 16
    hash window (``parallel/sharded.py::_hash32_hi``)."""
    return lsr(a * as_i64(factor1), 32)


def funnel16(pa, pb, za, zb):
    """(kf, kr) int64 [NJ, 16] from int64 u32 streams [NJ]: element [j, s]
    is position 16 j + s.  In int64 the s = 0 lane needs no case: a u32
    shifted right by 32 is 0."""
    s2 = 2 * torch.arange(16, dtype=torch.int64, device=pa.device)
    kf = ((pa[:, None] << s2) & M32) | (pb[:, None] >> (32 - s2))
    kr = (za[:, None] >> s2) | ((zb[:, None] << (32 - s2)) & M32)
    return kf, kr


def select_emit(hf, hr, kf, kr, w: int):
    """(km, emit): the canonical k-mer by the smaller hash (ties take kr)
    and the power-of-two emit test on that hash."""
    isF = hf < hr
    h = torch.where(isF, hf, hr)
    return torch.where(isF, kf, kr), (h & (w - 1)) == 0


def planes(km, emit):
    """(km int32 [C], em int8 [C]) in position order."""
    return u32_as_i32(km.reshape(-1)), emit.reshape(-1).to(torch.int8)


def front_planes_ref(pa, pb, za, zb, *, factor1, w, variant, k=16, mj=4096,
                     seed=0):
    """Plain PyTorch version of the front_planes kernel (any device)."""
    NJ = _check(pa, pb, za, zb, factor1=factor1, w=w, variant=variant, k=k,
                mj=mj, seed=seed)
    if variant == "noin":
        streams = noin_streams(NJ, mj, seed, pa.device)
    else:
        streams = tuple(i32_as_u32(t) for t in (pa, pb, za, zb))
    kf, kr = funnel16(*streams)
    if variant == "nohash":
        emit = ((kf ^ kr) & 15) == 0
        return planes(torch.where(emit, kf, kr), emit)
    km, emit = select_emit(hash32_hi(kf, factor1), hash32_hi(kr, factor1),
                           kf, kr, w)
    if variant in ("full", "noin"):
        return planes(km, emit)
    if variant == "kmonly":
        return (u32_as_i32(torch.where(emit, km, km ^ M32).reshape(-1)),)
    if variant == "emonly":
        return ((emit & (km != 0)).reshape(-1).to(torch.int8),)
    if variant == "count":
        return (emit.sum(dtype=torch.int64),)
    v = (km & 0xFFFF) + (emit.to(torch.int64) << 16)           # [NJ, 16]
    part = v.view(NJ // 128, 128, 16).sum(dim=0).T             # [16, 128]
    return ((part[:8] + part[8:]).contiguous(),)


def reduce_grid(NJ: int, blocks_per_sm: int, sms: int,
                T: int = REDUCE_THREADS) -> int:
    """front_reduce's blocks: the blocks that the SMs hold at once, at least
    REDUCE_MIN_THREADS threads (the u32 headroom), and no more blocks than
    the words fill."""
    G = max(blocks_per_sm * sms, REDUCE_MIN_THREADS // T)
    return max(1, min(G, -(-NJ // T)))


def front_reduce_map(NJ: int, G: int, T: int):
    """front_reduce's map, int64 [G, T, I]: the word that thread t of block
    b takes in iteration i, j = b T + t + i G T, or -1 past NJ."""
    iters = max(1, -(-NJ // (G * T)))
    j = (torch.arange(G)[:, None, None] * T + torch.arange(T)[None, :, None]
         + torch.arange(iters)[None, None, :] * (G * T))
    return torch.where(j < NJ, j, -1)


def front_reduce_row(s):
    """The row of phase s in front_reduce's partials: s and s + 8 share
    one."""
    return s & 7


def front_reduce_lanes(pa, pb, za, zb, *, factor1, w, variant, G, T):
    """noout or count by front_reduce's schedule on the CPU: words to
    (block, thread, iteration) by ``front_reduce_map``, each thread's u32
    row sums of km & 0xFFFF and row counts of misses (positions that do not
    emit; rows by ``front_reduce_row``), per lane t mod 128; a row's emits
    are twice the thread's words less its misses; noout's block fold of
    sum + (emits << 16) to [8, 128] u64, count's u32 warp sums added per
    block; then the blocks' total, which the scratch word holds below its
    arrivals' bits.  Equals front_planes_ref."""
    NJ = _check(pa, pb, za, zb, factor1=factor1, w=w, variant=variant,
                k=16, mj=128, seed=0)
    if variant not in REDUCE_VARIANTS:
        raise ValueError("front_reduce_lanes: variant %r not in %s"
                         % (variant, REDUCE_VARIANTS))
    if G < 1 or T < 128 or T % 128:
        raise ValueError("front_reduce_lanes: G=%d, T=%d" % (G, T))
    if -(-NJ // (G * T)) > REDUCE_MAX_WORDS:
        raise ValueError("front_reduce_lanes: %d words a thread, above %d"
                         % (-(-NJ // (G * T)), REDUCE_MAX_WORDS))
    kf, kr = funnel16(*(i32_as_u32(t) for t in (pa, pb, za, zb)))
    km, emit = select_emit(hash32_hi(kf, factor1), hash32_hi(kr, factor1),
                           kf, kr, w)
    jmap = front_reduce_map(NJ, G, T)
    took = (jmap >= 0)[..., None]                          # [G, T, I, 1]
    jj = jmap.clamp(min=0)
    miss = (~emit[jj] & took).to(torch.int64)              # [G, T, I, 16]
    nw = took[..., 0].sum(dim=2)                           # words [G, T]
    rows = front_reduce_row(torch.arange(16))

    def per_row(x):         # [G, T, I, 16] -> the thread's u32 rows [G, T, 8]
        out = torch.zeros(G, T, 8, dtype=torch.int64)
        return out.index_add_(2, rows, x.sum(dim=2)) & M32

    miss = per_row(miss)
    if variant == "count":
        n = (16 * nw - miss.sum(dim=2)) & M32
        total = (n.view(G, T // 32, 32).sum(dim=2) & M32).sum()
    else:
        emits = 2 * nw[..., None] - miss
        v = per_row((km & 0xFFFF)[jj] * took) + (emits << 16)  # u64 [G, T, 8]
        block = v.view(G, T // 128, 128, 8).sum(dim=1)       # [G, 128, 8]
        total = block.sum(dim=0).T.contiguous()
    if int(total.max()) >> REDUCE_ARRIVALS:
        raise ValueError("front_reduce_lanes: a total reaches the scratch "
                         "word's arrivals")
    return (total,)


def _front_reduce(pa, pb, za, zb, NJ, *, factor1, w, variant):
    """Launch csrc/front_reduce.cu on CUDA tensors: one kernel, no memset;
    the scratch it finds and leaves zero is this (device, stream)'s."""
    L = _build.lib()
    dev = pa.device
    with torch.cuda.device(dev):
        key = (dev.index, variant)
        if key not in _BLOCKS_PER_SM:
            n = ctypes.c_int(0)
            _build.check(L.mz_front_reduce_blocks_per_sm(
                VARIANTS.index(variant), ctypes.byref(n)), "front_reduce")
            if n.value < 1:
                raise RuntimeError("front_reduce: no block fits on an SM")
            _BLOCKS_PER_SM[key] = n.value
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        G = reduce_grid(NJ, _BLOCKS_PER_SM[key], sms)
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _SCRATCH.get((dev.index, stream))
        if scratch is None:     # 1,024 words: arrivals << 44 | sum
            scratch = torch.zeros(ACC, dtype=torch.int64, device=dev)
            _SCRATCH[(dev.index, stream)] = scratch
        out = torch.empty((8, 128) if variant == "noout" else (),
                          dtype=torch.int64, device=dev)
        rc = L.mz_front_reduce(
            pa.data_ptr(), pb.data_ptr(), za.data_ptr(), zb.data_ptr(), NJ,
            VARIANTS.index(variant), ctypes.c_uint64(factor1),
            ctypes.c_uint32(w - 1), G, scratch.data_ptr(), out.data_ptr(),
            stream)
    _build.check(rc, "front_reduce")
    _build.LAUNCHES["front_reduce"] += 1
    return (out,)


def front_planes(pa, pb, za, zb, *, factor1, w, variant, k=16, mj=4096,
                 seed=0):
    """The front over four int32 streams [NJ]: launches
    csrc/front_reduce.cu (noout, count) or csrc/front_planes.cu (the other
    variants) for CUDA tensors, runs front_planes_ref for CPU tensors.
    Returns the variant's tuple of outputs on pa's device."""
    if pa.device.type == "cpu":
        return front_planes_ref(pa, pb, za, zb, factor1=factor1, w=w,
                                variant=variant, k=k, mj=mj, seed=seed)
    NJ = _check(pa, pb, za, zb, factor1=factor1, w=w, variant=variant, k=k,
                mj=mj, seed=seed)
    if pa.device.type != "cuda":
        raise ValueError("front_planes: unsupported device %s" % pa.device)
    if variant in REDUCE_VARIANTS:
        return _front_reduce(pa, pb, za, zb, NJ, factor1=factor1, w=w,
                             variant=variant)
    L = _build.lib()
    dev = pa.device
    C = 16 * NJ
    nq = C // 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblocks = min((nq + THREADS - 1) // THREADS, 4 * sms)
    shapes = {"km": ((C,), torch.int32), "em": ((C,), torch.int8)}
    out = {n: torch.empty(shapes[n][0], dtype=shapes[n][1], device=dev)
           for n in OUTPUTS[variant]}

    def ptr(n):             # NULL for the outputs a variant does not write
        return out[n].data_ptr() if n in out else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.mz_front_planes(
            pa.data_ptr(), pb.data_ptr(), za.data_ptr(), zb.data_ptr(), NJ,
            VARIANTS.index(variant), ctypes.c_uint64(factor1),
            ctypes.c_uint32(w - 1), mj, seed, nblocks, ptr("km"), ptr("em"),
            stream)
    _build.check(rc, "front_planes")
    _build.LAUNCHES["front_planes"] += 1
    return tuple(out[n] for n in OUTPUTS[variant])
