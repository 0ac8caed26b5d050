// The k = 16 u32 scan front and its ablations that store planes (sm_90a).
//
// Replaces the scan-front probe kernels of the JAX package's scripts/:
//   probe_chain_time.py::kern_front (hashed and not), probe_pallas_parts.py::
//   kern_full / kern_kmonly / kern_emonly / kern_noin,
//   probe_pallas_front.py::plane_kernel and
//   probe_front_mxu.py::kern_nohash / kern_mul16.  The two read-only
//   reductions, kern_noout and timing_kernel (variants noout and count), are
//   csrc/front_reduce.cu; mz_front_planes refuses them.
// Contract: modimizer_tpu_torch/ops/front_kernel.py::front_planes_ref.  For
// word j and phase s in [0, 16), position p = 16 j + s:
//   kf = pa[j] << 2s | pb[j] >> (32 - 2s)   = __funnelshift_l(pb, pa, 2s)
//   kr = za[j] >> 2s | zb[j] << (32 - 2s)   = __funnelshift_r(za, zb, 2s)
//   hash32_hi(a) = bits 32..63 of a * factor1 = __umulhi(a, Fl) + a * Fh
//   isF = hf < hr, km = isF ? kf : kr, emit = ((isF ? hf : hr) & wmask) == 0
// Outputs are flat in position order: km u32 [16 NJ], em i8 [16 NJ].
//
// Design of full, nohash, kmonly and noin (front_planes_kernel).  The TPU
// kernels put the 16 phases on sublanes and split each 32x32 multiply-high
// into 16-bit limbs (the VPU has no 32x32->64 multiply).  Here one thread
// computes one quad (4 consecutive phases of one word): one IMAD.HI and one
// IMAD per hash, a funnel shift per strand, and one 16-byte store of km and
// one 4-byte store of em, so a warp stores 512 and 128 contiguous bytes.  A
// block is 512 threads = 128 words x 4 quads, and the grid strides by whole
// blocks.  What bounds them: memory.  `full`, `nohash` and `noin` write 5 B
// a position and `kmonly` 4; all but `noin` read 1 B (four u32 streams per
// 16 positions, each word's load shared by its 4 threads through L1).
// Their ~10 integer instructions a position take less than those bytes'
// time.
//
// Design of emonly (front_emit_kernel), which moves only 2 B a position: 1
// read (the four streams) and 1 written (em), so the quad map, whose warp
// loads 8 distinct words of a stream and stores 128 B, leaves too few bytes
// in flight.  One thread takes whole words, j = b T + t + i G T on a
// persistent grid of G blocks (the blocks an SM holds, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, times the SMs:
// front_kernel.emit_grid); it loads EMIT_U words of all four streams before
// its first hash (a warp's load of one stream is 128 contiguous bytes),
// computes the 16 phases in registers and stores them as one uint4 at
// em + 16 j, byte s of the 16 for phase s (a warp stores 512 contiguous
// bytes).  A position emits into em when its k-mer is not 0: two compares
// to a predicate and a predicated OR of its byte (set_emit).  The four
// streams are read as given: pb[j] is not taken for pa[j + 1], nor zb[j]
// for za[j + 1], though make_streams builds them so.  The CPU tests run this
// map word by word (front_kernel.front_emit_lanes).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// front_kernel.VARIANTS; noout and count are csrc/front_reduce.cu's
enum Variant { V_FULL, V_NOHASH, V_KMONLY, V_EMONLY, V_NOIN };

constexpr int THREADS = 512;     // 128 words x 4 quads
constexpr int EMIT_THREADS = 256;
constexpr int EMIT_U = 2;        // words a thread loads before a hash

__device__ __forceinline__ uint32_t hash32_hi(uint32_t a, uint32_t fl,
                                              uint32_t fh) {
    return __umulhi(a, fl) + a * fh;
}

template <int V>
__global__ void __launch_bounds__(THREADS)
front_planes_kernel(const uint32_t* __restrict__ pa,
                    const uint32_t* __restrict__ pb,
                    const uint32_t* __restrict__ za,
                    const uint32_t* __restrict__ zb,
                    int64_t nq, uint32_t fl, uint32_t fh, uint32_t wmask,
                    int64_t mj, uint32_t seed,
                    uint4* __restrict__ km, uint32_t* __restrict__ em) {
    const int tid = threadIdx.x;
    const int q = tid & 3;                      // quad: phases 4q .. 4q+3
    const int64_t stride = (int64_t)gridDim.x * THREADS;

    for (int64_t qi = (int64_t)blockIdx.x * THREADS + tid; qi < nq;
         qi += stride) {
        const int64_t j = qi >> 2;
        uint32_t a, b, c, d;
        if (V == V_NOIN) {
            const int64_t g = j / mj;
            const uint32_t base = (uint32_t)(j - g * mj)
                                  + (seed + (uint32_t)g) * 2654435761u;
            a = base * 0x9E3779B9u;
            b = base * 0x85EBCA6Bu;
            c = base * 0xC2B2AE35u;
            d = base * 0x27D4EB2Fu;
        } else {
            a = __ldg(pa + j);
            b = __ldg(pb + j);
            c = __ldg(za + j);
            d = __ldg(zb + j);
        }
        uint32_t k4[4], e4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int s2 = 2 * (4 * q + i);
            const uint32_t kf = __funnelshift_l(b, a, s2);
            const uint32_t kr = __funnelshift_r(c, d, s2);
            if (V == V_NOHASH) {
                const bool e = ((kf ^ kr) & 15u) == 0u;
                k4[i] = e ? kf : kr;
                e4[i] = e;
            } else {
                const uint32_t hf = hash32_hi(kf, fl, fh);
                const uint32_t hr = hash32_hi(kr, fl, fh);
                const bool isF = hf < hr;
                k4[i] = isF ? kf : kr;
                e4[i] = ((isF ? hf : hr) & wmask) == 0u;
            }
        }
        if (V == V_FULL || V == V_NOHASH || V == V_NOIN) {
            km[qi] = make_uint4(k4[0], k4[1], k4[2], k4[3]);
            em[qi] = e4[0] | (e4[1] << 8) | (e4[2] << 16) | (e4[3] << 24);
        } else if (V == V_KMONLY) {
            km[qi] = make_uint4(e4[0] ? k4[0] : ~k4[0], e4[1] ? k4[1] : ~k4[1],
                                e4[2] ? k4[2] : ~k4[2], e4[3] ? k4[3] : ~k4[3]);
        }
    }
}

// Sets the bits of `byte` in w when (h & wmask) == 0 and km != 0.
__device__ __forceinline__ void set_emit(uint32_t& w, uint32_t h,
                                         uint32_t km, uint32_t wmask,
                                         uint32_t byte) {
    asm("{\n\t"
        ".reg .pred p;\n\t"
        ".reg .b32 t;\n\t"
        "and.b32 t, %1, %3;\n\t"
        "setp.eq.u32 p, t, 0;\n\t"
        "setp.ne.and.u32 p, %2, 0, p;\n\t"
        "@p or.b32 %0, %0, %4;\n\t"
        "}" : "+r"(w) : "r"(h), "r"(km), "r"(wmask), "r"(byte));
}

// em of the 16 positions of one word: byte s (little-endian) is phase s.
__device__ __forceinline__ uint4 emit_word(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t fl,
                                           uint32_t fh, uint32_t wmask) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int s = 0; s < 16; ++s) {
        const uint32_t kf = __funnelshift_l(b, a, 2 * s);
        const uint32_t kr = __funnelshift_r(c, d, 2 * s);
        const uint32_t hf = hash32_hi(kf, fl, fh);
        const uint32_t hr = hash32_hi(kr, fl, fh);
        set_emit(w[s >> 2], min(hf, hr), hf < hr ? kf : kr, wmask,
                 1u << (8 * (s & 3)));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(EMIT_THREADS)
front_emit_kernel(const uint32_t* __restrict__ pa,
                  const uint32_t* __restrict__ pb,
                  const uint32_t* __restrict__ za,
                  const uint32_t* __restrict__ zb, int64_t nj, uint32_t fl,
                  uint32_t fh, uint32_t wmask, uint4* __restrict__ em) {
    const int64_t stride = (int64_t)gridDim.x * EMIT_THREADS;
    int64_t j = (int64_t)blockIdx.x * EMIT_THREADS + threadIdx.x;
    // whole batches of EMIT_U words, every load issued before the first
    // hash; then the last, partial batch with each word guarded
    for (; j + (EMIT_U - 1) * stride < nj; j += EMIT_U * stride) {
        uint32_t a[EMIT_U], b[EMIT_U], c[EMIT_U], d[EMIT_U];
#pragma unroll
        for (int u = 0; u < EMIT_U; ++u) {
            a[u] = __ldg(pa + j + u * stride);
            b[u] = __ldg(pb + j + u * stride);
            c[u] = __ldg(za + j + u * stride);
            d[u] = __ldg(zb + j + u * stride);
        }
#pragma unroll
        for (int u = 0; u < EMIT_U; ++u)
            em[j + u * stride] = emit_word(a[u], b[u], c[u], d[u], fl, fh,
                                           wmask);
    }
#pragma unroll
    for (int u = 0; u < EMIT_U - 1; ++u) {
        const int64_t ju = j + u * stride;
        if (ju < nj)
            em[ju] = emit_word(__ldg(pa + ju), __ldg(pb + ju), __ldg(za + ju),
                               __ldg(zb + ju), fl, fh, wmask);
    }
}

template <int V>
void launch(const void* pa, const void* pb, const void* za, const void* zb,
            int64_t nq, uint64_t factor1, uint32_t wmask, int64_t mj,
            uint32_t seed, int nblocks, void* km, void* em,
            cudaStream_t stream) {
    front_planes_kernel<V><<<nblocks, THREADS, 0, stream>>>(
        (const uint32_t*)pa, (const uint32_t*)pb, (const uint32_t*)za,
        (const uint32_t*)zb, nq, (uint32_t)factor1, (uint32_t)(factor1 >> 32),
        wmask, mj, seed, (uint4*)km, (uint32_t*)em);
}

}  // namespace

extern "C" {

// The blocks of emonly's kernel that one SM holds at once, into *blocks;
// returns a cudaError_t.
int mz_front_emit_blocks_per_sm(int* blocks) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, front_emit_kernel, EMIT_THREADS, 0);
}

// Launch on `stream`; returns cudaGetLastError().  variant indexes
// front_kernel.VARIANTS, up to noin (noout and count: cudaErrorInvalidValue,
// they are mz_front_reduce's).  nj is a multiple of mj, mj of 128;
// nblocks >= 1 (the wrapper caps it at a few blocks per SM; emonly's blocks
// are of EMIT_THREADS threads).  km (u32 [16 nj]) and em (i8 [16 nj],
// 16-byte aligned) are written by the variants that have them.
int mz_front_planes(const void* pa, const void* pb, const void* za,
                    const void* zb, int64_t nj, int variant, uint64_t factor1,
                    uint32_t wmask, int64_t mj, int seed, int nblocks,
                    void* km, void* em, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t nq = 4 * nj;
    const uint32_t sd = (uint32_t)seed;
    switch (variant) {
    case V_FULL:   launch<V_FULL>(pa, pb, za, zb, nq, factor1, wmask, mj, sd, nblocks, km, em, s); break;
    case V_NOHASH: launch<V_NOHASH>(pa, pb, za, zb, nq, factor1, wmask, mj, sd, nblocks, km, em, s); break;
    case V_KMONLY: launch<V_KMONLY>(pa, pb, za, zb, nq, factor1, wmask, mj, sd, nblocks, km, em, s); break;
    case V_EMONLY:
        front_emit_kernel<<<nblocks, EMIT_THREADS, 0, s>>>(
            (const uint32_t*)pa, (const uint32_t*)pb, (const uint32_t*)za,
            (const uint32_t*)zb, nj, (uint32_t)factor1,
            (uint32_t)(factor1 >> 32), wmask, (uint4*)em);
        break;
    case V_NOIN:   launch<V_NOIN>(pa, pb, za, zb, nq, factor1, wmask, mj, sd, nblocks, km, em, s); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
