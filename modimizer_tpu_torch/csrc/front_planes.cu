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
// Design.  The TPU kernels put the 16 phases on sublanes and split each
// 32x32 multiply-high into 16-bit limbs (the VPU has no 32x32->64
// multiply).  Here one thread computes one quad (4 consecutive phases of one
// word): one IMAD.HI and one IMAD per hash, a funnel shift per strand, and
// one 16-byte store of km and one 4-byte store of em, so a warp stores 512
// and 128 contiguous bytes.  A block is 512 threads = 128 words x 4 quads,
// and the grid strides by whole blocks.
//
// What bounds it: memory for the variants that store the k-mer plane.
// `full`, `nohash` and `noin` write 5 B a position and `kmonly` 4; all but
// `noin` read 1 B (four u32 streams per 16 positions, each word's load
// shared by its 4 threads through L1).  Their ~10 integer instructions a
// position take less than those bytes' time.  `emonly` moves only 2 B a
// position: it is under half of its bytes bound (PERF.md), and what holds
// it back is not measured yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// front_kernel.VARIANTS; noout and count are csrc/front_reduce.cu's
enum Variant { V_FULL, V_NOHASH, V_KMONLY, V_EMONLY, V_NOIN };

constexpr int THREADS = 512;     // 128 words x 4 quads

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
        } else if (V == V_EMONLY) {
            em[qi] = (e4[0] & (k4[0] != 0u)) | ((e4[1] & (k4[1] != 0u)) << 8)
                     | ((e4[2] & (k4[2] != 0u)) << 16)
                     | ((e4[3] & (k4[3] != 0u)) << 24);
        }
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

// Launch on `stream`; returns cudaGetLastError().  variant indexes
// front_kernel.VARIANTS, up to noin (noout and count: cudaErrorInvalidValue,
// they are mz_front_reduce's).  nj is a multiple of mj, mj of 128;
// nblocks >= 1 (the wrapper caps it at a few blocks per SM).  km (u32
// [16 nj]) and em (i8 [16 nj]) are written by the variants that have them.
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
    case V_EMONLY: launch<V_EMONLY>(pa, pb, za, zb, nq, factor1, wmask, mj, sd, nblocks, km, em, s); break;
    case V_NOIN:   launch<V_NOIN>(pa, pb, za, zb, nq, factor1, wmask, mj, sd, nblocks, km, em, s); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
