// The k = 16 front with both strands' hash partials from integer tensor-core
// products of byte limbs (sm_90a).
//
// Replaces scripts/probe_front_mxu.py::kern_mxu (the JAX package), whose
// partials come from one bf16 [24, 8] @ [8, MJ] MXU dot per tile.
// Contract: modimizer_tpu_torch/ops/front_mma.py::front_mma_ref, the same
// planes as front_planes "full".
//
// Design.  hash32_hi(a) is linear in the byte limbs of a, so one
// mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 per 8 partials computes
// them for 16 positions: A is 16 positions (the 16 phases of one word j) x
// 32 limbs, of which 8 are used (4 of kf, then 4 of kr; the rest zero), B is
// the 32 x 24 limb weights as three n = 8 tiles, the accumulator s32.  u8 x
// u8 -> s32 is exact (a partial is at most 4 x 255^2); bf16 HMMA would need
// the f32 accumulator's 24 bits to be enough, IMMA needs nothing.  In the A
// fragment, lane (g, t) holds row g and row g + 8 at columns 4t .. 4t + 3:
// a limb column quad is the u32 k-mer itself, so lanes t = 0 and t = 1 pass
// kf and kr of phases g and g + 8 straight in, and the others pass zero.
// One warp does one word per step: 3 MMAs, the 16 x 24 partials through
// shared memory, then lane L runs the carry chain for phase L % 16 and
// strand L / 16, and a shuffle brings hf and hr together for the emit test.
//
// What bounds it: issue, not the tensor cores.  Per 16 positions a warp
// runs 3 MMAs, 12 shared stores, 11 shared loads, the carry chain and two
// shuffles, against ~10 integer instructions per position for the
// IMAD.HI front of front_planes.cu: this kernel answers whether the TPU's
// MXU trick pays on Hopper (it is not expected to), not how to be fast.
// A wgmma version is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int PSTRIDE = 25;      // 24 partial columns, padded for banks

// [24 rows][2]: bytes 4t .. 4t+3 of limb-weight row r, little-endian
struct LimbWeights { uint32_t w[48]; };

__device__ __forceinline__ void mma_u8(int d[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
    const uint32_t z = 0u;      // A columns 16-31, B rows 16-31, C
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a0), "r"(a1), "r"(z), "r"(z), "r"(b0), "r"(z),
          "r"(z), "r"(z), "r"(z), "r"(z));
}

__device__ __forceinline__ uint32_t carries(const uint32_t* p) {
    const uint32_t c01 = p[0] + (p[1] << 8);
    const uint32_t c23 = p[2] + (p[3] << 8);
    const uint32_t mid = (c01 >> 16) + c23;
    const uint32_t hi = (mid >> 16) + p[4] + (p[5] << 8) + (p[6] << 16);
    const uint32_t lo = p[7] + (p[8] << 8) + (p[9] << 16) + (p[10] << 24);
    return hi + lo;
}

__global__ void __launch_bounds__(WARPS * 32)
front_mma_kernel(const uint32_t* __restrict__ pa,
                 const uint32_t* __restrict__ pb,
                 const uint32_t* __restrict__ za,
                 const uint32_t* __restrict__ zb, int64_t nj,
                 LimbWeights W, uint32_t wmask,
                 uint32_t* __restrict__ km, uint8_t* __restrict__ em) {
    __shared__ uint32_t part[WARPS][16][PSTRIDE];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    uint32_t b0[3];
#pragma unroll
    for (int tl = 0; tl < 3; ++tl)
        b0[tl] = t < 2 ? W.w[(8 * tl + g) * 2 + t] : 0u;
    uint32_t (*P)[PSTRIDE] = part[warp];
    const int pos = lane & 15, strand = lane >> 4;

    for (int64_t j = (int64_t)blockIdx.x * WARPS + warp; j < nj;
         j += (int64_t)gridDim.x * WARPS) {
        const uint32_t a = __ldg(pa + j), b = __ldg(pb + j);
        const uint32_t c = __ldg(za + j), d = __ldg(zb + j);
        uint32_t a0 = 0u, a1 = 0u;
        if (t == 0) {
            a0 = __funnelshift_l(b, a, 2 * g);
            a1 = __funnelshift_l(b, a, 2 * (g + 8));
        } else if (t == 1) {
            a0 = __funnelshift_r(c, d, 2 * g);
            a1 = __funnelshift_r(c, d, 2 * (g + 8));
        }
#pragma unroll
        for (int tl = 0; tl < 3; ++tl) {
            int acc[4];
            mma_u8(acc, a0, a1, b0[tl]);
            const int col = 8 * tl + 2 * t;
            P[g][col] = acc[0];
            P[g][col + 1] = acc[1];
            P[g + 8][col] = acc[2];
            P[g + 8][col + 1] = acc[3];
        }
        __syncwarp();
        const uint32_t h = carries(&P[pos][11 * strand]);
        const uint32_t hf = __shfl_sync(0xFFFFFFFFu, h, pos);
        const uint32_t hr = __shfl_sync(0xFFFFFFFFu, h, pos + 16);
        if (lane < 16) {
            const uint32_t kf = __funnelshift_l(b, a, 2 * pos);
            const uint32_t kr = __funnelshift_r(c, d, 2 * pos);
            const bool isF = hf < hr;
            km[16 * j + pos] = isF ? kf : kr;
            em[16 * j + pos] = ((isF ? hf : hr) & wmask) == 0u;
        }
        __syncwarp();
    }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError().  weights: host pointer to
// the [24][8] u8 limb weights (front_mma.limb_weights), passed to the kernel
// by value.  nblocks >= 1 blocks of 8 warps stride over the nj words.
int mz_front_mma(const void* pa, const void* pb, const void* za,
                 const void* zb, int64_t nj, const void* weights,
                 uint32_t wmask, int nblocks, void* km, void* em,
                 void* stream) {
    LimbWeights W;
    const uint8_t* wb = (const uint8_t*)weights;
    for (int i = 0; i < 48; ++i)
        W.w[i] = wb[4 * i] | (wb[4 * i + 1] << 8) | (wb[4 * i + 2] << 16)
                 | ((uint32_t)wb[4 * i + 3] << 24);
    front_mma_kernel<<<nblocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)pa, (const uint32_t*)pb, (const uint32_t*)za,
        (const uint32_t*)zb, nj, W, wmask, (uint32_t*)km, (uint8_t*)em);
    return (int)cudaGetLastError();
}

}  // extern "C"
