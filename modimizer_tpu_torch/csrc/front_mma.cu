// The k = 16 front with both strands' hash partials from integer tensor-core
// products of byte limbs (sm_90a).
//
// Replaces scripts/probe_front_mxu.py::kern_mxu (the JAX package), whose
// partials come from one bf16 [24, 8] @ [8, MJ] MXU dot per tile.
// Contract: modimizer_tpu_torch/ops/front_mma.py::front_mma_ref, the same
// planes as front_planes "full": km u32 [16 nj] and em i8 [16 nj] in
// position order, k = 16, w a power of two (wmask = w - 1).
//
// Arithmetic.  hash32_hi(a) is linear in the byte limbs of a: the 11
// partials p[s] = sum_i limb_i(a) W1[s][i] (W1 the [11, 4] block of
// front_mma.limb_weights) and a u32 carry chain (`carries`) rebuild it.
// u8 x u8 -> s32 is exact: a partial is at most 4 x 255^2 < 2^18.
//
// Fragment map (front_mma.py: tile_weights, b_fragments, d_slot; rehearsed
// on the CPU by tests/test_torch_front_mma.py).  A warp takes a group of 4
// words j0 .. j0 + 3 (64 positions) with 12
// mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32, six a strand, lane (g,
// t) = (lane / 4, lane % 4):
//   A  [16 phases x 16 limbs]: the lane passes word j0 + t's k-mer of the
//      strand, a0 at phase g, a1 at phase g + 8 (K columns 4t .. 4t + 3).
//      A register is the u32 k-mer itself: byte i is limb i.
//   B  [16 x 48], block-diagonal over the 4 limb quads, the same for both
//      strands: tile i, column c holds W1[p] (p = 2 i + c % 2; p = 11 is
//      zero) at the rows of word c / 2's quad.  Only the lanes with t ==
//      g / 2 pass non-zero B: six registers a lane for the whole launch.
//   D  lane (g, t) ends with all 11 partials of both strands of positions
//      16 (j0 + t) + g and + g + 8 (c0, c1 row g, c2, c3 row g + 8): the
//      four carry chains, hf < hr, the select and the emit test run in the
//      lane's registers, with no shared memory and no shuffle.
// The m16n8k32 form of the same map (K = forward then reverse limbs, 12
// tiles of a [32 x 96] B) was built first: its B register pairs are half
// zero, and ptxas rebuilt those pairs with ~13 moves a group (IMMA takes B
// as an aligned register pair, C = 0 could not share them); k = 16 needs
// no zero operand and issues half the tensor work (0.0524 against 0.0448
// ms at 2^24 in turns).
//
// Loads.  A warp takes 64 words (16 groups, 1,024 positions) an iteration:
// each stream as two coalesced 128-byte loads (register r of lane L holds
// word 32 r + L), handed to the lanes of each group by one __shfl_sync a
// stream.  The next iteration's 8 loads are issued before this one's MMAs,
// so a warp keeps 1 KB in flight, an SM 16 KB at 16 warps (4 blocks of 4
// warps, the launch bound) -- reads are 1 byte of the 6 a position moves,
// so ~4 KB an SM would cover the read latency at the bytes bound.
//
// Stores.  km: each store instruction covers positions 16 (j0 + t) + g
// (then + 8) for g < 8, t < 4: four full 32-byte sectors.  em: two
// __ballot_sync a group give every lane the group's 64 emit bits; for two
// groups, lane L packs the bytes of positions 4 L .. 4 L + 3 into one u32
// and the warp stores 128 contiguous bytes.
//
// What bounds it.  Bytes: the planes in (1 B a position) and km, em out (5
// B), 100.7 MB at 2^24, 0.030 ms at 3.35 TB/s.  Issue comes next: the loop
// body is 87 SASS instructions a group (12 IMMA, 4 SHFL, 4 funnel shifts,
// four carry chains of ~10, the select and emit test, 2 VOTE, the stores),
// 1.36 a position, ~0.025 ms at 2^24 over 132 SMs x 4 schedulers.  The
// function's work is 384 int8 operations a position (6.4 G at 2^24, 0.0033
// ms at the int8 peak); the map issues 768 (the other words' quads of B
// are zero), well under the tensor cores' rate.  So wgmma (64-row tiles, B
// through a shared-memory descriptor, a warpgroup per tile) would buy
// nothing here: mma.sync keeps each lane's partials in the registers where
// its carry chains run.  On an H100 SXM (700 W) it takes 0.0448 ms at 2^24
// (67 % of the bound), about what front_planes "full" (~0.3 instructions a
// position) takes to move the same bytes; streaming stores and 5 blocks an
// SM moved it by less than 1 %.  ptxas (CUDA 12.9, sm_90a): 116 registers,
// no spill.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;            // a block
constexpr int MIN_BLOCKS = 4;       // an SM, the launch bound: <= 128 regs
constexpr int R = 2;                // words a lane a stream an iteration
constexpr int WORDS = 32 * R;       // words a warp an iteration
constexpr uint32_t FULL = 0xFFFFFFFFu;

// [24 rows][2]: bytes 4t .. 4t+3 of limb-weight row r, little-endian
struct LimbWeights { uint32_t w[48]; };

// D = A (16 x 16, u8, row) x B (16 x 8, u8, col) in s32, C = 0.
__device__ __forceinline__ void mma_u8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
    asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a0), "r"(a1), "r"(b0), "r"(0));
}

// hash32_hi from one strand's 11 partials, p[s] = tile s / 2, register
// `row` + s % 2 (row 0: phase g, row 2: phase g + 8)
__device__ __forceinline__ uint32_t carries(const int (&D)[6][4], int row) {
    const uint32_t p0 = D[0][row], p1 = D[0][row + 1], p2 = D[1][row],
                   p3 = D[1][row + 1], p4 = D[2][row], p5 = D[2][row + 1],
                   p6 = D[3][row], p7 = D[3][row + 1], p8 = D[4][row],
                   p9 = D[4][row + 1], p10 = D[5][row];
    const uint32_t c01 = p0 + (p1 << 8);
    const uint32_t c23 = p2 + (p3 << 8);
    const uint32_t mid = (c01 >> 16) + c23;
    const uint32_t hi = (mid >> 16) + p4 + (p5 << 8) + (p6 << 16);
    const uint32_t lo = p7 + (p8 << 8) + (p9 << 16) + (p10 << 24);
    return hi + lo;
}

// bytes i = 0..3 of the result are bit 4 i of x
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
    return (x & 1u) | ((x << 4) & 0x100u) | ((x << 8) & 0x10000u)
           | ((x << 12) & 0x1000000u);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
front_mma_kernel(const uint32_t* __restrict__ pa,
                 const uint32_t* __restrict__ pb,
                 const uint32_t* __restrict__ za,
                 const uint32_t* __restrict__ zb, int64_t nj,
                 LimbWeights W, uint32_t wmask,
                 uint32_t* __restrict__ km, uint32_t* __restrict__ em) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // B of tile i, for both strands
    uint32_t bw[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const int p = 2 * i + (g & 1);
        bw[i] = (t == (g >> 1) && p < 11) ? W.w[2 * p] : 0u;
    }
    const int sf = 2 * g;                   // phase g's shift; g + 8: + 16
    // em: lane L packs positions 4 L' .. 4 L' + 3 (L' = L % 16 = 4 t + q)
    // of group 2 q2 + L / 16: position 16 t + 4 q + i is bit 16 (q % 2) +
    // 4 i + t of that group's ballot lo (q < 2) or hi
    const int eh = lane >> 4, et = (lane >> 2) & 3, eq = lane & 3;
    const int eshift = 16 * (eq & 1) + et;

    const int64_t stride = (int64_t)gridDim.x * WARPS * WORDS;
    int64_t base = ((int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5)) * WORDS;
    uint32_t nx[4][R];
    if (base < nj) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int64_t j = base + 32 * r + lane;
            nx[0][r] = __ldg(pa + j);
            nx[1][r] = __ldg(pb + j);
            nx[2][r] = __ldg(za + j);
            nx[3][r] = __ldg(zb + j);
        }
    }
    for (; base < nj; base += stride) {
        uint32_t cur[4][R];
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int r = 0; r < R; ++r) cur[s][r] = nx[s][r];
        if (base + stride < nj) {           // the next iteration's loads
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int64_t j = base + stride + 32 * r + lane;
                nx[0][r] = __ldg(pa + j);
                nx[1][r] = __ldg(pb + j);
                nx[2][r] = __ldg(za + j);
                nx[3][r] = __ldg(zb + j);
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll 1
            for (int q2 = 0; q2 < 4; ++q2) {      // two groups a step
                uint32_t lo[2], hi[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int src = 4 * (2 * q2 + h) + t;   // word 32 r + src
                    const uint32_t a = __shfl_sync(FULL, cur[0][r], src);
                    const uint32_t b = __shfl_sync(FULL, cur[1][r], src);
                    const uint32_t c = __shfl_sync(FULL, cur[2][r], src);
                    const uint32_t d = __shfl_sync(FULL, cur[3][r], src);
                    const uint32_t kf0 = __funnelshift_l(b, a, sf);
                    const uint32_t kf1 = __funnelshift_l(b, a, sf + 16);
                    const uint32_t kr0 = __funnelshift_r(c, d, sf);
                    const uint32_t kr1 = __funnelshift_r(c, d, sf + 16);
                    // one strand's six tiles, then its chains: 24
                    // accumulators live, not 48
                    int D[6][4];
#pragma unroll
                    for (int i = 0; i < 6; ++i) mma_u8(D[i], kf0, kf1, bw[i]);
                    const uint32_t hf0 = carries(D, 0), hf1 = carries(D, 2);
#pragma unroll
                    for (int i = 0; i < 6; ++i) mma_u8(D[i], kr0, kr1, bw[i]);
                    const uint32_t hr0 = carries(D, 0), hr1 = carries(D, 2);
                    const bool f0 = hf0 < hr0, f1 = hf1 < hr1;
                    const bool e0 = ((f0 ? hf0 : hr0) & wmask) == 0u;
                    const bool e1 = ((f1 ? hf1 : hr1) & wmask) == 0u;
                    uint32_t* kw = km + 16 * (base + 32 * r + src);
                    kw[g] = f0 ? kf0 : kr0;
                    kw[g + 8] = f1 ? kf1 : kr1;
                    lo[h] = __ballot_sync(FULL, e0);
                    hi[h] = __ballot_sync(FULL, e1);
                }
                const uint32_t bits = eq < 2 ? (eh ? lo[1] : lo[0])
                                             : (eh ? hi[1] : hi[0]);
                em[4 * (base + 32 * r + 8 * q2) + lane] =
                    spread4(bits >> eshift);
            }
        }
    }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError().  nj is a multiple of 64,
// the words a warp takes an iteration (cudaErrorInvalidValue otherwise; the
// wrapper asks a multiple of 128).  weights: host pointer to the [24][8] u8
// limb weights (front_mma.limb_weights), passed to the kernel by value.  At
// most nblocks blocks of 4 warps stride over the words; no more blocks than
// the words fill.
int mz_front_mma(const void* pa, const void* pb, const void* za,
                 const void* zb, int64_t nj, const void* weights,
                 uint32_t wmask, int nblocks, void* km, void* em,
                 void* stream) {
    if (nj <= 0 || nj % WORDS || nblocks < 1)
        return (int)cudaErrorInvalidValue;
    LimbWeights W;
    const uint8_t* wb = (const uint8_t*)weights;
    for (int i = 0; i < 48; ++i)
        W.w[i] = wb[4 * i] | (wb[4 * i + 1] << 8) | (wb[4 * i + 2] << 16)
                 | ((uint32_t)wb[4 * i + 3] << 24);
    const int64_t need = (nj + WARPS * WORDS - 1) / (WARPS * WORDS);
    const int nb = (int)(need < nblocks ? need : nblocks);
    front_mma_kernel<<<nb, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)pa, (const uint32_t*)pb, (const uint32_t*)za,
        (const uint32_t*)zb, nj, W, wmask, (uint32_t*)km, (uint32_t*)em);
    return (int)cudaGetLastError();
}

}  // extern "C"
