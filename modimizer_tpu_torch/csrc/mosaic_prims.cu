// The compaction primitives that scripts/probe_mosaic_prims.py (the JAX
// package) times on the TPU, as four kernels for sm_90a.  Contracts: the
// plain versions in modimizer_tpu_torch/ops/mosaic_prims.py.  u32 values
// ride in int32 tensors as their bit patterns.
//
// tala16 replaces probe_tala16: out[r][j] = x[idx[r][j] & 15][j], r < 8,
// x and idx [16][nj].  Bound: memory, 134 MB per 2^24 positions (x 67 MB,
// the 8 index rows read 34 MB, out 34 MB).  A block stages a [16][128]
// slab of x in shared memory with 16-byte loads, then each thread gathers
// its column's 8 rows from there: no run-time-indexed register array (it
// would spill) and no scattered global reads.  A thread reads column c of
// any row, so shared reads fall in bank c % 32 without conflicts.
//
// dot16 replaces probe_dot16: one-hot compaction of a 1024-position block,
// out[b][s][c] = sum_p [rank[b][p] == s] * cols[b][p][c], s < 112.  The
// TPU built the one-hot [112 x 1024] i8 in VMEM and ran one MXU dot per
// block; here it is the A operand of s8 mma.sync.m16n8k32 (the tensor-core
// counterpart of the i8 dot), built in registers: 7 warps, one 16-slot
// m-tile each, 32 k-steps of 32 positions, 7 x 32 MMAs a block.  Ranks go
// to shared memory once as bytes (0xFF where no slot takes them), so four
// one-hot entries are one __vcmpeq4; cols go to shared memory transposed
// ([c][p], rows padded by 16 bytes) so a B fragment register is one
// conflict-free 32-bit read.  Bound: ~260 MB per 2^24 positions (ranks 67,
// cols 134, out 59) against 112 one-hot compares per position, done four
// to an instruction.
//
// roll12 replaces probe_roll: 12 stages acc += roll(acc, 2^s) along each
// 4096-wide block row (jnp.roll's direction: acc[j] += acc[(j - 2^s) &
// 4095]), u32 wraparound.  After the 12 stages every element is its block
// row's cyclic sum; the kernel still runs every stage, which is what the
// probe times.  One block per block row ping-pongs two 16 KB rows in
// shared memory.  Bound: 12 stages of 4096 shared reads x 2 and a write
// per block row, 134 MB of device traffic per 2^24 positions.
//
// cumsum128 replaces probe_cumsum128: out[r][j] = sum_{i <= j} e[r][i]
// over 128 columns, i8 in, s32 out (the TPU's e @ UT128 product).  A warp
// takes 16 rows: it stages them in shared memory (rows padded to 144 bytes
// so A fragment reads do not conflict) and runs s8 mma.sync against the
// all-ones upper triangle, whose B fragments are computed in registers:
// 16 n-tiles x 4 k-steps.  Bound: memory, 84 MB per 2^24 elements (16 in,
// 67 out).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// D += A (16 x 32, s8, row) x B (32 x 8, s8, col) in s32.  Lane (g, t) =
// (lane / 4, lane % 4) holds A rows g (a0, a2) and g + 8 (a1, a3) at
// columns 4t..4t+3 (a0, a1) and 16+4t..16+4t+3 (a2, a3), byte i of a
// register being column +i; B column g at rows 4t.. (b0) and 16+4t.. (b1);
// D rows g (d0, d1) and g + 8 (d2, d3) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- tala16

constexpr int TALA_TJ = 128;        // columns a block, one a thread

__global__ void __launch_bounds__(TALA_TJ)
tala16_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ idx,
              int64_t nj, uint32_t* __restrict__ out) {
    __shared__ __align__(16) uint32_t slab[16][TALA_TJ];
    const int64_t j0 = (int64_t)blockIdx.x * TALA_TJ;
    for (int i = threadIdx.x; i < 16 * TALA_TJ / 4; i += TALA_TJ) {
        const int r = i / (TALA_TJ / 4), q = i % (TALA_TJ / 4);
        *reinterpret_cast<uint4*>(&slab[r][4 * q]) =
            __ldg(reinterpret_cast<const uint4*>(x + r * nj + j0) + q);
    }
    __syncthreads();
    const int c = threadIdx.x;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const uint32_t s = __ldg(idx + r * nj + j0 + c) & 15u;
        out[r * nj + j0 + c] = slab[s][c];
    }
}

// ----------------------------------------------------------------- dot16

constexpr int D_BLK = 1024, D_BO = 112, D_NC = 8;
constexpr int D_MT = D_BO / 16;             // 7 m-tiles, one a warp
constexpr int D_THREADS = 256;
constexpr int D_CT = D_BLK + 16;            // bytes a transposed cols row

__device__ __forceinline__ uint32_t rank_byte(int r) {
    return (unsigned)r < (unsigned)D_BO ? (uint32_t)r : 0xFFu;
}

__global__ void __launch_bounds__(D_THREADS)
dot16_kernel(const int32_t* __restrict__ rank, const int8_t* __restrict__ cols,
             int32_t* __restrict__ out) {
    __shared__ uint32_t rk[D_BLK / 4];                  // 4 rank bytes a word
    __shared__ __align__(16) uint8_t ct[D_NC][D_CT];    // cols as [c][p]
    const int64_t b = blockIdx.x;
    {
        const int4 v = __ldg(reinterpret_cast<const int4*>(rank + b * D_BLK)
                             + threadIdx.x);
        rk[threadIdx.x] = rank_byte(v.x) | rank_byte(v.y) << 8
                          | rank_byte(v.z) << 16 | rank_byte(v.w) << 24;
    }
    const uint2* C2 = reinterpret_cast<const uint2*>(cols + b * D_BLK * D_NC);
    for (int p = threadIdx.x; p < D_BLK; p += D_THREADS) {
        const uint2 v = __ldg(C2 + p);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            ct[c][p] = (uint8_t)(v.x >> (8 * c));
            ct[c + 4][p] = (uint8_t)(v.y >> (8 * c));
        }
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp >= D_MT)
        return;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t s0 = (uint32_t)(16 * warp + g) * 0x01010101u;
    const uint32_t s1 = (uint32_t)(16 * warp + g + 8) * 0x01010101u;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (int ks = 0; ks < D_BLK / 32; ++ks) {
        const uint32_t r0 = rk[8 * ks + t], r1 = rk[8 * ks + 4 + t];
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&ct[g][32 * ks + 4 * t]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&ct[g][32 * ks + 16 + 4 * t]);
        mma_s8(acc, __vcmpeq4(r0, s0) & 0x01010101u,
               __vcmpeq4(r0, s1) & 0x01010101u,
               __vcmpeq4(r1, s0) & 0x01010101u,
               __vcmpeq4(r1, s1) & 0x01010101u, b0, b1);
    }
    int32_t* O = out + (b * D_BO + 16 * warp + g) * D_NC + 2 * t;
    *reinterpret_cast<int2*>(O) = make_int2(acc[0], acc[1]);
    *reinterpret_cast<int2*>(O + 8 * D_NC) = make_int2(acc[2], acc[3]);
}

// ---------------------------------------------------------------- roll12

constexpr int RW = 4096;                    // the probe's block width MJ
constexpr int R_THREADS = 1024;

__global__ void __launch_bounds__(R_THREADS)
roll12_kernel(const uint32_t* __restrict__ x, int64_t nj,
              uint32_t* __restrict__ out) {
    __shared__ __align__(16) uint32_t buf[2][RW];
    const int64_t nblk = nj / RW;
    const int64_t row = blockIdx.x / nblk, blk = blockIdx.x % nblk;
    const int64_t off = row * nj + blk * RW;
    reinterpret_cast<uint4*>(buf[0])[threadIdx.x] =
        __ldg(reinterpret_cast<const uint4*>(x + off) + threadIdx.x);
    __syncthreads();
    int cur = 0;
    for (int s = 0; s < 12; ++s) {
        const int sh = 1 << s;
        for (int j = threadIdx.x; j < RW; j += R_THREADS)
            buf[cur ^ 1][j] = buf[cur][j] + buf[cur][(j - sh) & (RW - 1)];
        cur ^= 1;
        __syncthreads();
    }
    reinterpret_cast<uint4*>(out + off)[threadIdx.x] =
        reinterpret_cast<const uint4*>(buf[cur])[threadIdx.x];
}

// ------------------------------------------------------------- cumsum128

constexpr int CS_W = 128;                   // columns
constexpr int CS_WARPS = 4;
constexpr int CS_STRIDE = 144;              // bytes a staged row

// bytes i = 0..3 of a B register: UT[k0 + i][n] = (k0 + i <= n), d = n - k0
__device__ __forceinline__ uint32_t ut_bytes(int d) {
    if (d < 0)
        return 0u;
    if (d >= 3)
        return 0x01010101u;
    return 0x01010101u >> (8 * (3 - d));
}

__global__ void __launch_bounds__(CS_WARPS * 32)
cumsum128_kernel(const int8_t* __restrict__ e, int64_t rows,
                 int32_t* __restrict__ out) {
    __shared__ __align__(16) uint8_t tile[CS_WARPS][16][CS_STRIDE];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t r0 = ((int64_t)blockIdx.x * CS_WARPS + warp) * 16;
    if (r0 >= rows)
        return;
    uint8_t (*T)[CS_STRIDE] = tile[warp];
    const uint4* E = reinterpret_cast<const uint4*>(e + r0 * CS_W);
    for (int i = lane; i < 16 * CS_W / 16; i += 32)
        *reinterpret_cast<uint4*>(&T[i >> 3][16 * (i & 7)]) = __ldg(E + i);
    __syncwarp();
    const int g = lane >> 2, t = lane & 3;
    uint32_t a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
        const int c0 = 32 * ks + 4 * t;
        a[ks][0] = *reinterpret_cast<const uint32_t*>(&T[g][c0]);
        a[ks][1] = *reinterpret_cast<const uint32_t*>(&T[g + 8][c0]);
        a[ks][2] = *reinterpret_cast<const uint32_t*>(&T[g][c0 + 16]);
        a[ks][3] = *reinterpret_cast<const uint32_t*>(&T[g + 8][c0 + 16]);
    }
    int32_t* O = out + (r0 + g) * CS_W + 2 * t;
#pragma unroll 2
    for (int nt = 0; nt < CS_W / 8; ++nt) {
        const int n = 8 * nt + g;           // this lane's B column
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
            mma_s8(acc, a[ks][0], a[ks][1], a[ks][2], a[ks][3],
                   ut_bytes(n - (32 * ks + 4 * t)),
                   ut_bytes(n - (32 * ks + 16 + 4 * t)));
        *reinterpret_cast<int2*>(O + 8 * nt) = make_int2(acc[0], acc[1]);
        *reinterpret_cast<int2*>(O + 8 * CS_W + 8 * nt) =
            make_int2(acc[2], acc[3]);
    }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
// The wrappers in ops/mosaic_prims.py check shapes: nj a positive multiple
// of 128 (tala16) or 4096 (roll12), rows a multiple of 16 (cumsum128).

int mz_tala16(const void* x, const void* idx, int64_t nj, void* out,
              void* stream) {
    tala16_kernel<<<(unsigned)(nj / TALA_TJ), TALA_TJ, 0,
                    (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)idx, nj, (uint32_t*)out);
    return (int)cudaGetLastError();
}

int mz_dot16(const void* rank, const void* cols, int64_t nb, void* out,
             void* stream) {
    dot16_kernel<<<(unsigned)nb, D_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rank, (const int8_t*)cols, (int32_t*)out);
    return (int)cudaGetLastError();
}

int mz_roll12(const void* x, int64_t rows, int64_t nj, void* out,
              void* stream) {
    roll12_kernel<<<(unsigned)(rows * (nj / RW)), R_THREADS, 0,
                    (cudaStream_t)stream>>>((const uint32_t*)x, nj,
                                            (uint32_t*)out);
    return (int)cudaGetLastError();
}

int mz_cumsum128(const void* e, int64_t rows, void* out, void* stream) {
    const int64_t warps = rows / 16;
    cumsum128_kernel<<<(unsigned)((warps + CS_WARPS - 1) / CS_WARPS),
                       CS_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int8_t*)e, rows, (int32_t*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
