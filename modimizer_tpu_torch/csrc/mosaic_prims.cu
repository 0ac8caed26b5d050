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
// dot16 replaces probe_dot16: compaction of a 1024-position block,
// out[b][s][c] = sum_p [rank[b][p] == s] * cols[b][p][c], s < 112.  The
// TPU has no vector scatter, so it built the one-hot [112 x 1024] i8 in
// VMEM and ran one MXU dot per block: 112 compares a position to feed the
// matrix unit.  The function is a segment sum, 8 adds a position, and the
// card has shared-memory atomics: a block of 256 threads zeroes a [c][s]
// int32 table in shared memory (rows of DS = 116 words), each position
// whose rank is in 0..111 adds its 8 sign-extended cols bytes into
// table[c][rank] (red.shared.add.s32: integer sums give the same bits in
// any order), and after a sync the table goes out as out[b] in [s][c]
// order, one int4 a thread.  No one-hot and no tensor core.
//   Map: warp w holds positions 128 w .. 128 w + 127, lane l the four
// positions l + 32 i (i = 0..3), so a rank load is 128 B and a cols load
// (uint2) 256 B a warp instruction.  The atomics of one (i, c) go to
// words c * DS + rank of 32 consecutive positions: on the probe's ranks
// (arange % 117) 32 consecutive words, no bank conflict, except in a
// warp instruction whose positions straddle the wrap at 117, where two
// ranks 96 apart share a bank: at most 2-way.  (Four consecutive
// positions a lane would give 4-way conflicts on those ranks.)  The
// store's reads, table[c0 + k][s] for 16 s and c0 in {0, 4}, fall in
// distinct banks because DS = 116 puts the 8 rows 20 banks apart.
//   Bytes in flight: every thread issues its 4 rank and 4 cols loads
// (48 B) before it zeroes the table, so a block has 12 KB in flight before
// its first atomic; 8 blocks fit an SM (2,048 threads, 3.7 KB of shared
// memory each), up to 96 KB an SM.  Bound: memory, ~260 MB per 2^24
// positions (ranks 67, cols 134, out 59); the issue (~20 instructions a
// position, 8 of them atomics) stays under it.  ptxas: 24 registers, no
// spill.
//
// roll12 replaces probe_roll: 12 stages acc += roll(acc, 2^s) along each
// 4096-wide block row (jnp.roll's direction: acc[j] += acc[(j - 2^s) &
// 4095]), u32 wraparound.  After the 12 stages every element is its block
// row's cyclic sum; the kernel still runs every stage, which is what the
// probe times.  One warp holds one block row in registers: lane l keeps
// elements j = l + 32 i in a[i], i = 0..127 (loads and stores 128 B
// coalesced a warp instruction), with no shared memory and no block sync.
//   Stages with 2^s >= 32 (s = 5..11) stay in the lane: the source of
// (l, i) is (l, i - D mod 128), D = 2^s / 32, so each of the D cycles
// {r, r + D, ...} is walked downward after its top's old value is saved
// (one temporary a cycle).  Stages with 2^s < 32 (s = 0..4) are shuffles
// from lane src = (l - 2^s) & 31: register i is shuffled once (sh_i) and
// lane l adds sh_i if l >= 2^s, else sh_{i-1}; sh_{-1} is the shuffled
// old a[127], taken before the walk from i = 127 down to 0, which leaves
// a[i - 1] old when it is shuffled.  ops/mosaic_prims.py's roll12_lanes
// runs this schedule on the CPU.  The five shuffle stages are one loop
// (not unrolled: their code is the same but for the shift), the seven
// register stages are unrolled.  Bound: memory, 134 MB per 2^24 positions
// (in and out once); the issue is ~1,536 adds, 640 shuffles and 640
// selects a warp per block row.  ptxas: 165 registers, no spill, so 12
// warps (3 blocks of R_WARPS = 4) fit an SM, each with its 128 loads
// (16 KB) issued at once: up to 192 KB in flight an SM.

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
constexpr int D_THREADS = 256;              // 8 warps of 128 positions
constexpr int D_PER = D_BLK / D_THREADS;    // positions a lane
constexpr int DS = D_BO + 4;                // words a table row [c]
static_assert(DS % 4 == 0, "table rows are zeroed as int4");

__global__ void __launch_bounds__(D_THREADS)
dot16_kernel(const int32_t* __restrict__ rank, const int8_t* __restrict__ cols,
             int32_t* __restrict__ out) {
    __shared__ __align__(16) int32_t tab[D_NC * DS];
    const int64_t b = blockIdx.x;
    const int p0 = 128 * (threadIdx.x >> 5) + (threadIdx.x & 31);
    const int32_t* R = rank + b * D_BLK + p0;
    const uint2* C2 = reinterpret_cast<const uint2*>(cols + b * D_BLK * D_NC)
                      + p0;
    int r[D_PER];
    uint2 v[D_PER];
#pragma unroll
    for (int i = 0; i < D_PER; ++i) {
        r[i] = __ldg(R + 32 * i);
        v[i] = __ldg(C2 + 32 * i);
    }
    if (threadIdx.x < D_NC * DS / 4)
        reinterpret_cast<int4*>(tab)[threadIdx.x] = make_int4(0, 0, 0, 0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < D_PER; ++i) {
        if ((unsigned)r[i] < (unsigned)D_BO) {
            int32_t* t = tab + r[i];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                atomicAdd(t + c * DS, (int32_t)(int8_t)(v[i].x >> (8 * c)));
                atomicAdd(t + (c + 4) * DS,
                          (int32_t)(int8_t)(v[i].y >> (8 * c)));
            }
        }
    }
    __syncthreads();
    // out[b] as [s][c]: thread t stores words 4t..4t+3, s = t / 2, c from
    // 4 (t % 2)
    if (threadIdx.x < D_BO * D_NC / 4) {
        const int s = threadIdx.x >> 1, c0 = 4 * (threadIdx.x & 1);
        reinterpret_cast<int4*>(out + b * D_BO * D_NC)[threadIdx.x] =
            make_int4(tab[c0 * DS + s], tab[(c0 + 1) * DS + s],
                      tab[(c0 + 2) * DS + s], tab[(c0 + 3) * DS + s]);
    }
}

// ---------------------------------------------------------------- roll12

constexpr int RW = 4096;                    // the probe's block width MJ
constexpr int R_REGS = RW / 32;             // elements a lane
constexpr int R_WARPS = 4;                  // block rows a block, one a warp

// a[i] += a[(i - D) mod 128] for the 2^s = 32 D stages
template <int D>
__device__ __forceinline__ void roll_regs(uint32_t (&a)[R_REGS]) {
#pragma unroll
    for (int r = 0; r < D; ++r) {
        const uint32_t top = a[r + R_REGS - D];
#pragma unroll
        for (int i = r + R_REGS - D; i >= r + D; i -= D)
            a[i] += a[i - D];
        a[r] += top;
    }
}

// a[i] += the element 2^s = d < 32 places back: from lane (l - d) & 31,
// register i if l >= d, else register i - 1 (127 for i = 0)
__device__ __forceinline__ void roll_lanes(uint32_t (&a)[R_REGS], int d,
                                           int lane) {
    const int src = (lane - d) & 31;
    const bool own = lane >= d;
    const uint32_t wrap = __shfl_sync(0xFFFFFFFFu, a[R_REGS - 1], src);
    uint32_t hi = wrap;                     // sh_i
#pragma unroll
    for (int i = R_REGS - 1; i >= 0; --i) {
        const uint32_t lo =                 // sh_{i-1}
            i ? __shfl_sync(0xFFFFFFFFu, a[i - 1], src) : wrap;
        a[i] += own ? hi : lo;
        hi = lo;
    }
}

__global__ void __launch_bounds__(R_WARPS * 32)
roll12_kernel(const uint32_t* __restrict__ x, int64_t nrb,
              uint32_t* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t rb = (int64_t)blockIdx.x * R_WARPS + (threadIdx.x >> 5);
    if (rb >= nrb)
        return;
    const uint32_t* X = x + rb * RW + lane;
    uint32_t a[R_REGS];
#pragma unroll
    for (int i = 0; i < R_REGS; ++i)
        a[i] = __ldg(X + 32 * i);
#pragma unroll 1
    for (int s = 0; s < 5; ++s)
        roll_lanes(a, 1 << s, lane);
    roll_regs<1>(a);
    roll_regs<2>(a);
    roll_regs<4>(a);
    roll_regs<8>(a);
    roll_regs<16>(a);
    roll_regs<32>(a);
    roll_regs<64>(a);
    uint32_t* O = out + rb * RW + lane;
#pragma unroll
    for (int i = 0; i < R_REGS; ++i)
        O[32 * i] = a[i];
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
    const int64_t nrb = rows * (nj / RW);   // block rows, contiguous
    roll12_kernel<<<(unsigned)((nrb + R_WARPS - 1) / R_WARPS), R_WARPS * 32,
                    0, (cudaStream_t)stream>>>((const uint32_t*)x, nrb,
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
