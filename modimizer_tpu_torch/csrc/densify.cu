// Densify: pack the live rows of compaction blocks into one dense prefix,
// in order, and pad it to cap with sentinels (sm_90a).
//
// Replaces modimizer_tpu/ops/device_scan.py::_densify_dispatch, whose TPU
// forms (_densify_cols_roll2 / _densify_cols conditional-roll butterflies,
// _densify_cols_search gathers) exist because the TPU has no vector scatter.
// Contract of _densify_cols_search (modimizer_tpu_torch/ops/device_scan.py::
// densify_ref): block b's live rows j < min(cnt[b], bo) go, in order, to
// slot base[b] + j when that is below cap, base being the exclusive prefix
// sum of min(cnt, bo) over the blocks; slots [min(total, cap), cap) hold
// all-ones sentinels, total = sum of min(cnt, bo).
//
// What bounds it on this card: bytes.  At the scanner's chunk (2^25
// positions, k16 w16, blk 512, bo 72) the call must read 65,536 counts and
// ~2.1 M live rows (8 B, +4 B of meta) and write cap = 2.36 M slots once:
// 35.7 MB, 0.0106 ms at 3.35 TB/s.  The earlier step around one thread per
// source slot took 0.0547 ms (NVIDIA H100 80GB HBM3, 700.00 W): four
// PyTorch launches for the prefix sum, a torch.full that wrote all cap
// slots before the kernel wrote the live ones again, and 4.7 M threads each
// dividing by bo to find its block, 56 % of them then idle.
//
// Design: two launches and nothing else on the device; the caller only
// allocates the outputs and an int32 [ntiles] scratch (per call, so there
// is no state to reset and no hazard across streams).  A tile is TPB = 256
// consecutive compaction blocks, one per thread.
//   1. densify_tiles_kernel: a tile's clamped counts summed by warp
//      shuffles into agg[tile].  Each thread block lets launch 2 start at
//      once (griddepcontrol.launch_dependents).
//   2. densify_rows_kernel, a programmatic dependent launch (its blocks are
//      placed while launch 1 runs): thread block t takes tile t again, loads
//      its counts and scans them per warp (shuffles), then waits for
//      launch 1 (griddepcontrol.wait) and reads all ntiles aggregates (1 KB
//      at the scanner's shape): the sum of those before t is the tile's
//      base, their sum is the total.  This replaces a decoupled look-back:
//      no status flags, no ticket, no thread block ever waits on another.
//      A warp owns 32 consecutive blocks, one per lane, and copies their
//      live rows as one range: row q of the range lies in the block of lane
//      l = max{l : p(l) <= q} (p the lanes' exclusive prefixes; five
//      shuffle steps, warp_block_of), at offset q - p(l), and goes to slot
//      tile base + warp base + q.  Lanes take consecutive q, so loads and
//      stores are coalesced; slots past cnt are never read; nothing divides.
//      Each lane keeps ROWS = 4 row loads in flight before it stores, and
//      SPLIT = 2 warps share a range in alternate rounds: twice the warps
//      a SM holds loads in flight for the same registers a range.  Then the
//      thread block writes its 1/ntiles share of the sentinel tail, so each
//      output slot is written exactly once.
// The constants measured fastest at the scanner's shapes among ROWS 4, 8,
// 16 and SPLIT 1, 2, 4 (at SPLIT 4 a SM holds half the blocks), and the
// dependent launch measured faster than a plain one.
// Compile the placement helpers alone as host code with
// `g++ -x c++ -DMZ_DENSIFY_HOST` (the CPU tests do, and hold their
// placements against densify_ref).

#include <cstdint>

#ifdef MZ_DENSIFY_HOST
#define MZ_HD inline
#else
#include <cuda_runtime.h>
#define MZ_HD __host__ __device__ __forceinline__
#endif

namespace densify_place {

constexpr int TPB = 256;               // compaction blocks a tile
constexpr int WARPS = TPB / 32;        // warps that own 32 blocks each
constexpr int SPLIT = 2;               // warps that share one's rows
constexpr int ROWS = 4;                // row loads a lane keeps in flight

// live rows of a block: its count, clamped to bo (rows past bo overflowed)
MZ_HD int live_rows(int32_t cnt, int bo) { return cnt < bo ? cnt : bo; }

// tiles of TPB blocks over nb blocks; tile t holds blocks
// [t * TPB, min(nb, (t + 1) * TPB))
MZ_HD int64_t tile_count(int64_t nb) { return (nb + TPB - 1) / TPB; }

// The lane of a warp's 32 blocks that holds row q of their joint range:
// the largest l with p(l) <= q, p(l) lane l's exclusive prefix of live rows
// (non-decreasing, p(0) = 0).  The largest such l has a live row at q
// whenever q is below the range's total.  *pl = p(l).  On the card p is a
// shuffle, so every lane calls it at every step.
#ifdef __CUDACC__
#pragma nv_exec_check_disable      // p is a device lambda on the card
#endif
template <class Prefix>
MZ_HD int warp_block_of(Prefix p, int q, int* pl) {
    int l = 0, at = 0;
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
        const int v = p(l + step);
        if (v <= q) {
            l += step;
            at = v;
        }
    }
    *pl = at;
    return l;
}

struct Place {
    int64_t src, dst;
};

// Row q of the warp whose first block is b0 and whose rows start at dense
// slot d0, in the block of its lane l whose exclusive prefix is pl.
MZ_HD Place place_row(int64_t b0, int l, int pl, int q, int bo, int64_t d0) {
    return Place{(b0 + l) * (int64_t)bo + (q - pl), d0 + q};
}

}  // namespace densify_place

#ifndef MZ_DENSIFY_HOST

namespace {

using namespace densify_place;

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int64_t warp_sum64(int64_t v) {
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    return v;
}

__global__ void __launch_bounds__(TPB)
densify_tiles_kernel(const int32_t* __restrict__ cnt, int64_t nb, int bo,
                     int32_t* __restrict__ agg) {
    asm volatile("griddepcontrol.launch_dependents;");
    __shared__ int s_warp[WARPS];
    const int64_t b = (int64_t)blockIdx.x * TPB + threadIdx.x;
    int v = b < nb ? live_rows(cnt[b], bo) : 0;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += s_warp[w];
        agg[blockIdx.x] = s;
    }
}

__global__ void __launch_bounds__(TPB * SPLIT)
densify_rows_kernel(const uint64_t* __restrict__ src_k,
                    const uint32_t* __restrict__ src_meta,
                    const int32_t* __restrict__ cnt,
                    const int32_t* __restrict__ agg, int64_t nb, int bo,
                    int64_t cap, int64_t ntiles, uint64_t* __restrict__ dst_k,
                    uint32_t* __restrict__ dst_meta) {
    constexpr int THREADS = TPB * SPLIT;
    __shared__ int s_warp[WARPS];
    __shared__ int64_t s_before[WARPS * SPLIT], s_total[WARPS * SPLIT];
    const int64_t t = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // warps `group` and `group + WARPS` scan the same 32 blocks and take
    // alternate rounds of their rows
    const int group = warp % WARPS, part = warp / WARPS;
    const int64_t b0 = t * TPB + group * 32;
    const int live = b0 + lane < nb ? live_rows(cnt[b0 + lane], bo) : 0;
    int incl = live;                         // the warp's inclusive scan
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int n = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += n;
    }
    const int excl = incl - live;
    const int wsum = __shfl_sync(FULL, incl, 31);
    if (part == 0 && lane == 0) s_warp[group] = wsum;

    // agg is launch 1's output
    asm volatile("griddepcontrol.wait;" ::: "memory");
    int64_t before = 0, total = 0;
    for (int64_t i = threadIdx.x; i < ntiles; i += THREADS) {
        const int64_t a = agg[i];
        total += a;
        before += i < t ? a : 0;
    }
    before = warp_sum64(before);
    total = warp_sum64(total);
    if (lane == 0) {
        s_before[warp] = before;
        s_total[warp] = total;
    }
    __syncthreads();
    int64_t d0 = 0;
    before = total = 0;
#pragma unroll
    for (int w = 0; w < WARPS * SPLIT; ++w) {
        before += s_before[w];
        total += s_total[w];
    }
#pragma unroll
    for (int w = 0; w < WARPS; ++w) d0 += w < group ? s_warp[w] : 0;
    d0 += before;

    const auto prefix = [excl](int l) { return __shfl_sync(FULL, excl, l); };
    for (int q0 = part * 32 * ROWS; q0 < wsum && d0 + q0 < cap;
         q0 += SPLIT * 32 * ROWS) {
        uint64_t k[ROWS];
        uint32_t m[ROWS];
        int64_t dst[ROWS];
        bool ok[ROWS];
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
            const int q = q0 + u * 32 + lane;
            int pl;
            const int l = warp_block_of(prefix, q, &pl);
            const Place pc = place_row(b0, l, pl, q, bo, d0);
            ok[u] = q < wsum && pc.dst < cap;
            dst[u] = pc.dst;
            if (ok[u]) {
                k[u] = __ldg(src_k + pc.src);
                if (src_meta) m[u] = __ldg(src_meta + pc.src);
            }
        }
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
            if (ok[u]) {
                dst_k[dst[u]] = k[u];
                if (dst_meta) dst_meta[dst[u]] = m[u];
            }
        }
    }

    // this thread block's share of the sentinel tail
    for (int64_t i = (total < cap ? total : cap) + t * THREADS + threadIdx.x;
         i < cap; i += (int64_t)gridDim.x * THREADS) {
        dst_k[i] = ~0ull;
        if (dst_meta) dst_meta[i] = ~0u;
    }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the first CUDA error.  src_meta / dst_meta may
// both be null (k-mers only); agg is int32 scratch of ceil(nb / 256).
int mz_densify(const void* src_k, const void* src_meta, const void* cnt,
               void* agg, int64_t nb, int bo, int64_t cap, void* dst_k,
               void* dst_meta, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t ntiles = tile_count(nb);
    if (nb <= 0 || bo <= 0 || cap < 0) return (int)cudaErrorInvalidValue;
    densify_tiles_kernel<<<(unsigned)ntiles, TPB, 0, s>>>(
        (const int32_t*)cnt, nb, bo, (int32_t*)agg);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)ntiles);
    cfg.blockDim = dim3(TPB * SPLIT);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, densify_rows_kernel,
                             (const uint64_t*)src_k,
                             (const uint32_t*)src_meta,
                             (const int32_t*)cnt, (const int32_t*)agg, nb, bo,
                             cap, ntiles, (uint64_t*)dst_k,
                             (uint32_t*)dst_meta);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // MZ_DENSIFY_HOST
