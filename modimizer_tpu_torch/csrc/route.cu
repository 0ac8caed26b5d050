// Routing of rows to the shard that owns them, cap slots an owner (sm_90a).
//
// Replaces the pad-to-cap sort and gather of three JAX programs:
// modimizer_tpu/parallel/sharded.py::sharded_scan_route (:1692-1715),
// sharded_merge_step (:2101-2128) and parallel/lookup.py::_sharded_find
// (:136-157).  The TPU has no vector scatter, so each of them sorts the
// rows with n*cap pad rows keyed by owner and gathers each group's first
// cap rows.  Contract (modimizer_tpu_torch/ops/route.py::route_rows_ref):
// for rows i < N, owner(kmer[i]) by the mode's rule (builder and lookup:
// div_mod_owner of the canonical hash (kmer * factor1) >> shift; merge:
// of the k-mer itself); sentinel rows (-1) stay home except in lookup
// mode.  Slot o*cap + r of `index` holds owner o's r-th row in input
// order, -1 past its count; counts[o] counts all its rows, and `overflow`
// is set when one exceeds cap (rows past cap are dropped: the caller
// widens and routes again).  Builder mode also writes the routed k-mer and
// global position base + (u32)pos[i] (pads -1).
//
// What bounds it on this card: bytes.  Each row is read twice (8 B of
// k-mer in the count pass and again, with its 4 B position, in the
// scatter) and its slot written once (4 B index, 16 B of builder columns);
// a slot past an owner's count is written by the fill.  The work between
// is an owner (a multiply and a shift, a divide only for a w or n that is
// not a power of two) and a rank.
//
// Design: a warp walks a segment of SEG = 1024 consecutive rows, 32 at a
// time.  Pass 1 tallies the segment's rows per owner: __match_any_sync
// groups the lanes of one owner and the group's first lane adds the group's
// size to the warp's tally in shared memory (n ints a warp: MAX_SHARDS
// owners fill 32 KB a block).  Pass 2, one block, turns the owner-major
// tallies [n][segments] into exclusive prefix sums, each owner's count and
// the overflow flag.  Pass 3 walks the segment again: a row's rank is its
// segment's start within its owner, plus the rows of its owner already
// seen in the segment (the tally, advanced by the group's first lane after
// each step), plus its earlier lanes in the group (a popcount).  So the
// ranks follow the input order with no sort.  Pass 4 pads the slots past
// each owner's count.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SEG = 1024;            // rows a warp's segment
constexpr int WARPS = 8;             // segments a block
constexpr int TPB = 32 * WARPS;
constexpr int MAX_SHARDS = 1024;     // tallies: WARPS * 1024 * 4 B = 32 KB
constexpr int SCAN_TPB = 1024;
constexpr unsigned FULL = 0xffffffffu;

enum { BUILDER = 0, MERGE = 1, LOOKUP = 2 };

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
    return a < b ? a : b;
}

struct Owner {
    int mode;
    uint64_t factor1;
    int shift;                       // the hash's shift, 64 - 2k
    uint64_t w;
    int w_log2;                      // log2(w) for a power of two, else -1
    int n;
    bool n_pow2;
};

// The owner of a row, or -1 for a row that stays home (div_mod_owner of
// modimizer_tpu/ops/packed.py: the power-of-two shortcuts on w and n).
__device__ __forceinline__ int owner_of(int64_t kmer, const Owner& o) {
    if (o.mode != LOOKUP && kmer == -1) return -1;
    uint64_t x = (uint64_t)kmer;
    if (o.mode != MERGE) x = (x * o.factor1) >> o.shift;
    const uint64_t q = o.w_log2 >= 0 ? x >> o.w_log2 : x / o.w;
    if (o.n_pow2) return (int)((uint32_t)q & (uint32_t)(o.n - 1));
    return (int)(q % (uint64_t)o.n);
}

// Pass 1: tally[o * nseg + s] = rows of segment s that owner o takes.
__global__ void __launch_bounds__(TPB)
route_count(const int64_t* __restrict__ kmers, int64_t N, Owner o, int nseg,
            int* __restrict__ tally) {
    extern __shared__ int hist[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int seg = blockIdx.x * WARPS + warp;
    if (seg >= nseg) return;
    int* h = hist + warp * o.n;
    for (int t = lane; t < o.n; t += 32) h[t] = 0;
    __syncwarp();
    const int64_t row0 = (int64_t)seg * SEG;
    for (int s = 0; s < SEG && row0 + s < N; s += 32) {
        const int64_t i = row0 + s + lane;
        const int own = i < N ? owner_of(kmers[i], o) : -1;
        const unsigned m = __match_any_sync(FULL, own);
        if (own >= 0 && lane == __ffs(m) - 1) h[own] += __popc(m);
        __syncwarp();
    }
    for (int t = lane; t < o.n; t += 32) tally[(int64_t)t * nseg + seg] = h[t];
}

// Block-wide exclusive scan of one value a thread (SCAN_TPB threads);
// *total gets the sum.
__device__ int block_exclusive(int v, int* total) {
    __shared__ int wsum[SCAN_TPB / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
    for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc += u;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        const int x = wsum[lane];
        int y = x;
        for (int d = 1; d < 32; d <<= 1) {
            const int u = __shfl_up_sync(FULL, y, d);
            if (lane >= d) y += u;
        }
        wsum[lane] = y - x;
        if (lane == 31) *total = y;
    }
    __syncthreads();
    return wsum[warp] + inc - v;
}

// Pass 2 (one block): the tallies, owner-major, become exclusive prefix
// sums; counts[o] and the overflow flag follow.
__global__ void __launch_bounds__(SCAN_TPB)
route_scan(int* __restrict__ tally, int nseg, int n, int cap,
           int* __restrict__ counts, bool* __restrict__ overflow) {
    __shared__ int total;
    const int64_t T = (int64_t)n * nseg;
    const int64_t per = (T + SCAN_TPB - 1) / SCAN_TPB;
    const int64_t lo = lmin(T, (int64_t)threadIdx.x * per);
    const int64_t hi = lmin(T, lo + per);
    int s = 0;
    for (int64_t j = lo; j < hi; ++j) s += tally[j];
    int run = block_exclusive(s, &total);
    for (int64_t j = lo; j < hi; ++j) {
        const int v = tally[j];
        tally[j] = run;
        run += v;
    }
    __syncthreads();
    bool over = false;
    for (int t = threadIdx.x; t < n; t += SCAN_TPB) {
        const int end = t + 1 < n ? tally[(int64_t)(t + 1) * nseg] : total;
        const int c = end - tally[(int64_t)t * nseg];
        counts[t] = c;
        over |= c > cap;
    }
    over = __syncthreads_or(over);
    if (threadIdx.x == 0) *overflow = over;
}

// Pass 3: each row to its slot, in input order within its owner.
__global__ void __launch_bounds__(TPB)
route_scatter(const int64_t* __restrict__ kmers,
              const int32_t* __restrict__ pos, uint64_t base, int64_t N,
              Owner o, int nseg, int cap, const int* __restrict__ tally,
              int32_t* __restrict__ index, int64_t* __restrict__ send_k,
              int64_t* __restrict__ send_p) {
    extern __shared__ int seen[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int seg = blockIdx.x * WARPS + warp;
    if (seg >= nseg) return;
    int* f = seen + warp * o.n;
    for (int t = lane; t < o.n; t += 32)
        f[t] = tally[(int64_t)t * nseg + seg] - tally[(int64_t)t * nseg];
    __syncwarp();
    const unsigned below = (1u << lane) - 1;
    const int64_t row0 = (int64_t)seg * SEG;
    for (int s = 0; s < SEG && row0 + s < N; s += 32) {
        const int64_t i = row0 + s + lane;
        const int64_t km = i < N ? kmers[i] : -1;
        const int own = i < N ? owner_of(km, o) : -1;
        const unsigned m = __match_any_sync(FULL, own);
        const int r = own >= 0 ? f[own] + __popc(m & below) : 0;
        __syncwarp();
        if (own >= 0 && lane == __ffs(m) - 1) f[own] += __popc(m);
        __syncwarp();
        if (own >= 0 && r < cap) {
            const int64_t slot = (int64_t)own * cap + r;
            index[slot] = (int32_t)i;
            if (send_k) {
                send_k[slot] = km;
                send_p[slot] = (int64_t)(base + (uint32_t)pos[i]);
            }
        }
    }
}

// Pass 4: the slots past each owner's count are pads.
__global__ void route_fill(int n, int cap, const int* __restrict__ counts,
                           int32_t* __restrict__ index,
                           int64_t* __restrict__ send_k,
                           int64_t* __restrict__ send_p) {
    const int total = n * cap;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < total;
         j += gridDim.x * blockDim.x) {
        const int own = j / cap;
        if (j - own * cap >= counts[own]) {
            index[j] = -1;
            if (send_k) {
                send_k[j] = -1;
                send_p[j] = -1;
            }
        }
    }
}

}  // namespace

extern "C" int mz_route_rows(const int64_t* kmers, const int32_t* pos,
                             uint64_t base, int64_t N, int mode,
                             uint64_t factor1, int shift, uint64_t w, int n,
                             int cap, int nseg, int* tally, int32_t* index,
                             int* counts, bool* overflow, int64_t* send_k,
                             int64_t* send_p, cudaStream_t stream) {
    if (n < 1 || n > MAX_SHARDS || cap < 1 || (int64_t)n * cap >= (1LL << 31)
        || nseg < 1 || (int64_t)nseg * SEG < N || N >= (1LL << 31)
        || mode < BUILDER || mode > LOOKUP || w == 0
        || (mode == BUILDER) != (pos != nullptr && send_k && send_p))
        return (int)cudaErrorInvalidValue;
    Owner o;
    o.mode = mode;
    o.factor1 = factor1;
    o.shift = shift;
    o.w = w;
    o.w_log2 = (w & (w - 1)) ? -1 : __builtin_ctzll(w);
    o.n = n;
    o.n_pow2 = (n & (n - 1)) == 0;
    const int blocks = (nseg + WARPS - 1) / WARPS;
    const size_t smem = (size_t)WARPS * n * sizeof(int);
    route_count<<<blocks, TPB, smem, stream>>>(kmers, N, o, nseg, tally);
    route_scan<<<1, SCAN_TPB, 0, stream>>>(tally, nseg, n, cap, counts,
                                           overflow);
    const int total = n * cap;
    const int fill_blocks = (int)lmin((total + 255) / 256, 132 * 8);
    route_fill<<<fill_blocks, 256, 0, stream>>>(n, cap, counts, index, send_k,
                                                send_p);
    route_scatter<<<blocks, TPB, smem, stream>>>(kmers, pos, base, N, o, nseg,
                                                 cap, tally, index, send_k,
                                                 send_p);
    return (int)cudaGetLastError();
}
