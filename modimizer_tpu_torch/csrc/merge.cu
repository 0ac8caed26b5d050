// Per-k-mer reduction of the sharded modset merge (sm_90a).
//
// Replaces the reduction half of modimizer_tpu/parallel/sharded.py::
// sharded_merge_step (:2131-2162): a lexicographic (k-mer, rank) sort, a
// stable sort that moves the segment heads to the front, and gathers of
// each segment's first and last rows.  Contract (modimizer_tpu_torch/ops/
// merge.py::merge_reduce_ref): the m received rows (k-mer int64, depth and
// info u32 in int32, rank int64), live only and sorted by k-mer (the int64
// sentinel -1 would sort first, so the caller drops the pads before its
// sort; ranks are not sorted within a k-mer).  For each k-mer segment, p
// is its smallest-rank row (A's when both modsets hold the k-mer) and q
// its largest; with more than one row, depth = min(d_p + d_q, 0xFFFF) (u32
// add) and info = (i_p & 3) | min((i_p & 3) + (i_q & 3), 3); a single row
// keeps depth d_p and info i_p & 3 when it carries B's marker (bit 8),
// else i_p & 0xFF (modset.c:106-128); rank = rank_p.  Head h (in k-mer
// order) lands in slot h of the [out_len] outputs, slots from n_heads on
// are pads (k-mer and rank -1, depth and info 0), and n_heads is written.
//
// What bounds it on this card: bytes, 24 B a row read (the k-mer twice: a
// row's own and its neighbour's) and 24 B a slot written; no arithmetic of
// note.  Design: a thread a row.  Pass 1 counts each block's heads
// (__syncthreads_count), pass 2 (one block) scans the counts into each
// block's first slot and n_heads, pass 3 ranks a head within its block by
// a ballot and the earlier warps' counts, walks its segment (one or two
// rows) for p and q and writes the head's slot; pass 4 pads the slots past
// n_heads.  The smaller-rank choice is made here, so the rows need one
// sort by k-mer and no lexicographic one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 512;                 // rows a block, one a thread
constexpr int WARPS = TPB / 32;
constexpr int SCAN_TPB = 1024;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
    return a < b ? a : b;
}

__device__ __forceinline__ bool is_head(const int64_t* k, int64_t j,
                                        int64_t m) {
    return j < m && (j == 0 || k[j] != k[j - 1]);
}

// Pass 1: heads in each block of TPB rows.
__global__ void __launch_bounds__(TPB)
merge_count(const int64_t* __restrict__ k, int64_t m, int* __restrict__ bcnt) {
    const int64_t j = (int64_t)blockIdx.x * TPB + threadIdx.x;
    const int c = __syncthreads_count(is_head(k, j, m));
    if (threadIdx.x == 0) bcnt[blockIdx.x] = c;
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

// Pass 2 (one block): bcnt becomes each block's first slot; n_heads.
__global__ void __launch_bounds__(SCAN_TPB)
merge_scan(int* __restrict__ bcnt, int nb, int64_t* __restrict__ n_heads) {
    __shared__ int total;
    const int64_t per = ((int64_t)nb + SCAN_TPB - 1) / SCAN_TPB;
    const int64_t lo = lmin(nb, (int64_t)threadIdx.x * per);
    const int64_t hi = lmin(nb, lo + per);
    int s = 0;
    for (int64_t j = lo; j < hi; ++j) s += bcnt[j];
    int run = block_exclusive(s, &total);
    for (int64_t j = lo; j < hi; ++j) {
        const int v = bcnt[j];
        bcnt[j] = run;
        run += v;
    }
    if (threadIdx.x == 0) *n_heads = total;
}

// Pass 3: each head reduces its segment into its slot.
__global__ void __launch_bounds__(TPB)
merge_emit(const int64_t* __restrict__ k, const uint32_t* __restrict__ d,
           const uint32_t* __restrict__ info, const int64_t* __restrict__ r,
           int64_t m, const int* __restrict__ boff, int64_t out_len,
           int64_t* __restrict__ out_k, uint32_t* __restrict__ out_d,
           uint32_t* __restrict__ out_i, int64_t* __restrict__ out_r) {
    __shared__ int wcnt[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t j = (int64_t)blockIdx.x * TPB + threadIdx.x;
    const bool head = is_head(k, j, m);
    const unsigned b = __ballot_sync(FULL, head);
    if (lane == 0) wcnt[warp] = __popc(b);
    __syncthreads();
    if (!head) return;
    int slot = boff[blockIdx.x] + __popc(b & ((1u << lane) - 1));
    for (int w = 0; w < warp; ++w) slot += wcnt[w];
    if (slot >= out_len) return;
    const int64_t key = k[j];
    int64_t p = j, q = j, e = j + 1;
    for (; e < m && k[e] == key; ++e) {
        if (r[e] < r[p]) p = e;
        if (r[e] > r[q]) q = e;
    }
    const bool both = e - j > 1;
    const uint32_t dp = d[p], ip = info[p];
    uint32_t depth, inf;
    if (both) {
        depth = min(dp + d[q], 0xFFFFu);
        inf = (ip & 3u) | min((ip & 3u) + (info[q] & 3u), 3u);
    } else {
        depth = min(dp, 0xFFFFu);
        inf = (ip >> 8) & 1u ? ip & 3u : ip & 0xFFu;
    }
    out_k[slot] = key;
    out_d[slot] = depth;
    out_i[slot] = inf;
    out_r[slot] = r[p];
}

// Pass 4: the slots from n_heads on are pads.
__global__ void merge_fill(const int64_t* __restrict__ n_heads,
                           int64_t out_len, int64_t* __restrict__ out_k,
                           uint32_t* __restrict__ out_d,
                           uint32_t* __restrict__ out_i,
                           int64_t* __restrict__ out_r) {
    for (int64_t t = *n_heads + (int64_t)blockIdx.x * blockDim.x
             + threadIdx.x; t < out_len;
         t += (int64_t)gridDim.x * blockDim.x) {
        out_k[t] = -1;
        out_d[t] = 0;
        out_i[t] = 0;
        out_r[t] = -1;
    }
}

}  // namespace

extern "C" int mz_merge_reduce(const int64_t* k, const uint32_t* d,
                               const uint32_t* info, const int64_t* r,
                               int64_t m, int64_t out_len, int nb, int* bcnt,
                               int64_t* out_k, uint32_t* out_d,
                               uint32_t* out_i, int64_t* out_r,
                               int64_t* n_heads, cudaStream_t stream) {
    if (m < 0 || m >= (1LL << 31) || out_len < 0 || nb < 1
        || (int64_t)nb * TPB < m)
        return (int)cudaErrorInvalidValue;
    merge_count<<<nb, TPB, 0, stream>>>(k, m, bcnt);
    merge_scan<<<1, SCAN_TPB, 0, stream>>>(bcnt, nb, n_heads);
    merge_emit<<<nb, TPB, 0, stream>>>(k, d, info, r, m, bcnt, out_len, out_k,
                                       out_d, out_i, out_r);
    const int fill =
        (int)lmin((out_len + 255) / 256, 132 * 8) + (out_len == 0);
    merge_fill<<<fill, 256, 0, stream>>>(n_heads, out_len, out_k, out_d,
                                         out_i, out_r);
    return (int)cudaGetLastError();
}
