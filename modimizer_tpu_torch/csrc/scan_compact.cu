// Fused modimizer scan + emit + in-block compaction for one chunk of C
// stream positions, 1 <= k <= 31 (sm_90a).
//
// Replaces, on the port's main path:
//   - modimizer_tpu/ops/scan_kernel.py::scan_compact_tiles (Pallas, k <= 16)
//   - modimizer_tpu/ops/scan_kernel_mxu.py::scan_compact_mxu (Pallas, k <= 16)
//   - modimizer_tpu/parallel/sharded.py::_scan_compact_core(posmajor=True)
//     under its default "fusedd" backend: _scan_compact_fused_pm +
//     _fused_compact_tail (k <= 16) and _scan_compact_fused_sublane64 +
//     _fused_compact_tail_u64 (16 < k), the XLA programs the JAX main path
//     runs.
//
// Contract (that of _scan_compact_core with posmajor=True):
//   position p in [0, C): i = p / 32, r = p % 32 of the big-endian-per-word
//   2-bit stream sw (C/32 + 2 words, halo included);
//     fwd = ((sw[i] << 2r) | (sw[i+1] >> (64-2r))) >> (64-2k)   (r = 0: sw[i])
//     rc  = the same funnel on tw = ~grev64(sw) the other way, & (4^k - 1)
//     hf, hr = (x * factor1 mod 2^64) >> (64-2k)               (seqhash.h:58)
//     isF = hf < hr; canonical kmer and hash follow;
//     emit = bit p of vbits AND hash % w == 0.
//   Compaction block b = BLK consecutive positions.  A row's rank is the
//   number of emits before it in its block (stream order).  Rank < bo goes to
//   slot b*bo + rank of out_k (u64) and out_meta (u32: p, or (p<<1)|isF);
//   the other slots get all-ones sentinels.  cnt[b] is the full count,
//   *n_emit += sum(cnt), *overflow = any(cnt > bo).
//
// Design.  The TPU versions build ranks from triangular matmuls and move rows
// with one-hot MXU cubes or roll butterflies because the TPU has no vector
// scatter.  Here one thread block owns one compaction block, one thread one
// position (looping when BLK > blockDim): the in-block rank is a warp ballot
// + popcount plus a shared array of warp counts, and rows are stored
// directly.  Stores land in stream order, which is what gives the .mod its
// first-encounter ids downstream.
//
// What bounds it on this card: integer ALU work.  Each position does two
// 64-bit multiplies (emulated as several 32-bit IMADs), two 64-bit funnel
// shifts, two group reversals and a 64-bit modulo by a runtime w.  Memory
// traffic is small: ~0.4 B/position in (sw is re-read by the 32 threads of a
// word, served from L1) and 12 B per emitted row out.  A u32 specialisation
// for k <= 16 and a division-free (Lemire) emit test are the next steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t grev64_2(uint64_t x) {
    // reverse the order of the 32 2-bit groups: a full bit reversal, then
    // swap the two bits inside each group back
    x = __brevll(x);
    return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

__global__ void scan_compact_kernel(const uint64_t* __restrict__ sw,
                                    const uint64_t* __restrict__ vbits,
                                    int k, uint64_t w, uint64_t factor1,
                                    int blk, int bo, int meta_isf,
                                    uint64_t* __restrict__ out_k,
                                    uint32_t* __restrict__ out_meta,
                                    int32_t* __restrict__ cnt,
                                    unsigned long long* __restrict__ n_emit,
                                    uint8_t* __restrict__ overflow) {
    __shared__ int warp_cnt[32];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const int64_t b = blockIdx.x;
    const int shift = 64 - 2 * k;
    const uint64_t mask2k = (1ull << (2 * k)) - 1ull;
    const unsigned lanes_below = (1u << lane) - 1u;
    uint64_t* ok = out_k + b * bo;
    uint32_t* om = out_meta + b * bo;

    int running = 0;  // emits in earlier tiles of this block
    for (int t0 = 0; t0 < blk; t0 += blockDim.x) {
        const int q = t0 + tid;                 // in-block position
        const int64_t p = b * blk + q;          // chunk-local position
        const int64_t i = p >> 5;
        const int r2 = 2 * (int)(p & 31);
        const uint64_t w0 = sw[i], w1 = sw[i + 1];
        const uint64_t t0w = ~grev64_2(w0), t1w = ~grev64_2(w1);
        uint64_t fwd = r2 ? (w0 << r2) | (w1 >> (64 - r2)) : w0;
        uint64_t rc = r2 ? (t0w >> r2) | (t1w << (64 - r2)) : t0w;
        fwd >>= shift;
        rc &= mask2k;
        const uint64_t hf = (fwd * factor1) >> shift;
        const uint64_t hr = (rc * factor1) >> shift;
        const bool isF = hf < hr;
        const uint64_t hash = isF ? hf : hr;
        const uint64_t kmer = isF ? fwd : rc;
        const bool valid = (vbits[p >> 6] >> (p & 63)) & 1ull;
        const bool emit = valid && (hash % w == 0);

        const unsigned ball = __ballot_sync(0xffffffffu, emit);
        if (lane == 0) warp_cnt[warp] = __popc(ball);
        __syncthreads();
        int before = 0, tile = 0;
        for (int j = 0; j < nwarps; ++j) {
            const int c = warp_cnt[j];
            before += j < warp ? c : 0;
            tile += c;
        }
        const int rank = running + before + __popc(ball & lanes_below);
        if (emit && rank < bo) {
            ok[rank] = kmer;
            om[rank] = meta_isf ? ((uint32_t)p << 1) | (isF ? 1u : 0u)
                                : (uint32_t)p;
        }
        running += tile;
        __syncthreads();  // warp_cnt is rewritten by the next tile
    }
    for (int j = tid; j < bo; j += blockDim.x) {
        if (j >= running) {
            ok[j] = ~0ull;
            om[j] = 0xFFFFFFFFu;
        }
    }
    if (tid == 0) {
        cnt[b] = running;
        if (running) atomicAdd(n_emit, (unsigned long long)running);
        if (running > bo) *overflow = 1;
    }
}

}  // namespace

extern "C" {

const char* mz_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`; returns cudaGetLastError().  n_emit and overflow must
// be zeroed by the caller.  C must be a multiple of blk; blk a power of two
// >= 32.
int mz_scan_compact(const void* sw, const void* vbits, int64_t C, int k,
                    uint64_t w, uint64_t factor1, int blk, int bo,
                    int meta_isf, void* out_k, void* out_meta, void* cnt,
                    void* n_emit, void* overflow, void* stream) {
    const int64_t nb = C / blk;
    const int threads = blk < 512 ? blk : 512;
    scan_compact_kernel<<<(unsigned)nb, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)sw, (const uint64_t*)vbits, k, w, factor1, blk, bo,
        meta_isf, (uint64_t*)out_k, (uint32_t*)out_meta, (int32_t*)cnt,
        (unsigned long long*)n_emit, (uint8_t*)overflow);
    return (int)cudaGetLastError();
}

}  // extern "C"
