// Densify: pack the live rows of sentinel-padded compaction blocks into one
// dense prefix, in order (sm_90a).
//
// Replaces modimizer_tpu/ops/device_scan.py::_densify_dispatch, whose TPU
// forms (_densify_cols_roll2 / _densify_cols conditional-roll butterflies,
// _densify_cols_search gathers) exist because the TPU has no vector scatter.
// Contract of _densify_cols_search: block b's live rows (j < min(cnt[b], bo))
// go, in order, to base[b] + j when that is below cap, where base is the
// exclusive prefix sum of min(cnt, bo) over the blocks.  The caller computes
// base (torch.cumsum) and pre-fills the outputs with sentinels, so the slots
// from the live count to cap keep them.
//
// One thread per source slot, a direct store per live row.  Bound by memory:
// one 8-byte (+4-byte meta) read per slot and one write per live row, ~C/w
// rows per chunk; the scan kernel before it dominates the step.  Fusing the
// two (a decoupled look-back over block counts) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void densify_kernel(const uint64_t* __restrict__ src_k,
                               const uint32_t* __restrict__ src_meta,
                               const int32_t* __restrict__ cnt,
                               const int64_t* __restrict__ base,
                               int64_t nb, int bo, int64_t cap,
                               uint64_t* __restrict__ dst_k,
                               uint32_t* __restrict__ dst_meta) {
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= nb * bo) return;
    const int64_t b = idx / bo;
    const int j = (int)(idx - b * bo);
    const int live = min(cnt[b], bo);
    if (j >= live) return;
    const int64_t d = base[b] + j;
    if (d >= cap) return;
    dst_k[d] = src_k[idx];
    if (src_meta) dst_meta[d] = src_meta[idx];
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError().  src_meta / dst_meta may
// both be null (kmers-only densify).
int mz_densify(const void* src_k, const void* src_meta, const void* cnt,
               const void* base, int64_t nb, int bo, int64_t cap,
               void* dst_k, void* dst_meta, void* stream) {
    const int threads = 256;
    const int64_t n = nb * bo;
    const int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 0) {
        densify_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint64_t*)src_k, (const uint32_t*)src_meta,
            (const int32_t*)cnt, (const int64_t*)base, nb, bo, cap,
            (uint64_t*)dst_k, (uint32_t*)dst_meta);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
