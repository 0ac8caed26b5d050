// Sorted-table lookup: for each query k-mer, the value of the equal key in
// an ascending key column, or 0 where no key equals it (sm_90a).
//
// Replaces modimizer_tpu/parallel/lookup.py::_find_sorted_local, the XLA
// program of modmap -q's seeding on one device (jnp.searchsorted, a clamp,
// a gather, an equality test, jnp.where).  Contract
// (modimizer_tpu_torch/parallel/lookup.py::find_sorted_ref): keys are the
// table's n live rows as int64 in ascending int64 order (no sentinel pad:
// the JAX table's all-ones pad would be -1 here and sort first), vals the
// u32 ids in int32, queries any u64 in int64; out[i] = vals[p] when
// keys[p] == q[i] for p = the lower bound of q[i], else 0.  An all-ones
// query is -1 in int64: it is below every live k-mer (< 2^62) and answers
// 0; an empty table answers 0 everywhere.
//
// What bounds it on this card: the bytes are small (the keys read once, 8 B
// a query in and 4 B out), but each query walks ceil(log2 n) dependent
// loads.  At modmap's config-3 shape (~2.1 M keys, 17 MB, which fits the
// 50 MB L2; ~1 M queries) that is 21 steps of L1/L2 latency a thread, so
// the latency of the search chain, not the bytes, is expected to set the
// time.
//
// Design: one thread per query runs a branchless lower bound (the step
// `base += keys[base + half - 1] < x ? half : 0` compiles to a select, so
// the threads of a warp never diverge), then one compare and one gather.
// One launch; no temporaries.  The caller allocates the output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 256;

__global__ void __launch_bounds__(TPB)
find_sorted_kernel(const int64_t* __restrict__ keys,
                   const int32_t* __restrict__ vals, int64_t n,
                   const int64_t* __restrict__ q, int64_t nq,
                   int32_t* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * TPB + threadIdx.x;
    if (i >= nq) return;
    const int64_t x = __ldg(q + i);
    int32_t v = 0;
    if (n > 0) {
        // lower bound: the answer lies in [base, base + len]
        int64_t base = 0, len = n;
        while (len > 1) {
            const int64_t half = len >> 1;
            base += __ldg(keys + base + half - 1) < x ? half : 0;
            len -= half;
        }
        const int64_t k = __ldg(keys + base);
        base += k < x;
        if (base < n && __ldg(keys + base) == x) v = __ldg(vals + base);
    }
    out[i] = v;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the first CUDA error.  keys int64 [n]
// ascending, vals int32 [n], q int64 [nq], out int32 [nq].
int mz_find_sorted(const void* keys, const void* vals, int64_t n,
                   const void* q, int64_t nq, void* out, void* stream) {
    if (n < 0 || nq <= 0) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (nq + TPB - 1) / TPB;
    find_sorted_kernel<<<(unsigned)blocks, TPB, 0, (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const int32_t*)vals, n, (const int64_t*)q, nq,
        (int32_t*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
