// The scan front's micro-ops, one per launch, over u32 [T, L, R] (sm_90a).
//
// Replaces scripts/probe_front.py's `mk` kernels (the JAX package) with
// bodies copy, static16, dyn (dynf), mul10 (muls) and iota (iotas).  Their
// (T, 16) grid revisits each output block for r = 0 .. 15, so the body runs
// 16 times per element and the result is body(x[t], r = 15).  Contract:
// modimizer_tpu_torch/ops/front_ops.py::front_ops_ref.
//
// Design: elementwise, one 16-byte load and store of 4 elements per thread,
// a grid-stride loop over blocks, the op a template argument.  Like the TPU
// grid, each element runs the body for r = 0 .. r_last, r a runtime value
// (so dyn's shift is a variable amount, guarded at r = 0 as in dynf), and
// keeps the last.  Pass r reads x ^ (y & zero), y the previous pass's
// result and zero a kernel argument that is 0: every pass depends on the
// one before, so none is folded or dropped, and the result is still
// body(x, r_last).  The fold costs one LOP3 per pass.  mul10 adds
// `1u | zero`, not the constant 1: with constant operands the compiler
// folds the ten multiply-adds into one affine map (x * a^10 + b), and the
// probe would time one IMAD.  iota's index is loop-invariant and computed
// once per element.  What bounds it: memory (8 B per element moved) for the
// cheap bodies; mul10's 160 dependent IMADs per element can exceed it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op { OP_COPY, OP_STATIC16, OP_DYN, OP_MUL10, OP_IOTA };

template <int OP>
__device__ __forceinline__ uint32_t body(uint32_t x, int r, uint32_t idx,
                                         uint32_t one) {
    if (OP == OP_COPY) return x;
    if (OP == OP_STATIC16) return __funnelshift_l(x, x, 14);
    if (OP == OP_DYN) {
        const uint32_t sr = 2u * (uint32_t)r;        // r <= 15: sr <= 30
        const uint32_t sl = (32u - sr) & 31u;
        return r == 0 ? x : (x << sr) | (x >> sl);
    }
    if (OP == OP_MUL10) {
#pragma unroll
        for (int i = 0; i < 10; ++i) x = x * 0x9E3779B9u + one;
        return x;
    }
    return x + 16u * idx;
}

// 16 (col * L + row) / 16 of element e of [T, L, R]
__device__ __forceinline__ uint32_t iota_idx(int64_t e, int L, int R) {
    const int64_t rc = e / R;                   // t * L + row
    const uint32_t col = (uint32_t)(e - rc * R);
    const uint32_t row = (uint32_t)(rc % L);
    return col * (uint32_t)L + row;
}

template <int OP>
__device__ __forceinline__ uint32_t passes(uint32_t x, int64_t e, int L,
                                           int R, int r_last, uint32_t zero) {
    const uint32_t idx = OP == OP_IOTA ? iota_idx(e, L, R) : 0u;
    const uint32_t one = 1u | zero;
    uint32_t y = 0;
    for (int r = 0; r <= r_last; ++r)
        y = body<OP>(x ^ (y & zero), r, idx, one);
    return y;
}

template <int OP>
__global__ void front_ops_kernel(const uint4* __restrict__ x, int64_t nv,
                                 int L, int R, int r_last, uint32_t zero,
                                 uint4* __restrict__ out) {
    for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nv;
         v += (int64_t)gridDim.x * blockDim.x) {
        const uint4 a = x[v];
        const int64_t e = 4 * v;
        out[v] = make_uint4(passes<OP>(a.x, e, L, R, r_last, zero),
                            passes<OP>(a.y, e + 1, L, R, r_last, zero),
                            passes<OP>(a.z, e + 2, L, R, r_last, zero),
                            passes<OP>(a.w, e + 3, L, R, r_last, zero));
    }
}

template <int OP>
void launch(const void* x, int64_t nv, int L, int R, int r_last, int nblocks,
            void* out, cudaStream_t s) {
    front_ops_kernel<OP><<<nblocks, 256, 0, s>>>((const uint4*)x, nv, L, R,
                                                  r_last, 0u, (uint4*)out);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError().  n = T * L * R elements,
// R a multiple of 4; op indexes front_ops.OPS; 0 <= r_last <= 15.
int mz_front_ops(const void* x, int64_t n, int op, int L, int R, int r_last,
                 int nblocks, void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t nv = n / 4;
    if (r_last < 0 || r_last > 15) return (int)cudaErrorInvalidValue;
    switch (op) {
    case OP_COPY:
        launch<OP_COPY>(x, nv, L, R, r_last, nblocks, out, s); break;
    case OP_STATIC16:
        launch<OP_STATIC16>(x, nv, L, R, r_last, nblocks, out, s); break;
    case OP_DYN:
        launch<OP_DYN>(x, nv, L, R, r_last, nblocks, out, s); break;
    case OP_MUL10:
        launch<OP_MUL10>(x, nv, L, R, r_last, nblocks, out, s); break;
    case OP_IOTA:
        launch<OP_IOTA>(x, nv, L, R, r_last, nblocks, out, s); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
