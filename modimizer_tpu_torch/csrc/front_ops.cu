// The scan front's micro-ops, one per launch, over u32 [T, L, R] (sm_90a).
//
// Replaces scripts/probe_front.py's `mk` kernels (the JAX package) with
// bodies copy, static16, dyn (dynf), mul10 (muls) and iota (iotas).  Their
// (T, 16) grid revisits each output block for r = 0 .. 15, so the body runs
// 16 times per element and the result is body(x[t], r = 15).  Contract:
// modimizer_tpu_torch/ops/front_ops.py::front_ops_ref.
//
// Each element runs the body for r = 0 .. r_last and keeps the last.  Pass r
// feeds the body dep(x, y), y the previous pass's result, one instruction
// whose result is x because zero, a kernel argument, is 0: x + y * zero (an
// IMAD) or __funnelshift_l(y, x, zero) (an SHF, which returns its high word
// at shift 0).  Every pass depends on the one before, so none is folded or
// dropped, and the result is still body(x, r_last).  The dependence is not
// x ^ (y & zero): once the passes are unrolled, copy's chain of those folds
// ((x ^ (x & z)) & z = 0), which a compiler may see; a product or a funnel
// shift by an unknown has no such identity.  mul10 adds `1u | zero`, not the
// constant 1: with constant operands the compiler folds the ten multiply-adds
// into one affine map (x * a^10 + b), and the probe would time one IMAD.
// dyn's shift amount is 2r | zero, a register, so that the unrolled pass is
// still the funnel's variable shift and not a shift by an immediate.
//
// What bounds it: the copy's 16 passes are 15.7 M dependence instructions
// over [8, 128, 1024], ~0.5 us of issue on 132 SMs when they are spread over
// the two integer pipes (the IMAD pipe and the ALU pipe, 64 lanes a clock
// each), a fifth of the 2.5 us its 8.4 MB take at the HBM rate, but all of
// it exposed when every thread computes only after its loads; the other
// bodies add their own instructions, and mul10's 160 IMADs an element bound
// it.  The earlier kernel lost to x.clone() on the copy (7.06 against 6.34 us,
// NVIDIA H100 80GB HBM3, 700.00 W): r_last was a runtime trip count, so each
// thread ran four serial 16-pass loops, one per element of its uint4, each
// pass a LOP3 plus the loop's increment, compare and branch, ~260
// instructions a thread, and all of it after the loads.  The design now:
//   - r_last is a template parameter (mz_front_ops dispatches 0..15), so a
//     pass unrolls to its bare body plus the one dependence instruction, and
//     a uint4's four elements are four independent chains;
//   - the dependence goes to the pipe the body leaves idle: the IMAD for the
//     shift and add bodies, the SHF for mul10's IMADs, and for the copy two
//     of each a uint4, so both pipes issue;
//   - one uint4 a thread, and a grid of 1,024-thread blocks that covers the
//     tensor: every load is in flight at once (2,048 threads a SM), and the
//     warps whose loads have come back run their passes while the others'
//     still arrive.  Blocks of 128, 256 and 512 threads, and a grid of 4
//     blocks a SM striding with the next uint4 prefetched, measured slower
//     on the copy;
//   - iota's index needs one 64-bit division per uint4 (its four elements
//     share a row), not one per element.
// Loads and stores of a warp are coalesced (lane-consecutive 16-byte words).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op { OP_COPY, OP_STATIC16, OP_DYN, OP_MUL10, OP_IOTA };

constexpr int THREADS = 1024;
constexpr int R_MAX = 15;

template <int OP>
__device__ __forceinline__ uint32_t body(uint32_t x, int r, uint32_t idx,
                                         uint32_t zero) {
    if (OP == OP_COPY) return x;
    if (OP == OP_STATIC16) return __funnelshift_l(x, x, 14);
    if (OP == OP_DYN) {
        if (r == 0) return x;                        // dynf's guard
        const uint32_t sr = (2u * (uint32_t)r) | zero;   // r <= 15: sr <= 30
        const uint32_t sl = (32u - sr) & 31u;
        return (x << sr) | (x >> sl);
    }
    if (OP == OP_MUL10) {
        const uint32_t one = 1u | zero;
#pragma unroll
        for (int i = 0; i < 10; ++i) x = x * 0x9E3779B9u + one;
        return x;
    }
    return x + 16u * idx;
}

// x, carried one pass further: element i of a uint4 for body OP
template <int OP>
__device__ __forceinline__ uint32_t dep(uint32_t x, uint32_t y, int i,
                                        uint32_t zero) {
    if (OP == OP_MUL10 || (OP == OP_COPY && (i & 1)))
        return __funnelshift_l(y, x, zero);
    return x + y * zero;
}

// col * L + row of element e of [T, L, R]
__device__ __forceinline__ uint32_t iota_idx(int64_t e, int L, int R) {
    const int64_t rc = e / R;                   // t * L + row
    const uint32_t col = (uint32_t)(e - rc * R);
    const uint32_t row = (uint32_t)(rc % L);
    return col * (uint32_t)L + row;
}

template <int OP, int RL>
__global__ void __launch_bounds__(THREADS)
front_ops_kernel(const uint4* __restrict__ x, int64_t nv, int L, int R,
                 uint32_t zero, uint4* __restrict__ out) {
    const int64_t v = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (v >= nv) return;
    const uint4 a = __ldg(x + v);
    const uint32_t xs[4] = {a.x, a.y, a.z, a.w};
    // R is a multiple of 4: a uint4's elements are columns c .. c+3 of one
    // row
    const uint32_t i0 = OP == OP_IOTA ? iota_idx(4 * v, L, R) : 0u;
    uint32_t y[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int r = 0; r <= RL; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
            y[i] = body<OP>(dep<OP>(xs[i], y[i], i, zero), r,
                            i0 + i * (uint32_t)L, zero);
    }
    out[v] = make_uint4(y[0], y[1], y[2], y[3]);
}

// the kernel for r_last: RL walks 0 .. R_MAX at compile time
template <int OP, int RL = 0>
void launch(int r_last, const void* x, int64_t nv, int L, int R, int nblocks,
            void* out, cudaStream_t s) {
    if constexpr (RL < R_MAX) {
        if (r_last != RL) {
            launch<OP, RL + 1>(r_last, x, nv, L, R, nblocks, out, s);
            return;
        }
    }
    front_ops_kernel<OP, RL><<<nblocks, THREADS, 0, s>>>(
        (const uint4*)x, nv, L, R, 0u, (uint4*)out);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError().  n = T * L * R elements,
// R a multiple of 4; op indexes front_ops.OPS; 0 <= r_last <= 15; nblocks
// = ceil(n / 4096) thread blocks of 1,024 threads, one uint4 a thread.
int mz_front_ops(const void* x, int64_t n, int op, int L, int R, int r_last,
                 int nblocks, void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t nv = n / 4;
    if (r_last < 0 || r_last > R_MAX) return (int)cudaErrorInvalidValue;
    switch (op) {
    case OP_COPY:
        launch<OP_COPY>(r_last, x, nv, L, R, nblocks, out, s); break;
    case OP_STATIC16:
        launch<OP_STATIC16>(r_last, x, nv, L, R, nblocks, out, s); break;
    case OP_DYN:
        launch<OP_DYN>(r_last, x, nv, L, R, nblocks, out, s); break;
    case OP_MUL10:
        launch<OP_MUL10>(r_last, x, nv, L, R, nblocks, out, s); break;
    case OP_IOTA:
        launch<OP_IOTA>(r_last, x, nv, L, R, nblocks, out, s); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
