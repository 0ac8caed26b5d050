// Overlap self-join: every ordered pair of hit rows that share a copy-1 mod,
// written once each at its exact slot (sm_90a).
//
// Replaces the pair enumeration of modimizer_tpu/parallel/overlaps.py::
// _overlap_pairs_device (modasm's findOverlaps phase 1 on the device).  The
// JAX form is a TPU workaround for the lack of a vector scatter: it makes
// 1 + 2 (dmax - 1) rolled copies of every hit row (127 at dmax 64), masks
// the pairs that leave their mod's group, and sorts them all; it widens
// dmax until it covers the largest group.  Here the live pairs alone are
// written, after a count and a prefix: the same set of rows for any group
// size.
//
// Contract (modimizer_tpu_torch/parallel/overlaps.py::pair_rows_ref).  The
// n rows arrive sorted by hkey (h for a counted copy-1 row, else
// 0xFFFFFFFF = HNONE), stably, from (x, j) order: so in (h, x, j) order.  A
// group is a run of one live hkey; k = a row's rank in its group.  Row a
// is an x side when it is live and first (its read's first occurrence of
// the mod); it pairs with every row b of its group, itself included, and
// the pair's row is key (x_a << 32) | x_b, rank (j_a << 20) | k_b, agree
// st_a == st_b (1 when a = b).  Rows of x-side row a go to slots
// [base_a, base_a + g) in b order, base the exclusive prefix of the
// per-row counts cnt_a = g (0 for a row that is not an x side).
//
// Two launches; the caller computes the prefix between them (torch.cumsum)
// and reads the total, which sizes the outputs:
//   1. overlap_count_kernel, one thread per row: the group's bounds by two
//      binary searches over the sorted hkeys (no scan across blocks), k_a,
//      cnt_a, and the largest live group (a warp max, one atomicMax a warp).
//   2. overlap_emit_kernel: a warp owns 32 consecutive rows, one a lane, and
//      writes their pairs as one range, as densify.cu's rows kernel does:
//      output q of the range belongs to the lane l with the largest
//      exclusive prefix p(l) <= q (five shuffle steps), b = start_l +
//      q - p(l) and k_b = q - p(l).  Lanes take consecutive q, so the
//      stores are coalesced and b's loads are nearly so; nothing divides.
//
// What bounds it on this card: bytes.  At modasm's config-5 shape (~4.5 M
// hit rows, ~30 reads a copy-1 mod) launch 2 writes ~130 M rows of 17 B
// (int64 key, int64 rank, uint8 agree): ~2.3 GB, ~0.7 ms at 3.35 TB/s;
// launch 1 reads 9 B a row and writes 8.
//
// The slot arithmetic is in `namespace overlap_place`, which compiles as
// host code with `g++ -x c++ -DMZ_OVERLAPS_HOST` (the CPU tests replay both
// launches with it and hold the rows against pair_rows_ref).

#include <cstdint>

#ifdef MZ_OVERLAPS_HOST
#define MZ_HD inline
#else
#include <cuda_runtime.h>
#define MZ_HD __host__ __device__ __forceinline__
#endif

namespace overlap_place {

constexpr int TPB = 256;
constexpr int64_t HNONE = 0xFFFFFFFFll;   // hkey of a row in no group

// first index in [0, n) whose key is >= x (n when none)
MZ_HD int64_t lower_bound(const int64_t* h, int64_t n, int64_t x) {
    int64_t lo = 0, len = n;
    while (len > 0) {
        const int64_t half = len >> 1;
        if (h[lo + half] < x) {
            lo += half + 1;
            len -= half + 1;
        } else {
            len = half;
        }
    }
    return lo;
}

// first index in [0, n) whose key is > x (n when none)
MZ_HD int64_t upper_bound(const int64_t* h, int64_t n, int64_t x) {
    int64_t lo = 0, len = n;
    while (len > 0) {
        const int64_t half = len >> 1;
        if (h[lo + half] <= x) {
            lo += half + 1;
            len -= half + 1;
        } else {
            len = half;
        }
    }
    return lo;
}

struct Count {
    int32_t k;       // rank in the group
    int32_t cnt;     // pairs row p writes as an x side
    int32_t g;       // its live group's size, 0 outside a group
};

// Launch 1 for row p of the n sorted rows.
MZ_HD Count count_row(const int64_t* h, const uint8_t* first, int64_t n,
                      int64_t p) {
    const int64_t x = h[p];
    const int64_t s = lower_bound(h, p, x);
    const int64_t e = p + 1 + upper_bound(h + p + 1, n - p - 1, x);
    const bool live = x != HNONE;
    const int32_t g = live ? (int32_t)(e - s) : 0;
    return Count{(int32_t)(p - s), live && first[p] ? g : 0, g};
}

// The lane of a warp's 32 rows that owns output q of their joint range: the
// largest l with p(l) <= q, p(l) lane l's exclusive prefix of counts
// (non-decreasing, p(0) = 0).  *pl = p(l).  On the card p is a shuffle, so
// every lane calls it at every step.
#ifdef __CUDACC__
#pragma nv_exec_check_disable      // p is a device lambda on the card
#endif
template <class Prefix>
MZ_HD int lane_of(Prefix p, int64_t q, int64_t* pl) {
    int l = 0;
    int64_t at = 0;
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
        const int64_t v = p(l + step);
        if (v <= q) {
            l += step;
            at = v;
        }
    }
    *pl = at;
    return l;
}

struct Pair {
    int64_t key, rank;
    uint8_t agree;
};

// The row of the pair (x side a, y side b); kb = b's rank in the group.
MZ_HD Pair pair_row(int32_t xa, int32_t ja, uint8_t sa, int32_t xb,
                    uint8_t sb, int64_t kb) {
    return Pair{((int64_t)xa << 32) | (int64_t)(uint32_t)xb,
                ((int64_t)(uint32_t)ja << 20) | kb, (uint8_t)(sa == sb)};
}

}  // namespace overlap_place

#ifndef MZ_OVERLAPS_HOST

namespace {

using namespace overlap_place;

constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(TPB)
overlap_count_kernel(const int64_t* __restrict__ h,
                     const uint8_t* __restrict__ first, int64_t n,
                     int32_t* __restrict__ krank, int32_t* __restrict__ cnt,
                     unsigned* __restrict__ max_group) {
    const int64_t p = (int64_t)blockIdx.x * TPB + threadIdx.x;
    int32_t g = 0;
    if (p < n) {
        const Count c = count_row(h, first, n, p);
        krank[p] = c.k;
        cnt[p] = c.cnt;
        g = c.g;
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) g = max(g, __shfl_xor_sync(FULL, g, d));
    if ((threadIdx.x & 31) == 0 && g > 0) atomicMax(max_group, (unsigned)g);
}

__global__ void __launch_bounds__(TPB)
overlap_emit_kernel(const int32_t* __restrict__ xs,
                    const int32_t* __restrict__ js,
                    const uint8_t* __restrict__ st,
                    const int32_t* __restrict__ krank,
                    const int32_t* __restrict__ cnt,
                    const int64_t* __restrict__ incl, int64_t n,
                    int64_t* __restrict__ out_key,
                    int64_t* __restrict__ out_rank,
                    uint8_t* __restrict__ out_agree) {
    const int lane = threadIdx.x & 31;
    const int64_t a0 = ((int64_t)blockIdx.x * TPB + threadIdx.x) - lane;
    if (a0 >= n) return;                     // whole warps leave together
    const int64_t a = a0 + lane;
    int64_t c = 0, start = 0;
    int32_t xa = 0, ja = 0;
    uint8_t sa = 0;
    if (a < n) {
        c = cnt[a];
        if (c) {
            start = a - krank[a];
            xa = xs[a];
            ja = js[a];
            sa = st[a];
        }
    }
    int64_t inc = c;                         // the warp's inclusive scan
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int64_t v = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc += v;
    }
    const int64_t excl = inc - c;
    const int64_t wsum = __shfl_sync(FULL, inc, 31);
    // the range's first slot: row a0's exclusive prefix over all rows
    const int64_t d0 = __shfl_sync(FULL, lane == 0 ? incl[a0] - c : 0, 0);
    const auto prefix = [excl](int l) { return __shfl_sync(FULL, excl, l); };
    for (int64_t q0 = 0; q0 < wsum; q0 += 32) {
        const int64_t q = q0 + lane;
        int64_t pl;
        const int l = lane_of(prefix, q, &pl);
        const int64_t sb = __shfl_sync(FULL, start, l);
        const int32_t x_a = __shfl_sync(FULL, xa, l);
        const int32_t j_a = __shfl_sync(FULL, ja, l);
        const uint8_t s_a = (uint8_t)__shfl_sync(FULL, (int)sa, l);
        if (q < wsum) {
            const int64_t kb = q - pl;
            const int64_t b = sb + kb;
            const Pair r = pair_row(x_a, j_a, s_a, __ldg(xs + b),
                                    __ldg(st + b), kb);
            out_key[d0 + q] = r.key;
            out_rank[d0 + q] = r.rank;
            out_agree[d0 + q] = r.agree;
        }
    }
}

}  // namespace

extern "C" {

// Launch 1 on `stream`: h int64 [n] sorted hkeys, first uint8 [n]; writes
// krank, cnt int32 [n] and raises *max_group (uint32, zeroed by the caller)
// to the largest live group.  Returns the first CUDA error.
int mz_overlap_count(const void* h, const void* first, int64_t n,
                     void* krank, void* cnt, void* max_group, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (n + TPB - 1) / TPB;
    overlap_count_kernel<<<(unsigned)blocks, TPB, 0, (cudaStream_t)stream>>>(
        (const int64_t*)h, (const uint8_t*)first, n, (int32_t*)krank,
        (int32_t*)cnt, (unsigned*)max_group);
    return (int)cudaGetLastError();
}

// Launch 2 on `stream`: xs, js int32 [n], st uint8 [n], launch 1's krank
// and cnt, incl int64 [n] their inclusive prefix; writes the incl[n - 1]
// pair rows.  Returns the first CUDA error.
int mz_overlap_emit(const void* xs, const void* js, const void* st,
                    const void* krank, const void* cnt, const void* incl,
                    int64_t n, void* out_key, void* out_rank,
                    void* out_agree, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (n + TPB - 1) / TPB;
    overlap_emit_kernel<<<(unsigned)blocks, TPB, 0, (cudaStream_t)stream>>>(
        (const int32_t*)xs, (const int32_t*)js, (const uint8_t*)st,
        (const int32_t*)krank, (const int32_t*)cnt, (const int64_t*)incl, n,
        (int64_t*)out_key, (int64_t*)out_rank, (uint8_t*)out_agree);
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // MZ_OVERLAPS_HOST
