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
//   Compaction block b = blk consecutive positions.  A row's rank is the
//   number of emits before it in its block (stream order).  Rank < bo goes to
//   slot b*bo + rank of out_k (u64) and out_meta (u32: p, or (p<<1)|isF;
//   out_meta may be null: the k-mers-only call stores no meta); the other
//   slots get all-ones sentinels.  cnt[b] is the full count,
//   *n_emit += sum(cnt), *overflow = any(cnt > bo).
//
// Design.  The TPU versions build ranks from triangular matmuls and move rows
// with one-hot MXU cubes or roll butterflies because the TPU has no vector
// scatter.  Here one thread owns one 64-bit word of the stream, i.e. 32
// positions, and a compaction block is G = blk/32 consecutive threads:
//   - the thread loads sw[i], sw[i+1] and its 32 validity bits once, splits
//     them into u32 words and reverse-complements them once;
//   - it walks its 32 positions unrolled: each k-mer is one 32-bit funnel
//     shift a strand for k <= 16 (two for 16 < k), the hash for k <= 16 is
//     umulhi(x, f_lo) + x * f_hi (the top 32 bits of x * factor1 when
//     x < 2^32) shifted once for both strands, and the emit test is
//     division-free: rotr(h * minv, rot) <= limit with constants the host
//     derives from w (ops/packed.emit_test);
//   - its emits are a 32-bit mask; the in-block exclusive scan of the
//     per-thread counts is log2(G) __shfl_up_sync steps with no shared
//     memory for blk <= 1024, plus one shared-memory step over warp totals
//     above that;
//   - it stores its rows in stream order by walking the mask with __ffs,
//     recomputing the k-mer and strand of each emitted position only, and
//     the group fills the sentinel slots together.
//
// What bounds it on this card: integer issue.  The bytes are ~2.1 B a
// position at w = 16 (0.375 B of bases and validity in, 12 B a row slot
// out, 8 B without meta, bo/blk slots a position); the work is ~15 integer instructions a
// position for k <= 16 and about twice that for the 64-bit path, and the
// SM's integer pipes take 64 a clock.  Without its row stores (a w that
// never emits: probe_scan_compact's "noemit" shape) the scan takes ~70 % of
// the k16 w16 time on an H100.
//
// The block's emit total goes to n_emit by one atomic per thread block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

struct Params {
    uint64_t factor1;
    uint64_t minv, limit;    // the emit test: rotr(h * minv, rot) <= limit
    int64_t nwords;          // C / 32: one thread each
    int k, rot, gshift;      // gshift = log2(blk / 32)
    int bo, meta_isf;
};

// The packed word pair sw[i], sw[i+1] as u32: a = the forward stream, most
// significant first; b = its reverse complement, least significant first
// (b[j] = ~grev32(a[j]), the words of tw = ~grev64(sw)).
struct Words {
    uint32_t a0, a1, a2, a3;
    uint32_t b0, b1, b2, b3;
};

__device__ __forceinline__ uint32_t rc32(uint32_t x) {
    // complement of x with its 16 2-bit groups reversed
    x = __brev(x);
    return ~(((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1));
}

__device__ __forceinline__ Words split(uint64_t w0, uint64_t w1) {
    Words W;
    W.a0 = (uint32_t)(w0 >> 32);
    W.a1 = (uint32_t)w0;
    W.a2 = (uint32_t)(w1 >> 32);
    W.a3 = (uint32_t)w1;
    W.b0 = rc32(W.a0);
    W.b1 = rc32(W.a1);
    W.b2 = rc32(W.a2);
    W.b3 = rc32(W.a3);
    return W;
}

// k <= 16: forward and reverse-complement k-mers at position r of the word
// (sh = 32 - 2k, mask = 4^k - 1).
__device__ __forceinline__ void kmers32(const Words& W, int r, int sh,
                                        uint32_t mask, uint32_t& f,
                                        uint32_t& c) {
    const int s = (2 * r) & 31;
    const bool lo = r < 16;
    f = __funnelshift_l(lo ? W.a1 : W.a2, lo ? W.a0 : W.a1, s) >> sh;
    c = __funnelshift_r(lo ? W.b0 : W.b1, lo ? W.b1 : W.b2, s) & mask;
}

// 16 < k <= 31 (sh = 64 - 2k, mask_hi = the k-mer bits above bit 31).
__device__ __forceinline__ void kmers64(const Words& W, int r, int sh,
                                        uint32_t mask_hi, uint64_t& f,
                                        uint64_t& c) {
    const int s = (2 * r) & 31;
    const bool lo = r < 16;
    const uint32_t p0 = lo ? W.a0 : W.a1, p1 = lo ? W.a1 : W.a2,
                   p2 = lo ? W.a2 : W.a3;
    f = (((uint64_t)__funnelshift_l(p1, p0, s) << 32)
         | __funnelshift_l(p2, p1, s)) >> sh;
    const uint32_t q0 = lo ? W.b0 : W.b1, q1 = lo ? W.b1 : W.b2,
                   q2 = lo ? W.b2 : W.b3;
    c = ((uint64_t)(__funnelshift_r(q1, q2, s) & mask_hi) << 32)
        | __funnelshift_r(q0, q1, s);
}

// The top 32 bits of x * factor1 mod 2^64 for x < 2^32; the hash is that
// >> sh.  The canonical hash is min(top32(f), top32(c)) >> sh: the shift
// keeps the order, so it runs once, after the min.
__device__ __forceinline__ uint32_t top32(uint32_t x, uint32_t flo,
                                          uint32_t fhi) {
    return __umulhi(x, flo) + x * fhi;
}

template <bool K32, int THREADS>
__global__ void __launch_bounds__(THREADS)
scan_compact_kernel(const uint64_t* __restrict__ sw,
                    const uint32_t* __restrict__ vbits, const Params P,
                    uint64_t* __restrict__ out_k,
                    uint32_t* __restrict__ out_meta,
                    int32_t* __restrict__ cnt,
                    unsigned long long* __restrict__ n_emit,
                    uint8_t* __restrict__ overflow) {
    __shared__ int warp_sum[THREADS / 32];
    __shared__ unsigned block_sum;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int64_t i = (int64_t)blockIdx.x * THREADS + tid;  // word index
    const bool live = i < P.nwords;  // whole compaction blocks are live
    if (tid == 0) block_sum = 0;

    uint64_t w0 = 0, w1 = 0;
    uint32_t valid = 0;
    if (live) {
        w0 = sw[i];
        w1 = sw[i + 1];
        valid = vbits[i];
    }
    const Words W = split(w0, w1);
    const int sh = (K32 ? 32 : 64) - 2 * P.k;
    // the k-mer's bits in its (top) u32: 4^k - 1, or 4^(k-16) - 1 above
    const uint32_t mask = FULL >> sh;
    const uint32_t flo = (uint32_t)P.factor1;
    const uint32_t fhi = (uint32_t)(P.factor1 >> 32);

    uint32_t em = 0;
    if constexpr (K32) {
        const uint32_t minv = (uint32_t)P.minv, limit = (uint32_t)P.limit;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
            uint32_t f, c;
            kmers32(W, r, sh, mask, f, c);
            const uint32_t h = min(top32(f, flo, fhi), top32(c, flo, fhi))
                               >> sh;
            const uint32_t t = h * minv;
            em |= (uint32_t)(__funnelshift_r(t, t, P.rot) <= limit) << r;
        }
    } else {
        const int rl = (64 - P.rot) & 63;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
            uint64_t f, c;
            kmers64(W, r, sh, mask, f, c);
            const uint64_t pf = f * P.factor1, pc = c * P.factor1;
            const uint64_t t = ((pf < pc ? pf : pc) >> sh) * P.minv;
            em |= (uint32_t)(((t >> P.rot) | (t << rl)) <= P.limit) << r;
        }
    }
    em &= valid;

    // exclusive rank of this thread's first row in its compaction block
    const int G = 1 << P.gshift;
    const int seg = G < 32 ? G : 32;
    const int e = __popc(em);
    int x = e;
    for (int d = 1; d < seg; d <<= 1) {
        const int y = __shfl_up_sync(FULL, x, d, seg);
        if ((lane & (seg - 1)) >= d) x += y;
    }
    int before = x - e;
    int total = __shfl_sync(FULL, x, seg - 1, seg);
    const int wsum = __reduce_add_sync(FULL, e);
    if (G > 32) {  // the block spans G/32 warps: join their totals
        if (lane == 31) warp_sum[warp] = x;
        __syncthreads();
        const int g0 = warp & ~((G >> 5) - 1);
        total = 0;
        for (int j = g0; j < g0 + (G >> 5); ++j) {
            const int c = warp_sum[j];
            before += j < warp ? c : 0;
            total += c;
        }
    }
    __syncthreads();  // block_sum is zeroed
    if (lane == 0 && wsum) atomicAdd(&block_sum, (unsigned)wsum);

    if (live) {
        const int64_t b = i >> P.gshift;
        const int q = (int)(i & (G - 1));
        uint64_t* ok = out_k + b * P.bo;
        uint32_t* om = out_meta ? out_meta + b * P.bo : nullptr;
        int rank = before;
        for (uint32_t m = em; m && rank < P.bo; m &= m - 1, ++rank) {
            const int r = __ffs(m) - 1;
            uint64_t kmer;
            bool isF;
            if constexpr (K32) {
                uint32_t f, c;
                kmers32(W, r, sh, mask, f, c);
                isF = top32(f, flo, fhi) >> sh < top32(c, flo, fhi) >> sh;
                kmer = isF ? f : c;
            } else {
                uint64_t f, c;
                kmers64(W, r, sh, mask, f, c);
                isF = (f * P.factor1) >> sh < (c * P.factor1) >> sh;
                kmer = isF ? f : c;
            }
            const uint32_t p = (uint32_t)(i * 32 + r);
            ok[rank] = kmer;
            if (om) om[rank] = P.meta_isf ? (p << 1) | (uint32_t)isF : p;
        }
        for (int j = total + q; j < P.bo; j += G) {
            ok[j] = ~0ull;
            if (om) om[j] = FULL;
        }
        if (q == 0) {
            cnt[b] = total;
            if (total > P.bo) *overflow = 1;
        }
    }
    __syncthreads();
    if (tid == 0 && block_sum)
        atomicAdd(n_emit, (unsigned long long)block_sum);
}

template <bool K32>
void launch(const uint64_t* sw, const uint32_t* vbits, const Params& P,
            int G, uint64_t* out_k, uint32_t* out_meta, int32_t* cnt,
            unsigned long long* n_emit, uint8_t* overflow,
            cudaStream_t stream) {
    if (G <= 256) {
        const unsigned grid = (unsigned)((P.nwords + 255) / 256);
        scan_compact_kernel<K32, 256><<<grid, 256, 0, stream>>>(
            sw, vbits, P, out_k, out_meta, cnt, n_emit, overflow);
    } else {
        const unsigned grid = (unsigned)((P.nwords + 1023) / 1024);
        scan_compact_kernel<K32, 1024><<<grid, 1024, 0, stream>>>(
            sw, vbits, P, out_k, out_meta, cnt, n_emit, overflow);
    }
}

}  // namespace

extern "C" {

const char* mz_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`; returns cudaGetLastError().  n_emit and overflow must
// be zeroed by the caller.  blk is a power of two in [128, 32768] and C a
// multiple of it; (minv, rot, limit) test divisibility by w of 32-bit hashes
// for k <= 16 and of 64-bit hashes above (ops/packed.emit_test).
int mz_scan_compact(const void* sw, const void* vbits, int64_t C, int k,
                    uint64_t factor1, uint64_t minv, int rot, uint64_t limit,
                    int blk, int bo, int meta_isf, void* out_k,
                    void* out_meta, void* cnt, void* n_emit, void* overflow,
                    void* stream) {
    const int G = blk / 32;
    Params P;
    P.factor1 = factor1;
    P.minv = minv;
    P.limit = limit;
    P.nwords = C / 32;
    P.k = k;
    P.rot = rot;
    P.gshift = __builtin_ctz((unsigned)G);
    P.bo = bo;
    P.meta_isf = meta_isf;
    const uint64_t* s = (const uint64_t*)sw;
    const uint32_t* v = (const uint32_t*)vbits;
    auto* ok = (uint64_t*)out_k;
    auto* om = (uint32_t*)out_meta;
    auto* c = (int32_t*)cnt;
    auto* n = (unsigned long long*)n_emit;
    auto* o = (uint8_t*)overflow;
    if (k <= 16)
        launch<true>(s, v, P, G, ok, om, c, n, o, (cudaStream_t)stream);
    else
        launch<false>(s, v, P, G, ok, om, c, n, o, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

}  // extern "C"
