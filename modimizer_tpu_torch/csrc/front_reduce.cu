// The k = 16 u32 scan front's two read-only reductions (sm_90a): the
// `noout` [8][128] sum and the `count` of emits, one launch each.
//
// Replaces probe_pallas_parts.py::kern_noout and probe_pallas_front.py::
// timing_kernel of the JAX package's scripts/.  Contract:
// modimizer_tpu_torch/ops/front_kernel.py::front_planes_ref, variants
// "noout" and "count"; this kernel's schedule, word by word, is
// front_kernel.front_reduce_lanes, which the CPU tests hold to it.  For word
// j and phase s in [0, 16), position p = 16 j + s:
//   kf = __funnelshift_l(pb[j], pa[j], 2s)
//   kr = __funnelshift_r(za[j], zb[j], 2s)
//   hf, hr = bits 32..63 of kf * factor1, kr * factor1
//   km = hf < hr ? kf : kr, emit = (min(hf, hr) & wmask) == 0
//   noout: acc[r][l] = the sum over j = l (mod 128) and s in {r, r + 8} of
//          (km & 0xFFFF) + 65536 emit;  count: the number of emits.
//
// Design.
// - Map: a persistent grid of G blocks of T = 1024 threads (G = the blocks an
//   SM holds, from cudaOccupancyMaxActiveBlocksPerMultiprocessor, times the
//   SMs: front_kernel.reduce_grid).  Thread t of block b takes the words
//   j = b T + t + i G T, i = 0, 1, ...; the stride G T is a multiple of 128,
//   so j mod 128 = t mod 128 is the thread's lane for all its words, and a
//   warp's load of one stream is 128 contiguous bytes.
// - Loads ahead of compute: a thread loads U words of all four streams
//   before its first hash (U = 4 for count, 64 B; U = 2 for noout, whose 16
//   row partials leave it 62 of the 64 registers a thread of a 1,024-thread
//   block may hold): whole batches unguarded, then the last, partial batch
//   with each word guarded.  With one block an SM that is 64 KB (count) and
//   32 KB (noout) of distinct bytes in flight an SM, over the ~25 KB that
//   Little's law asks for (3.35 TB/s x ~1 us / 132 SMs).
// - The 16 phases are unrolled, so each funnel shift has a constant count.
//   Phases s and s + 8 share row s & 7: each thread keeps 8 u32 row counts
//   of misses (positions that do not emit: a LOP3 to a predicate and a
//   predicated add, count_miss) and, for noout, 8 u32 row sums of
//   km & 0xFFFF; a row's emits are 2 x the thread's words less its misses,
//   and noout forms sum + (emits << 16) in u64 only at the fold, since the
//   sum is linear.  count selects no k-mer.
// - u32 headroom: a row sum gains at most 2 x 0xFFFF = 131,070 from one word
//   and a row count 2, so a thread may take MAX_WORDS = 32,768 words
//   (32,768 x 131,070 = 4,294,901,760 < 2^32; 32,769 words could wrap).  The
//   wrapper's grid has at least 65,536 threads, so NJ <= 2^31 words (C =
//   2^35) is safe and the wrapper raises above it; this entry refuses a grid
//   whose threads would take more than MAX_WORDS words.
// - One launch, no memset, no fence, one global add a thread (noout) or a
//   block (count): a block folds its threads' partials in shared memory
//   (noout: groups 4..7 of 128 threads store theirs, groups 0..3 add them
//   in, then thread t adds word t of the four tables: two barriers; count:
//   __reduce_add_sync in each warp, then across the warps) and adds each
//   total, with one arrival, to its word of a scratch of 1,024 u64 that the
//   wrapper allocates zeroed once per (device, stream):
//   atomicAdd(&scratch[e], 2^44 + v), the arrivals counted in bits 44..63
//   (G < 2^20), the sum below them (at most 2^42 at NJ = 2^31).
//   Ordering: the G adds to one word are atomic, so they are totally
//   ordered and the one that returns G - 1 arrivals is the last; the value
//   it returns holds the other G - 1 sums, so its thread writes the total
//   to out[e] with a plain store, and then stores 0 to the word, which no
//   other add of this launch touches any more.  The next launch on the
//   stream, which starts after this one ends, finds the scratch zero.  (A
//   ticket drawn after a __threadfence(), with the last block moving the
//   totals out, and a fold by a halving tree with 8 adds a thread of group
//   0 both measured slower: PERF.md.)
//
// What bounds it: integer issue, and the launch's fixed cost; not bytes.
// The bytes bound is 1 B read a position (16.8 MB, 0.0050 ms at 2^24 at
// 3.35 TB/s), about what any launch takes in the probes' timing.  The inner
// loop's SASS (ptxas of CUDA 12.9) is 9.7 instructions a position for count
// (2 SHF, 2 IMAD.HI, 2 IMAD, a VIMNMX, a LOP3 to a predicate, a predicated
// VIADD, the loads and the loop) and 13.4 for noout (also the compare and
// select of km, its mask and half an IADD3): at 4 issues a clock on each of
// 132 SMs at 1.98 GHz that alone is 0.0049 and 0.0067 ms at 2^24, and the
// shifts, selects and masks share the ALU pipe's half rate.  PERF.md keeps
// the measured times.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int V_NOOUT = 5, V_COUNT = 6;   // front_kernel.VARIANTS
constexpr int THREADS = 1024;
constexpr int GROUPS = THREADS / 128;     // threads of one lane in a block
constexpr int ACC = 8 * 128;              // the noout sums
constexpr long long MAX_WORDS = 32768;    // words a thread
constexpr int ARRIVALS = 44;              // scratch: arrivals << 44 | sum
constexpr long long MAX_BLOCKS = 1 << 20; // arrivals fit in 20 bits
static_assert(MAX_WORDS * 2 * 0xFFFF <= 0xFFFFFFFFll,
              "a thread's u32 row sums could wrap");
// a scratch word's sum at the largest NJ (2^31 words: 2^24 words a lane,
// two positions of at most 0xFFFF + 65536 each) stays below the arrivals
static_assert((1ll << 24) * 2 * (0xFFFF + 65536) < (1ll << ARRIVALS),
              "a scratch word's sum could reach its arrivals");
static_assert(THREADS / 32 == 32, "count folds one warp of warp sums");

__device__ __forceinline__ uint32_t hash32_hi(uint32_t a, uint32_t fl,
                                              uint32_t fh) {
    return __umulhi(a, fl) + a * fh;
}

// Adds a block's partial v, and one arrival, to scratch word e (arrivals in
// bits 44..63, the sum below them).  The add that brings the G-th arrival
// returns the other G - 1 blocks' sums: its thread writes the total to
// out[e] and leaves the word zero for the next launch.
__device__ __forceinline__ void arrive(unsigned long long* scratch,
                                       long long* out, int e,
                                       unsigned long long v, unsigned g) {
    const unsigned long long old =
        atomicAdd(scratch + e, (1ull << ARRIVALS) + v);
    if ((old >> ARRIVALS) == g - 1) {
        out[e] = (long long)((old & ((1ull << ARRIVALS) - 1)) + v);
        scratch[e] = 0ull;
    }
}

// One more miss (a position that does not emit) into n when
// (h & wmask) != 0: a LOP3 to a predicate and a predicated add.  The
// compiler's own select-and-add for `n += (h & wmask) == 0` takes 2-3
// instructions a position.
__device__ __forceinline__ void count_miss(uint32_t& n, uint32_t h,
                                           uint32_t wmask) {
    asm("{\n\t"
        ".reg .pred p;\n\t"
        ".reg .b32 t;\n\t"
        "and.b32 t, %1, %2;\n\t"
        "setp.ne.u32 p, t, 0;\n\t"
        "@p add.u32 %0, %0, 1;\n\t"
        "}" : "+r"(n) : "r"(h), "r"(wmask));
}

// The 16 positions of one word into the thread's row partials.
template <int V>
__device__ __forceinline__ void front_word(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t fl,
                                           uint32_t fh, uint32_t wmask,
                                           uint32_t (&sum)[8],
                                           uint32_t (&miss)[8]) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        uint32_t k16 = 0u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int s2 = 2 * (r + 8 * h);
            const uint32_t kf = __funnelshift_l(b, a, s2);
            const uint32_t kr = __funnelshift_r(c, d, s2);
            const uint32_t hf = hash32_hi(kf, fl, fh);
            const uint32_t hr = hash32_hi(kr, fl, fh);
            count_miss(miss[r], min(hf, hr), wmask);
            if constexpr (V == V_NOOUT) k16 += (hf < hr ? kf : kr) & 0xFFFFu;
        }
        if constexpr (V == V_NOOUT) sum[r] += k16;
    }
}

template <int V>
__global__ void __launch_bounds__(THREADS)
front_reduce_kernel(const uint32_t* __restrict__ pa,
                    const uint32_t* __restrict__ pb,
                    const uint32_t* __restrict__ za,
                    const uint32_t* __restrict__ zb, int64_t nj,
                    uint32_t fl, uint32_t fh, uint32_t wmask,
                    unsigned long long* __restrict__ scratch,
                    long long* __restrict__ out) {
    constexpr int U = V == V_NOOUT ? 2 : 4;  // words loaded before a hash
    const int tid = threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * THREADS;
    const int64_t j0 = (int64_t)blockIdx.x * THREADS + tid;
    // the words this thread takes; a row's emits are 2 nw - its misses
    const uint32_t nw = j0 < nj ? (uint32_t)((nj - 1 - j0) / stride + 1) : 0u;
    uint32_t sum[8], miss[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) sum[r] = miss[r] = 0u;

    // whole batches of U words, every load issued before the first hash;
    // then the last, partial batch with each word guarded
    int64_t j = j0;
    for (; j + (U - 1) * stride < nj; j += U * stride) {
        uint32_t a[U], b[U], c[U], d[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            a[u] = __ldg(pa + j + u * stride);
            b[u] = __ldg(pb + j + u * stride);
            c[u] = __ldg(za + j + u * stride);
            d[u] = __ldg(zb + j + u * stride);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
            front_word<V>(a[u], b[u], c[u], d[u], fl, fh, wmask, sum, miss);
    }
    if (j < nj) {
        uint32_t a[U - 1], b[U - 1], c[U - 1], d[U - 1];
#pragma unroll
        for (int u = 0; u < U - 1; ++u) {
            const int64_t ju = j + u * stride;
            a[u] = b[u] = c[u] = d[u] = 0u;
            if (ju < nj) {
                a[u] = __ldg(pa + ju);
                b[u] = __ldg(pb + ju);
                c[u] = __ldg(za + ju);
                d[u] = __ldg(zb + ju);
            }
        }
#pragma unroll
        for (int u = 0; u < U - 1; ++u)
            if (j + u * stride < nj)
                front_word<V>(a[u], b[u], c[u], d[u], fl, fh, wmask, sum,
                              miss);
    }

    if constexpr (V == V_NOOUT) {
        // thread tid holds lane tid & 127 of group tid >> 7: groups 4..7
        // hand their partials to groups 0..3, which add them; then thread
        // tid adds word tid = r * 128 + lane (r = tid >> 7) of the four
        // tables and brings it to the scratch
        static_assert(GROUPS == 8, "the fold takes 8 groups");
        __shared__ unsigned long long sh[4][8][128];
        const int lane = tid & 127, grp = tid >> 7;
        unsigned long long v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
            v[r] = sum[r] + ((unsigned long long)(2 * nw - miss[r]) << 16);
        if (grp >= 4) {
#pragma unroll
            for (int r = 0; r < 8; ++r) sh[grp - 4][r][lane] = v[r];
        }
        __syncthreads();
        if (grp < 4) {
#pragma unroll
            for (int r = 0; r < 8; ++r) sh[grp][r][lane] += v[r];
        }
        __syncthreads();
        arrive(scratch, out, tid,
               sh[0][grp][lane] + sh[1][grp][lane] + sh[2][grp][lane]
               + sh[3][grp][lane], gridDim.x);
    } else {
        __shared__ uint32_t warp_n[THREADS / 32];
        uint32_t n = 16 * nw;
#pragma unroll
        for (int r = 0; r < 8; ++r) n -= miss[r];
        // a block counts at most 1024 x 16 x MAX_WORDS = 2^29 emits
        n = __reduce_add_sync(0xFFFFFFFFu, n);
        if ((tid & 31) == 0) warp_n[tid >> 5] = n;
        __syncthreads();
        if (tid < 32) {
            n = __reduce_add_sync(0xFFFFFFFFu, warp_n[tid]);
            if (tid == 0) arrive(scratch, out, 0, n, gridDim.x);
        }
    }
}

template <int V>
cudaError_t launch(const void* pa, const void* pb, const void* za,
                   const void* zb, int64_t nj, uint64_t factor1,
                   uint32_t wmask, int nblocks, void* scratch, void* out,
                   cudaStream_t stream) {
    front_reduce_kernel<V><<<nblocks, THREADS, 0, stream>>>(
        (const uint32_t*)pa, (const uint32_t*)pb, (const uint32_t*)za,
        (const uint32_t*)zb, nj, (uint32_t)factor1, (uint32_t)(factor1 >> 32),
        wmask, (unsigned long long*)scratch, (long long*)out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The blocks of `variant` (front_kernel.VARIANTS: noout or count) that one
// SM holds at once, into *blocks; returns a cudaError_t.
int mz_front_reduce_blocks_per_sm(int variant, int* blocks) {
    if (variant == V_NOOUT)
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, front_reduce_kernel<V_NOOUT>, THREADS, 0);
    if (variant == V_COUNT)
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, front_reduce_kernel<V_COUNT>, THREADS, 0);
    return (int)cudaErrorInvalidValue;
}

// Launch on `stream`; returns cudaGetLastError().  nj >= 1 words; nblocks
// (< 2^20) blocks of 1024 threads, each thread taking at most MAX_WORDS
// words.  scratch: 1,024 u64, zero before the launch and zero after it (the
// wrapper's, one per device and stream).  out: int64 [8][128] (noout) or
// [1] (count), written with plain stores.
int mz_front_reduce(const void* pa, const void* pb, const void* za,
                    const void* zb, int64_t nj, int variant,
                    uint64_t factor1, uint32_t wmask, int nblocks,
                    void* scratch, void* out, void* stream) {
    const int64_t threads = (int64_t)nblocks * THREADS;
    if (nj < 1 || nblocks < 1 || nblocks >= MAX_BLOCKS
        || (nj + threads - 1) / threads > MAX_WORDS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (variant == V_NOOUT)
        return (int)launch<V_NOOUT>(pa, pb, za, zb, nj, factor1, wmask,
                                    nblocks, scratch, out, s);
    if (variant == V_COUNT)
        return (int)launch<V_COUNT>(pa, pb, za, zb, nj, factor1, wmask,
                                    nblocks, scratch, out, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
