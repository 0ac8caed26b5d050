// The all-window minimizer pass over one chunk of hash positions (sm_90a).
//
// Replaces modimizer_tpu/ops/minimizer.py::_minimizer_chunk (:135-159),
// an XLA program.  Contract (modimizer_tpu_torch/ops/minimizer.py::
// minimizer_chunk_ref), for the C positions p of a chunk (C a multiple of
// 32, sw holding C/32 + 1 big-endian-per-word packed words):
//   fwd, rc, hf, hr, isF and the canonical hash as in scan_compact.cu;
//   hh[p]  = hash[p] for p < m_ext, else a pad above every hash (the
//            plain version's INT64_MAX, JAX's all-ones u64, PAD below);
//   A[s]   = min(hh[s .. s+w-1]), positions at or past C reading PAD;
//   valid  = s + base < n_win (a full window of the whole sequence);
//   M[p]   = max over valid s in [p-w+1, p] of A[s] (0 where none);
//   emit   = M[p] == hh[p] and p < m_ext and some valid s covers p.
// Outputs: hash[C] (int64, the unpadded canonical hash), isF[C] and
// emit[C] (bytes).  Hashes are below 2^62 (k <= 31), so int64 order is
// their u64 order.
//
// Window passes (van Herk / Gil-Werman): cut the positions into segments
// of w, anchored at 0.  With P the prefix minima and S the suffix minima
// within each segment, A[s] = min(S[s], P[s+w-1]): the window spans one
// segment's tail and the next one's head.  M[p] = max(S'[p-w+1], P'[p])
// the same way over the masked minima.  Four segmented scans a pass pair,
// a constant number of operations a position whatever w is.
//
// Tile path (w <= W_TILE = 1024): a block of 256 threads holds SLOTS =
// 4,096 consecutive positions, R = 16 a thread in registers: T outputs
// (T = the multiple of 16 at or below SLOTS - HL - (w-1), 2,048 at w =
// 1024, 4,032 at w = 31), a left halo HL = w-1 rounded up to 16 and a
// right halo of w-1.  Each position is hashed once; its hash stays in its
// thread's registers until the emit test.  A thread's 16 positions share
// two packed words (the first is a multiple of 16), shifted once so that
// the run starts at bit 63 and every per-position shift is by a
// constant.  The scans run in registers, two at a time (P with S, then P'
// with S'): a thread's run, then a segmented scan of the threads' carries
// by warp shuffles and the 8 warps' carries from shared memory.  Shared
// memory carries the hashes to their coalesced store (8 B a thread, a
// warp's 256 B contiguous: 16-byte stores of a thread's 128 B took four
// times as long, PERF.md) and what crosses threads at distance w-1: P (for
// A[s] = min(S[s], P[s+w-1])) and S' (for M[p] = max(S'[p-w+1], P'[p])),
// each stored once and loaded once: 48 B a position and 7 barriers a
// tile, whatever w is.  The array is padded one word in R, so that a
// warp's 64-bit accesses at a stride of R positions hit every bank once.
// isF and emit go out as one 16-byte store a thread each.
//
// Wide path (w > W_TILE): blocks of SLOTS positions from 0, segments of w
// from 0, so that a segment spans blocks; three launches of ceil(C /
// SLOTS) blocks whatever w is, each block scanning its positions in
// registers as a tile does (seg_scan2).  A block's carry from the blocks
// before it in a segment (forward) or after it (backward) is the op of
// their aggregates (a block's prefix at its last position, its suffix at
// its first), a range of at most w / SLOTS + 1 values that the block
// reduces itself.  (1) the hashes and strands out, P and S of hh and
// their aggregates; (2) A[s] = min(S[s], P[s+w-1]) with their carries,
// masked, then P' and S' (S' over S) and their aggregates; (3) M[p] =
// max(S'[p-w+1], P'[p]) with theirs, the emit test against the stored
// hashes.  Device memory a position: 8 B of hash, 1 B of strand, 16 B of
// P and S out (1); 16 B in, 16 B out (2); 24 B in, 1 B out (3), whatever
// w is, and 24 B of aggregates a block a launch per SLOTS of w (from
// L2).  Scratch: 3C + 4 ceil(C / SLOTS) int64.
//
// What bounds it on this card: bytes for the tile path (C/4 bytes of
// bases in, 10 B a position out) against integer issue (INT32 at half the
// FP32 rate): two 64-bit multiplies and the shifts of the hash a position,
// the scans' selects, the halo share (HL + w-1) / SLOTS of positions
// hashed twice by neighbouring tiles (1.5 % at w = 31, 15 % at w = 300,
// 50 % at w = 1024).  More warps an SM (512 threads of 8 positions, or
// three blocks at 85 registers) did not help: the kernel is issue bound,
// not latency bound (PERF.md).  The wide path's bytes (82 B a position)
// would take 0.10 ms on a 2^22 chunk; it takes 0.25 ms at any w from 1100
// to 2^16, its launches' barriers and scans besides the bytes: neither
// 64-bit divisions a position (7 %) nor loads waited on one at a time
// (2 %) were the difference (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int R = 16;                   // positions a thread (8 or 16)
constexpr int SLOTS = THREADS * R;      // positions a tile holds
constexpr int BLOCKS = 2;               // blocks an SM, by registers
constexpr int W_TILE = 1024;            // widest w on the tile path
// The pad inside the kernel: the bit pattern of +Inf as a double, above
// every hash (below 2^62).  Non-negative int64 bit patterns order as the
// doubles they encode, and none below 2^62 is a NaN or an infinity, so the
// window passes take 64-bit minima and maxima on the FP64 pipe, one
// DMNMX each, and leave the integer pipe to the hashing.
constexpr int64_t PAD = 0x7FF0000000000000LL;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
    int64_t C, m_ext, n_win, base;
    uint64_t factor1;
    int k, w;
    int T, HL;                          // tile path: outputs, left halo
};

// complement of x with its 32 2-bit groups reversed (tw = ~grev64(sw))
__device__ __forceinline__ uint64_t rc64(uint64_t x) {
    x = __brevll(x);
    return ~(((x >> 1) & 0x5555555555555555ull)
             | ((x & 0x5555555555555555ull) << 1));
}

// Canonical hash and strand at bit offset r2 (2 * (q & 31)) of the word
// pair (w0, w1) and their reverse complements (t0, t1).
__device__ __forceinline__ int64_t hash_of(uint64_t w0, uint64_t w1,
                                           uint64_t t0, uint64_t t1, int r2,
                                           const Params& P, bool& isF) {
    const uint64_t hs = r2 ? (w0 << r2) | (w1 >> (64 - r2)) : w0;
    const uint64_t ht = r2 ? (t0 >> r2) | (t1 << (64 - r2)) : t0;
    const int sh = 64 - 2 * P.k;
    const uint64_t f = hs >> sh;
    const uint64_t c = ht & ((1ull << (2 * P.k)) - 1);
    const uint64_t hf = (f * P.factor1) >> sh, hr = (c * P.factor1) >> sh;
    isF = hf < hr;
    return (int64_t)(isF ? hf : hr);
}

template <bool MIN>
__device__ __forceinline__ int64_t op(int64_t a, int64_t b) {
    const double x = __longlong_as_double(a), y = __longlong_as_double(b);
    return __double_as_longlong(MIN ? fmin(x, y) : fmax(x, y));
}

template <bool MIN>
__device__ __forceinline__ int64_t ident() { return MIN ? PAD : 0; }

// the padded shared index: one word in R skipped, so that a warp's 64-bit
// accesses at a stride of R positions hit every bank once
__device__ __forceinline__ int padR(int j) { return j + j / R; }

// R bytes of a run (0 or 1 each, byte r of word r / 4) to dst, 4 B or more
// a store
__device__ __forceinline__ void store_run_bytes(uint8_t* dst,
                                                const uint32_t (&b)[R / 4]) {
    if constexpr (R == 16)
        *reinterpret_cast<uint4*>(dst) = make_uint4(b[0], b[1], b[2], b[3]);
    else if constexpr (R == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(b[0], b[1]);
    else
        for (int i = 0; i < R / 4; ++i)
            reinterpret_cast<uint32_t*>(dst)[i] = b[i];
}

// The R positions from q0 (a multiple of R; the run lies in [0, C)):
// each hash to xs[padR(j0 + r)] and to hh[r] where live (r < n_live;
// PAD elsewhere), each strand to byte r of fw.  The words from q0
// on: the run's R positions and their k-mers lie in the top 2 (R + 30)
// bits of (w0, w1) shifted by rb (at most 64 - 2R), so every shift below
// is by a constant (the bits of the word after w1, past them, are not
// needed).
__device__ __forceinline__ void hash_run(const uint64_t* __restrict__ sw,
                                         int64_t q0, int j0, int n_live,
                                         const Params& P, int64_t* xs,
                                         int64_t (&hh)[R],
                                         uint32_t (&fw)[R / 4]) {
    uint64_t w0 = sw[q0 >> 5], w1 = sw[(q0 >> 5) + 1];
    const int rb = 2 * (int)(q0 & 31);
    if (rb) {
        w0 = (w0 << rb) | (w1 >> (64 - rb));
        w1 <<= rb;
    }
    const uint64_t t0 = rc64(w0), t1 = rc64(w1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
        bool f;
        const int64_t x = hash_of(w0, w1, t0, t1, 2 * r, P, f);
        xs[padR(j0 + r)] = x;
        hh[r] = r < n_live ? x : PAD;
        fw[r / 4] |= (uint32_t)f << (8 * (r % 4));
    }
}

// The segment cuts of a run of R whose first index is c0 with c0 % w ==
// c (segments of w from 0): bit r of first where (c0 + r) % w == 0, of
// last where it is w - 1.
__device__ __forceinline__ void run_cuts(int c, int w, unsigned& first,
                                         unsigned& last) {
    first = last = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        first |= (unsigned)(c == 0) << r;
        last |= (unsigned)(c == w - 1) << r;
        c = c == w - 1 ? 0 : c + 1;
    }
}

// ---------------------------------------------------------- tile path

// Two segmented scans over the tile's SLOTS positions at once, in place:
// f forward (inclusive prefix within each segment; bit r of `first` marks
// a segment's first position), g backward (suffix; bit r of `last` marks
// a segment's last).  A thread scans its runs, the warp scans the runs'
// (cut seen, value) pairs by shuffles, the block the warps' through
// shared memory; the carry joins the positions before the run's first cut
// (forward) or after its last (backward).  The two scans are independent:
// their steps interleave, and they share the shuffles' steps and the two
// barriers.
template <bool MIN>
__device__ __forceinline__ void seg_scan2(int64_t (&f)[R], unsigned first,
                                          int64_t (&g)[R], unsigned last,
                                          int64_t (*s_val)[WARPS],
                                          int (*s_cut)[WARPS]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int64_t rf = ident<MIN>(), rg = ident<MIN>();
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int b = R - 1 - i;
        rf = (first >> i & 1) ? f[i] : op<MIN>(rf, f[i]);
        f[i] = rf;
        rg = (last >> b & 1) ? g[b] : op<MIN>(rg, g[b]);
        g[b] = rg;
    }
    bool cf = first != 0, cg = last != 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int64_t of = __shfl_up_sync(FULL, rf, d);
        const int64_t og = __shfl_down_sync(FULL, rg, d);
        const bool pf = __shfl_up_sync(FULL, cf, d);
        const bool pg = __shfl_down_sync(FULL, cg, d);
        if (lane >= d) {
            if (!cf) rf = op<MIN>(rf, of);
            cf = cf || pf;
        }
        if (lane + d < 32) {
            if (!cg) rg = op<MIN>(rg, og);
            cg = cg || pg;
        }
    }
    // the lanes before this one (after it, backward), exclusive
    int64_t ef = __shfl_up_sync(FULL, rf, 1);
    int64_t eg = __shfl_down_sync(FULL, rg, 1);
    bool xf = __shfl_up_sync(FULL, cf, 1);
    bool xg = __shfl_down_sync(FULL, cg, 1);
    if (lane == 0) {
        ef = ident<MIN>();
        xf = false;
    }
    if (lane == 31) {
        eg = ident<MIN>();
        xg = false;
        s_val[0][warp] = rf;
        s_cut[0][warp] = cf;
    }
    if (lane == 0) {
        s_val[1][warp] = rg;
        s_cut[1][warp] = cg;
    }
    __syncthreads();
    if (!xf) {
        int64_t wc = ident<MIN>();
        for (int o = warp - 1; o >= 0; --o) {
            wc = op<MIN>(wc, s_val[0][o]);
            if (s_cut[0][o]) break;
        }
        ef = op<MIN>(wc, ef);
    }
    if (!xg) {
        int64_t wc = ident<MIN>();
        for (int o = warp + 1; o < WARPS; ++o) {
            wc = op<MIN>(wc, s_val[1][o]);
            if (s_cut[1][o]) break;
        }
        eg = op<MIN>(wc, eg);
    }
    // forward: the positions before the first cut; backward: after the last
    const int fe = first ? __ffs(first) - 1 : R;
    const int ge = last ? 31 - __clz(last) : -1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (r < fe) f[r] = op<MIN>(f[r], ef);
        if (r > ge) g[r] = op<MIN>(g[r], eg);
    }
    __syncthreads();                    // s_val, s_cut free again
}

__global__ void __launch_bounds__(THREADS, BLOCKS)
minimizer_tile(const uint64_t* __restrict__ sw, const Params P,
               int64_t* __restrict__ out_h, uint8_t* __restrict__ out_f,
               uint8_t* __restrict__ out_e) {
    // the hashes (for their coalesced store), then P, then S'
    __shared__ int64_t xs[SLOTS + SLOTS / R];
    __shared__ int64_t s_val[2][WARPS];
    __shared__ int s_cut[2][WARPS];
    const int h = P.w - 1;
    const int j0 = threadIdx.x * R;                  // the run's first slot
    const int64_t s0 = (int64_t)blockIdx.x * P.T - P.HL;   // slot 0's position
    const int64_t q0 = s0 + j0;                      // a multiple of R
    // q0 a multiple of R, C of 32: the run lies in [0, C) or outside it
    const bool inside = q0 >= 0 && q0 < P.C;
    const bool mine = inside && j0 >= P.HL && j0 < P.HL + P.T;
    // the run's positions r as intervals: live (q0 + r < m_ext), valid
    // starts and emit candidates (live and covered: some valid start in
    // [p - w + 1, p], i.e. p < n_win - base + w - 1 when n_win > base)
    const int64_t n_start = P.n_win - P.base;     // valid starts: [0, n)
    const int n_live = (int)max((int64_t)0, min((int64_t)R, P.m_ext - q0));
    const int v_lo = (int)min((int64_t)R, max((int64_t)0, -q0));
    const int v_hi = (int)max((int64_t)0, min((int64_t)R,
                                              min(P.C, n_start) - q0));
    const int e_hi = n_start > 0
        ? (int)max((int64_t)0, min((int64_t)n_live, n_start + h - q0)) : 0;
    int64_t hh[R];
#pragma unroll
    for (int r = 0; r < R; ++r) hh[r] = PAD;
    if (inside) {
        uint32_t fw[R / 4] = {};
        hash_run(sw, q0, j0, n_live, P, xs, hh, fw);
        if (mine) store_run_bytes(out_f + q0, fw);
    }
    __syncthreads();
    // the tile's hashes out, 8 B a thread, a warp's 256 B contiguous
    for (int i = threadIdx.x; i < P.T; i += THREADS) {
        const int64_t p = s0 + P.HL + i;
        if (p < P.C) out_h[p] = xs[padR(P.HL + i)];
    }
    // segment cuts of this run: slot j is a segment's first when j % w == 0
    // and its last when j % w == w - 1
    unsigned first, last;
    run_cuts(j0 % P.w, P.w, first, last);
    // P (prefix minima) and S (suffix minima) of hh; its barriers also
    // end the hashes' reads of xs
    int64_t t[R], u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) t[r] = u[r] = hh[r];
    seg_scan2<true>(t, first, u, last, s_val, s_cut);
#pragma unroll
    for (int r = 0; r < R; ++r) xs[padR(j0 + r)] = t[r];
    __syncthreads();
    // A[s] = min(S[s], P[s + w - 1]); the starts that are not full
    // windows count 0.  Slots past SLOTS - w start no window a tile's
    // outputs read.
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = j0 + r;
        const int64_t a = j + h < SLOTS ? op<true>(u[r], xs[padR(j + h)])
                                        : u[r];
        t[r] = u[r] = r >= v_lo && r < v_hi ? a : 0;
    }
    // P' in t, S' in u; its barriers end the reads of P
    seg_scan2<false>(t, first, u, last, s_val, s_cut);
#pragma unroll
    for (int r = 0; r < R; ++r) xs[padR(j0 + r)] = u[r];
    __syncthreads();
    if (!mine) return;
    // M[p] = max(S'[p - w + 1], P'[p]); the emit test against the hash
    // this thread holds
    uint32_t ew[R / 4] = {};
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int64_t m = op<false>(xs[padR(j0 + r - h)], t[r]);
        const bool e = r < e_hi && m == hh[r];
        ew[r / 4] |= (uint32_t)e << (8 * (r % 4));
    }
    store_run_bytes(out_e + q0, ew);
}

// ---------------------------------------------------------- wide path

// v, a run of R from slot j0 of each thread, to dst[cs + j] for the
// block's slots j with cs + j < C: 8 B a thread, a warp's 256 B
// contiguous, through xs.
__device__ __forceinline__ void store_slots(int64_t* __restrict__ dst,
                                            int64_t cs, int64_t C,
                                            const int64_t (&v)[R],
                                            int64_t* xs) {
    __syncthreads();                    // xs free
#pragma unroll
    for (int r = 0; r < R; ++r) xs[padR(threadIdx.x * R + r)] = v[r];
    __syncthreads();
    for (int i = threadIdx.x; i < SLOTS && cs + i < C; i += THREADS)
        dst[cs + i] = xs[padR(i)];
}

// xs[padR(i)] = f(i) for the block's SLOTS slots i: every load a thread
// makes is issued before its first store, so that a thread waits for
// device memory once and not once a slot.
template <class F>
__device__ __forceinline__ void stage(int64_t* xs, F f) {
    constexpr int N = SLOTS / THREADS;
    int64_t v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = f(threadIdx.x + k * THREADS);
#pragma unroll
    for (int k = 0; k < N; ++k) xs[padR(threadIdx.x + k * THREADS)] = v[k];
}

// op over a[lo .. hi] (the identity when lo > hi), reduced by the whole
// block; every thread gets it.
template <bool MIN>
__device__ __forceinline__ int64_t block_range(const int64_t* __restrict__ a,
                                               int64_t lo, int64_t hi,
                                               int64_t* s_red) {
    int64_t v = ident<MIN>();
    for (int64_t i = lo + threadIdx.x; i <= hi; i += THREADS)
        v = op<MIN>(v, a[i]);
#pragma unroll
    for (int d = 16; d; d >>= 1) v = op<MIN>(v, __shfl_xor_sync(FULL, v, d));
    __syncthreads();                    // s_red free
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = ident<MIN>();
#pragma unroll
    for (int o = 0; o < WARPS; ++o) v = op<MIN>(v, s_red[o]);
    return v;
}

// The blocks whose aggregates carry into block b: forward, from the block
// that holds the start of b's first position's segment to b - 1;
// backward, from b + 1 to the block that holds the end of b's last
// position's segment (at most the last block).
__device__ __forceinline__ int64_t carry_from(int64_t b, int w) {
    return b * SLOTS / w * w / SLOTS;
}

__device__ __forceinline__ int64_t carry_to(int64_t b, int w, int64_t nblk) {
    const int64_t e = (b * SLOTS + SLOTS - 1) / w * w + w - 1;
    return e / SLOTS < nblk - 1 ? e / SLOTS : nblk - 1;
}

// The positions of block b before fwd_end(b) (the first segment start
// in it) take its forward carry; those from bwd_begin(b) (the start of
// the segment that crosses its end, past the block when none does) its
// backward carry.  One division a block, none a position.
__device__ __forceinline__ int64_t fwd_end(int64_t b, int w) {
    return (b * SLOTS + w - 1) / w * w;
}

__device__ __forceinline__ int64_t bwd_begin(int64_t b, int w) {
    return (b + 1) * SLOTS / w * w;
}

// The wide path's scratch: P and S of the hashes (S' over S), P' of the
// masked minima, and four aggregates a block (af: its prefix at its last
// position, ab: its suffix at its first; af2, ab2 of the maxima).
struct Wide {
    int64_t *pm, *sm, *pm2, *af, *ab, *af2, *ab2;
    int64_t nblk;
};

// (1) the hashes and strands out; P and S of hh within the block, and the
// block's aggregates.
__global__ void __launch_bounds__(THREADS, BLOCKS)
minimizer_wide_scan(const uint64_t* __restrict__ sw, const Params P,
                    int64_t* __restrict__ out_h, uint8_t* __restrict__ out_f,
                    const Wide W) {
    __shared__ int64_t xs[SLOTS + SLOTS / R];
    __shared__ int64_t s_val[2][WARPS];
    __shared__ int s_cut[2][WARPS];
    const int j0 = threadIdx.x * R;
    const int64_t cs = (int64_t)blockIdx.x * SLOTS;
    const int64_t q0 = cs + j0;          // the run lies in [0, C) or past it
    const int n_live = (int)max((int64_t)0, min((int64_t)R, P.m_ext - q0));
    int64_t hh[R];
#pragma unroll
    for (int r = 0; r < R; ++r) hh[r] = PAD;
    if (q0 < P.C) {
        uint32_t fw[R / 4] = {};
        hash_run(sw, q0, j0, n_live, P, xs, hh, fw);
        store_run_bytes(out_f + q0, fw);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < SLOTS && cs + i < P.C; i += THREADS)
        out_h[cs + i] = xs[padR(i)];
    unsigned first, last;
    run_cuts((int)(q0 % P.w), P.w, first, last);
    int64_t t[R], u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) t[r] = u[r] = hh[r];
    seg_scan2<true>(t, first, u, last, s_val, s_cut);
    store_slots(W.pm, cs, P.C, t, xs);
    store_slots(W.sm, cs, P.C, u, xs);
    if (threadIdx.x == THREADS - 1) W.af[blockIdx.x] = t[R - 1];
    if (threadIdx.x == 0) W.ab[blockIdx.x] = u[0];
}

// (2) the masked minima A[s] = min(S[s], P[s + w - 1]) of the block's
// starts (0 where s starts no full window; P past C is P[C - 1] in the
// same segment, else PAD), each with its carry; P' and S' of them within
// the block (S' over S, which only this block reads), their aggregates.
__global__ void __launch_bounds__(THREADS, BLOCKS)
minimizer_wide_max(const Params P, const Wide W) {
    __shared__ int64_t xs[SLOTS + SLOTS / R];
    __shared__ int64_t s_val[2][WARPS];
    __shared__ int s_cut[2][WARPS];
    __shared__ int64_t s_red[WARPS];
    const int h = P.w - 1;
    const int j0 = threadIdx.x * R;
    const int64_t b = blockIdx.x, cs = b * SLOTS, q0 = cs + j0;
    const int64_t last_b = W.nblk - 1;
    // S's carry into this block; P's into the two blocks that hold the
    // starts' window ends (clamped to C - 1)
    const int64_t cb = block_range<true>(W.ab, b + 1,
                                         carry_to(b, P.w, W.nblk), s_red);
    const int64_t b1 = min((cs + h) / SLOTS, last_b);
    const int64_t b2 = min(b1 + 1, last_b);
    const int64_t cf1 = block_range<true>(W.af, carry_from(b1, P.w), b1 - 1,
                                          s_red);
    const int64_t cf2 = b2 == b1 ? cf1
        : block_range<true>(W.af, carry_from(b2, P.w), b2 - 1, s_red);
    const int64_t sb = bwd_begin(b, P.w);
    const int64_t fe1 = fwd_end(b1, P.w), fe2 = fwd_end(b2, P.w);
    // window ends from here on lie in a segment that starts at or past C
    const int64_t pad_from = ((P.C - 1) / P.w + 1) * P.w;
    stage(xs, [&](int i) {
        const int64_t s = cs + i;
        if (s >= P.C) return PAD;
        const int64_t v = W.sm[s];
        return s >= sb ? op<true>(v, cb) : v;
    });
    __syncthreads();
    int64_t t[R], u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = xs[padR(j0 + r)];
    __syncthreads();
    stage(xs, [&](int i) {
        const int64_t e = cs + i + h;
        const int64_t x = e < P.C ? e : P.C - 1;
        const bool in1 = x / SLOTS == b1;
        const int64_t v = W.pm[x];
        if (e >= pad_from) return PAD;
        return x < (in1 ? fe1 : fe2) ? op<true>(v, in1 ? cf1 : cf2) : v;
    });
    __syncthreads();
    const int64_t n_start = P.n_win - P.base;     // valid starts: [0, n)
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int64_t s = q0 + r;
        const int64_t a = op<true>(u[r], xs[padR(j0 + r)]);
        t[r] = u[r] = s < P.C && s < n_start ? a : 0;
    }
    unsigned first, last;
    run_cuts((int)(q0 % P.w), P.w, first, last);
    seg_scan2<false>(t, first, u, last, s_val, s_cut);
    store_slots(W.pm2, cs, P.C, t, xs);
    store_slots(W.sm, cs, P.C, u, xs);
    if (threadIdx.x == THREADS - 1) W.af2[b] = t[R - 1];
    if (threadIdx.x == 0) W.ab2[b] = u[0];
}

// (3) M[p] = max(S'[p - w + 1], P'[p]) (P'[p] alone for p < w - 1, whose
// starts from 0 lie in segment 0), each with its carry; the emit test
// against the stored hashes.
__global__ void __launch_bounds__(THREADS, BLOCKS)
minimizer_wide_emit(const int64_t* __restrict__ out_h, const Params P,
                    const Wide W, uint8_t* __restrict__ out_e) {
    __shared__ int64_t xs[SLOTS + SLOTS / R];
    __shared__ int64_t s_red[WARPS];
    const int h = P.w - 1;
    const int j0 = threadIdx.x * R;
    const int64_t b = blockIdx.x, cs = b * SLOTS, q0 = cs + j0;
    const int64_t last_b = W.nblk - 1;
    // P''s carry into this block; S''s into the two blocks that hold the
    // positions' first starts p - w + 1
    const int64_t cf = block_range<false>(W.af2, carry_from(b, P.w), b - 1,
                                          s_red);
    const int64_t b1 = min((cs - h > 0 ? cs - h : 0) / SLOTS, last_b);
    const int64_t b2 = min(b1 + 1, last_b);
    const int64_t cb1 = block_range<false>(W.ab2, b1 + 1,
                                           carry_to(b1, P.w, W.nblk), s_red);
    const int64_t cb2 = b2 == b1 ? cb1
        : block_range<false>(W.ab2, b2 + 1, carry_to(b2, P.w, W.nblk),
                             s_red);
    const int64_t pe = fwd_end(b, P.w);
    const int64_t sb1 = bwd_begin(b1, P.w), sb2 = bwd_begin(b2, P.w);
    stage(xs, [&](int i) {
        const int64_t p = cs + i;
        if (p >= P.C) return (int64_t)0;
        const int64_t v = W.pm2[p];
        return p < pe ? op<false>(v, cf) : v;
    });
    __syncthreads();
    int64_t m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = xs[padR(j0 + r)];
    __syncthreads();
    stage(xs, [&](int i) {
        const int64_t lo = cs + i - h;
        if (lo < 0 || lo >= P.C) return (int64_t)0;
        const bool in1 = lo / SLOTS == b1;
        const int64_t v = W.sm[lo];
        return lo >= (in1 ? sb1 : sb2) ? op<false>(v, in1 ? cb1 : cb2) : v;
    });
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = op<false>(m[r], xs[padR(j0 + r)]);
    __syncthreads();
    stage(xs, [&](int i) {
        return cs + i < P.C ? out_h[cs + i] : (int64_t)0;
    });
    __syncthreads();
    if (q0 >= P.C) return;
    const int64_t n_start = P.n_win - P.base;
    const int n_live = (int)max((int64_t)0, min((int64_t)R, P.m_ext - q0));
    const int e_hi = n_start > 0
        ? (int)max((int64_t)0, min((int64_t)n_live, n_start + h - q0)) : 0;
    uint32_t ew[R / 4] = {};
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const bool e = r < e_hi && m[r] == xs[padR(j0 + r)];
        ew[r / 4] |= (uint32_t)e << (8 * (r % 4));
    }
    store_run_bytes(out_e + q0, ew);
}

}  // namespace

extern "C" int mz_minimizer_tile() { return SLOTS; }
extern "C" int mz_minimizer_w_tile() { return W_TILE; }

// Launch on `stream`; returns cudaGetLastError().  C is a multiple of 32
// with C/32 + 1 words in sw; scratch holds 3C + 4 ceil(C / SLOTS) int64
// when w > W_TILE (null otherwise).
extern "C" int mz_minimizer_chunk(const uint64_t* sw, int64_t C,
                                  int64_t m_ext, int64_t n_win, int64_t base,
                                  int k, int64_t w, uint64_t factor1,
                                  int64_t* out_h, uint8_t* out_f,
                                  uint8_t* out_e, int64_t* scratch,
                                  cudaStream_t stream) {
    if (C <= 0 || C % 32 || k < 1 || k > 31 || w < 1 || w > C
        || C >= (1LL << 31) * SLOTS || (w > W_TILE && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    Params P{C, m_ext, n_win, base, factor1, k, (int)w, 0, 0};
    if (w <= W_TILE) {
        const int h = (int)w - 1;
        P.HL = (h + 15) / 16 * 16;
        P.T = (SLOTS - P.HL - h) / 16 * 16;
        const int64_t nb = (C + P.T - 1) / P.T;
        minimizer_tile<<<(unsigned)nb, THREADS, 0, stream>>>(sw, P, out_h,
                                                            out_f, out_e);
        return (int)cudaGetLastError();
    }
    const int64_t nblk = (C + SLOTS - 1) / SLOTS;
    int64_t* a = scratch + 3 * C;
    const Wide W{scratch, scratch + C, scratch + 2 * C, a, a + nblk,
                 a + 2 * nblk, a + 3 * nblk, nblk};
    minimizer_wide_scan<<<(unsigned)nblk, THREADS, 0, stream>>>(sw, P, out_h,
                                                                out_f, W);
    minimizer_wide_max<<<(unsigned)nblk, THREADS, 0, stream>>>(P, W);
    minimizer_wide_emit<<<(unsigned)nblk, THREADS, 0, stream>>>(out_h, P, W,
                                                                out_e);
    return (int)cudaGetLastError();
}
