// Colinear chaining of modmap -q's seeds, one read a thread (sm_90a).
//
// Replaces modimizer_tpu/parallel/chain.py::chain_scan (:39-133), an XLA
// program: the reference automaton (queryProcess, modmap.c:216-280) run by
// every read in lockstep over a padded seed axis, then the M records
// compacted per read into `cap` slots by an int8 one-hot contraction (the
// TPU has no scatter).  Contract (modimizer_tpu_torch/parallel/chain.py::
// chain_scan_ref), per read over its seeds t in order (t counts dead seeds
// too):
//   a seed has its first and second occurrences la, lb and their sequence
//   ids ia, ib, a copy-1 flag, a live flag and its query position (u32);
//   with the open block (loc0, locN, pos0, posN, i0, iN, n1, n2), all 0 at
//   the start (loc0 == 0 means "no block open", as in the reference):
//     end = loc0 == 0 or block_break(la, ia); a copy-2 seed that breaks an
//     open block retries with (lb, ib);
//     block_break(loc, id) = id != idmap[loc0]
//       or (loc0 < locN and (loc < locN or |d| > 50)), d = (locN - loc0)
//          - (iN - i0), u32 differences read as int32
//       or (loc0 > locN and (loc > locN or |d| > 50)), d = (loc0 - locN)
//          - (iN - i0);
//     a live seed that ends the block emits (pos0, posN, loc0, locN, n1,
//     n2, 0) when n1 > 2 and opens a new block at itself; a live seed
//     counts into n1 (copy 1) or n2, and becomes the block's last seed.
//   After the last seed the open block emits (..., 1) when n2 > 2 alone
//   (the reference's quirk, modmap.c:269).
//
// Design.  The automaton is sequential within a read and independent
// across reads: a thread runs one read's seeds from CSR offsets, with no
// padding of reads to a common length.  A block opening at `loc` loads
// idmap[loc] once and keeps it (id0): block_break compares with it, so a
// seed costs no dependent device-memory load (idmap[loc0] is a function
// of loc0, which changes only at an opening).  lb and ib are read only on
// a copy-2 retry.
// - Slots form (mz_chain_scan; JAX's [R, cap] output): a thread a read
//   straight from device memory; record j of read r to slot r*cap + j
//   when j < cap, the read's other slots all ones, counts[r] and the
//   overflow flag (a read with more than cap records).
// - Offsets form (mz_chain_emit): one launch, each read's automaton run
//   once.  A block of TPB = 128 threads takes a tile of 128 reads, a read
//   a thread, numbered by a ticket (atomicInc on the scratch's word 0,
//   which wraps to 0 after the last tile).  Each warp stages its 32 reads'
//   seeds into shared memory in rounds: round t brings seeds [a + 8t,
//   a + 8t + 8) of every lane's read [a, b), a quarter-warp loading one
//   read's 8 (a 32-byte segment of la, ia and pos; 8 bytes of flags), a
//   round's loads all in flight and the next round's issued before the
//   lanes run this one; every lane runs its read's 8 seeds from its row,
//   its state in registers across rounds; lb and ib from device memory on
//   a retry only.  (Staging them too took 93 registers and 44 KB a block:
//   two waves of tiles, 0.1155 ms against 0.067, PERF.md.)  (Staging the warp's contiguous
//   range in chunks made the lanes take turns, a chunk holding a quarter
//   of the warp's reads: 0.085 ms on bench_chain, PERF.md.)  Records go to
//   a shared staging area of REC_CAP = 512 (a slot by a shared atomic,
//   tagged with the read's lane in the tile and its ordinal).  The block
//   scans the reads' counts, publishes its count, and finds the records of
//   the tiles before it by a decoupled look-back: a flag word a tile,
//   seq << 34 | status << 32 | value (status 1: the tile's count; 2: the
//   inclusive prefix), thread j polling tile p - j of a window of 128
//   until the word carries this call's seq, the nearest prefix and the
//   counts after it summed.  Then it publishes its inclusive prefix, writes
//   rec_off of its reads (and rec_off[R], the last tile) and its records
//   in order, 4 B a thread, to out at the exact offsets.  A tile whose
//   records overflow the staging runs its reads a second time from device
//   memory and writes them directly: bench_chain's 100,000 reads make at
//   most a few hundred records a tile, so there it never happens.  The
//   output is sized by the caller at floor(seeds / 3) rows: every record
//   closes a block of at least three live seeds, and blocks are disjoint.
//   No memset: the wrapper gives each call a new seq, so a word left by an
//   earlier call is never read as ready.
//
// What bounds it on this card: the bytes it must move (13 B a seed of la,
// ia, pos and flags; lb and ib at a copy-2 retry; an idmap entry at a
// block opening; 8 B a read of offsets each way; 28 B a record) would
// take 0.0145 ms on bench_chain's 100,000 reads (probe_chain's
// chain_bytes); the kernel takes over four times that (PERF.md).  The
// staging and the rounds alone, with no automaton step, take about a
// third of it (an edited copy through probe_chain --part); the rest is
// the automaton's integer issue (INT32 runs at half the FP32 rate) and
// its divergence: a lane of 32 that opens a block, retries or emits makes
// the whole warp run that path at nearly every step.  The look-back and
// the idmap loads at an opening cost little (PERF.md).

// The core (chain_step, chain_read) compiles as host code too: g++ -x c++
// -DMZ_CHAIN_HOST exports mz_chain_host, which runs the same function read
// after read for the CPU tests, and mz_chain_host_tile, one tile's warps
// as the offsets kernel runs them (chunks, staging and its overflow).

#include <cstdint>
#ifndef MZ_CHAIN_HOST
#include <cuda_runtime.h>
#else
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace chain_core {

constexpr int F = 7;                    // record fields
constexpr uint8_t IS1 = 1, LIVE = 2;    // seed flags

struct Seeds {
    const uint32_t *la, *lb, *ia, *ib;
    const uint8_t* flags;
    const uint32_t* pos;
    const uint32_t* idmap;
};

struct Block {
    uint32_t loc0, locN, p0, pN, i0, iN, n1, n2, id0;
};

__host__ __device__ __forceinline__ bool far(uint32_t a, uint32_t b) {
    const int32_t d = (int32_t)(a - b);
    return d > 50 || d < -50;
}

// modmap.c:232-241: does the seed at `loc` (sequence `id`) end the block?
// B.id0 is idmap[B.loc0], loaded when the block opened.
__host__ __device__ __forceinline__ bool block_break(const Block& B,
                                                     uint32_t loc,
                                                     uint32_t id) {
    if (id != B.id0) return true;
    const uint32_t span = B.iN - B.i0;
    if (B.loc0 < B.locN)
        return loc < B.locN || far(B.locN - B.loc0, span);
    if (B.loc0 > B.locN)
        return loc > B.locN || far(B.loc0 - B.locN, span);
    return false;
}

// One seed: t its ordinal in the read (dead seeds count), la, ia, its
// flags and position; retry(loc, id) gives its second occurrence (lb, ib),
// read only on a copy-2 retry.  emit(j, rec) gets record j; n counts them.
template <class Retry, class Emit>
__host__ __device__ __forceinline__ void chain_step(
        Block& B, int& n, uint32_t t, uint32_t la, uint32_t ia, uint8_t fl,
        uint32_t p, const uint32_t* idmap, Retry retry, Emit emit) {
    if (!(fl & LIVE)) return;                // a dead seed changes nothing
    const bool one = fl & IS1;
    uint32_t loc = la;
    bool end = B.loc0 == 0;
    if (!end) {
        end = block_break(B, loc, ia);
        if (end && !one) {                   // the copy-2 retry
            uint32_t id;
            retry(loc, id);
            end = block_break(B, loc, id);
        }
    }
    if (end) {
        if (B.n1 > 2) {
            const uint32_t rec[F] = {B.p0, B.pN, B.loc0, B.locN, B.n1, B.n2,
                                     0};
            emit(n++, rec);
        }
        B.n1 = B.n2 = 0;
        B.loc0 = loc;
        B.id0 = idmap[loc];
        B.i0 = t;
        B.p0 = p;
    }
    if (one) ++B.n1; else ++B.n2;
    B.locN = loc;
    B.iN = t;
    B.pN = p;
}

// After the last seed: the open block, gated on n2 > 2 (modmap.c:269).
template <class Emit>
__host__ __device__ __forceinline__ void chain_finish(const Block& B, int& n,
                                                      Emit emit) {
    if (B.n2 > 2) {
        const uint32_t rec[F] = {B.p0, B.pN, B.loc0, B.locN, B.n1, B.n2, 1};
        emit(n++, rec);
    }
}

// Runs the seeds [a, b) of one read from device memory; emit(j, rec) gets
// record j.  Returns the number of records.
template <class Emit>
__host__ __device__ int chain_read(const Seeds& S, int64_t a, int64_t b,
                                   Emit emit) {
    Block B{0, 0, 0, 0, 0, 0, 0, 0, 0};
    int n = 0;
    for (int64_t s = a; s < b; ++s)
        chain_step(B, n, (uint32_t)(s - a), S.la[s], S.ia[s], S.flags[s],
                   S.pos[s], S.idmap, [&](uint32_t& loc, uint32_t& id) {
                       loc = S.lb[s];
                       id = S.ib[s];
                   }, emit);
    chain_finish(B, n, emit);
    return n;
}

// The offsets kernel's tiles: TPB reads a block, a read a thread; each
// warp stages K seeds of each of its 32 reads a round; REC_CAP records
// staged a tile.
constexpr int TPB = 128;
constexpr int WARPS = TPB / 32;
constexpr int K = 8;
constexpr int ROW = K + 1;              // a lane's staged row, padded
constexpr int REC_CAP = 512;

// A staged record's tag: the read's thread in the tile, the record's
// ordinal in the read (below REC_CAP whenever it is staged).
__host__ __device__ __forceinline__ uint32_t stage_tag(int lane, int j) {
    return (uint32_t)lane << 24 | (uint32_t)j;
}

// A read's staged row: K seeds of la, ia, pos and the flags.
struct Row {
    const uint32_t *la, *ia, *pos;
    const uint8_t* fl;
};

// Round t of the read [a, b): its seeds [a + K t, a + K t + K) that lie
// before b, from its staged row (index j for seed a + K t + j); lb and ib
// from device memory, on a retry only.
template <class Emit>
__host__ __device__ __forceinline__ void chain_round(
        Block& B, int& n, const Seeds& S, int64_t a, int64_t b, int64_t t,
        const Row& w, Emit emit) {
    const int64_t s0 = a + K * t;
    for (int j = 0; j < K && s0 + j < b; ++j) {
        const int64_t s = s0 + j;
        chain_step(B, n, (uint32_t)(s - a), w.la[j], w.ia[j], w.fl[j],
                   w.pos[j], S.idmap, [&](uint32_t& loc, uint32_t& id) {
                       loc = S.lb[s];
                       id = S.ib[s];
                   }, emit);
    }
}

// Read r's records: to slot r*cap + j (slots mode, out_off null) or to
// out_off[r] + j; none when out is null (the count pass).
__host__ __device__ __forceinline__ void chain_one(
        const Seeds& S, const int64_t* seed_off, int64_t r,
        const int64_t* out_off, int cap, uint32_t* out, int32_t* counts,
        uint8_t* overflow) {
    const int64_t base = out_off ? out_off[r] : r * (int64_t)cap;
    const int n = chain_read(S, seed_off[r], seed_off[r + 1],
                             [&](int j, const uint32_t* rec) {
        if (out && (out_off || j < cap))
            for (int f = 0; f < F; ++f) out[(base + j) * F + f] = rec[f];
    });
    if (counts) counts[r] = n;
    if (!out_off) {
        if (out)
            for (int64_t j = n; j < cap; ++j)
                for (int f = 0; f < F; ++f) out[(base + j) * F + f] =
                                                0xFFFFFFFFu;
        if (n > cap && overflow) *overflow = 1;
    }
}

}  // namespace chain_core

#ifndef MZ_CHAIN_HOST

namespace {

using chain_core::F;
using chain_core::K;
using chain_core::ROW;
using chain_core::REC_CAP;
using chain_core::TPB;
using chain_core::WARPS;
constexpr int LOOKBACK = TPB;            // tiles a look-back step reads
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long AGGREGATE = 1, PREFIX = 2;

__device__ __forceinline__ unsigned long long ld_relaxed(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

// The slots form: a thread a read, from device memory.
__global__ void __launch_bounds__(TPB)
chain_kernel(const chain_core::Seeds S, const int64_t* __restrict__ seed_off,
             int64_t R, int cap, uint32_t* __restrict__ out,
             int32_t* __restrict__ counts, uint8_t* __restrict__ overflow) {
    const int64_t r = (int64_t)blockIdx.x * TPB + threadIdx.x;
    if (r < R)
        chain_core::chain_one(S, seed_off, r, nullptr, cap, out, counts,
                              overflow);
}

// The offsets form in one pass (see the header): scratch word 0 is the
// ticket, word 1 + t tile t's flag.
__global__ void __launch_bounds__(TPB)
chain_tiles(const chain_core::Seeds S, const int64_t* __restrict__ seed_off,
            int64_t R, int ntiles, unsigned long long seq,
            unsigned long long* __restrict__ scratch,
            int64_t* __restrict__ rec_off, uint32_t* __restrict__ out) {
    __shared__ uint32_t s_la[WARPS][32 * ROW], s_ia[WARPS][32 * ROW];
    __shared__ uint32_t s_pos[WARPS][32 * ROW];
    __shared__ uint8_t s_fl[WARPS][32 * ROW];
    __shared__ int64_t s_a[WARPS][32], s_b[WARPS][32];
    __shared__ uint32_t s_rec[REC_CAP][F + 1];   // fields, then the tag
    __shared__ uint16_t s_row[REC_CAP];          // tile row -> staged slot
    __shared__ int s_excl[TPB];                  // a read's first tile row
    __shared__ int s_wsum[WARPS];
    __shared__ unsigned s_prefix[WARPS];
    __shared__ int s_tile, s_nrec;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned long long* flags = scratch + 1;

    if (threadIdx.x == 0) {
        s_tile = (int)atomicInc((unsigned*)scratch, (unsigned)ntiles - 1);
        s_nrec = 0;
    }
    __syncthreads();
    const int tile = s_tile;
    const int64_t r = (int64_t)tile * TPB + threadIdx.x;
    const int64_t a = r < R ? seed_off[r] : 0;
    const int64_t b = r < R ? seed_off[r + 1] : 0;
    s_a[warp][lane] = a;
    s_b[warp][lane] = b;
    chain_core::Block B{0, 0, 0, 0, 0, 0, 0, 0, 0};
    int n = 0;
    auto stage = [&](int j, const uint32_t* rec) {
        const int slot = atomicAdd(&s_nrec, 1);
        if (slot < REC_CAP) {
#pragma unroll
            for (int f = 0; f < F; ++f) s_rec[slot][f] = rec[f];
            s_rec[slot][F] = chain_core::stage_tag(threadIdx.x, j);
        }
    };
    // the warp's reads, K seeds of each a round, through shared memory: in
    // load u, lanes 8q .. 8q + 7 take read 4u + q's K seeds, a 32-byte
    // segment of each plane; a round's loads all in flight at once, the
    // next round's issued before the lanes run this one
    const unsigned rounds = __reduce_max_sync(
        FULL, (unsigned)((b - a + K - 1) / K));
    uint32_t pa[K], pi[K], pp[K], pf[K];
    const int src = lane >> 3, col = lane & 7;
    auto fetch = [&](int64_t t) {
#pragma unroll
        for (int u = 0; u < K; ++u) {
            const int64_t s = s_a[warp][4 * u + src] + K * t + col;
            if (s < s_b[warp][4 * u + src]) {
                pa[u] = __ldg(S.la + s);
                pi[u] = __ldg(S.ia + s);
                pp[u] = __ldg(S.pos + s);
                pf[u] = __ldg(S.flags + s);
            }
        }
    };
    __syncwarp();
    if (rounds) fetch(0);
    for (unsigned t = 0; t < rounds; ++t) {
        __syncwarp();                    // the lanes are done with the last
#pragma unroll
        for (int u = 0; u < K; ++u) {
            const int i = (4 * u + src) * ROW + col;
            s_la[warp][i] = pa[u];
            s_ia[warp][i] = pi[u];
            s_pos[warp][i] = pp[u];
            s_fl[warp][i] = (uint8_t)pf[u];
        }
        __syncwarp();
        if (t + 1 < rounds) fetch(t + 1);
        const int i = lane * ROW;
        const chain_core::Row row{s_la[warp] + i, s_ia[warp] + i,
                                  s_pos[warp] + i, s_fl[warp] + i};
        chain_core::chain_round(B, n, S, a, b, t, row, stage);
    }
    chain_core::chain_finish(B, n, stage);

    // the reads' first rows within the tile, and the tile's count
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += o;
    }
    if (lane == 31) s_wsum[warp] = incl;
    __syncthreads();
    int total = 0, before = 0;
#pragma unroll
    for (int o = 0; o < WARPS; ++o) {
        total += s_wsum[o];
        if (o < warp) before += s_wsum[o];
    }
    s_excl[threadIdx.x] = before + incl - n;
    __syncthreads();

    // the records of the tiles before this one: a decoupled look-back
    int64_t ex = 0;
    if (tile == 0) {
        if (threadIdx.x == 0)
            st_release(flags, seq << 34 | PREFIX << 32 | (unsigned)total);
    } else {
        if (threadIdx.x == 0)
            st_release(flags + tile,
                       seq << 34 | AGGREGATE << 32 | (unsigned)total);
        int p = tile - 1;
        while (p >= 0) {
            // thread j waits for the flag of tile p - j
            const int q = p - (int)threadIdx.x;
            unsigned long long f = 0;
            if (q >= 0) {
                f = ld_relaxed(flags + q);
                for (int wait = 32; (f >> 34) != seq;
                     wait = min(2 * wait, 1024)) {
                    __nanosleep(wait);
                    f = ld_relaxed(flags + q);
                }
            }
            const unsigned pm = __ballot_sync(FULL, (f >> 32 & 3) == PREFIX);
            if (lane == 0) s_prefix[warp] = pm;
            __syncthreads();
            // the nearest inclusive prefix in the window, if any
            int last = min(LOOKBACK - 1, p);
            bool found = false;
            for (int w = 0; w < WARPS && !found; ++w) {
                if (s_prefix[w]) {
                    last = 32 * w + __ffs(s_prefix[w]) - 1;
                    found = true;
                }
            }
            const unsigned v = q >= 0 && (int)threadIdx.x <= last
                ? (unsigned)f : 0u;
            const unsigned ws = __reduce_add_sync(FULL, v);
            if (lane == 0) s_wsum[warp] = (int)ws;
            __syncthreads();
#pragma unroll
            for (int o = 0; o < WARPS; ++o) ex += s_wsum[o];
            p = found ? -1 : p - last - 1;
            __syncthreads();
        }
        if (threadIdx.x == 0)
            st_release(flags + tile,
                       seq << 34 | PREFIX << 32 | (unsigned)(ex + total));
    }
    if (r < R) rec_off[r] = ex + s_excl[threadIdx.x];
    if (tile == ntiles - 1 && threadIdx.x == 0) rec_off[R] = ex + total;

    if (total <= REC_CAP) {
        // the staged records in order, 4 B a thread
        for (int i = threadIdx.x; i < total; i += TPB) {
            const uint32_t tag = s_rec[i][F];
            s_row[s_excl[tag >> 24] + (tag & 0xFFFFFF)] = (uint16_t)i;
        }
        __syncthreads();
        uint32_t* dst = out + ex * F;
        for (int x = threadIdx.x; x < total * F; x += TPB) {
            const int row = x / F;
            dst[x] = s_rec[s_row[row]][x - row * F];
        }
    } else if (r < R) {
        // the staging overflowed: this read again, from device memory
        uint32_t* dst = out + (ex + s_excl[threadIdx.x]) * F;
        chain_core::chain_read(S, a, b, [&](int j, const uint32_t* rec) {
            for (int f = 0; f < F; ++f) dst[(int64_t)j * F + f] = rec[f];
        });
    }
}

}  // namespace

extern "C" int mz_chain_tile_reads() { return TPB; }
extern "C" int mz_chain_rec_cap() { return REC_CAP; }

// The slots form on `stream`; returns cudaGetLastError().  overflow must
// be zeroed by the caller.
extern "C" int mz_chain_scan(const uint32_t* la, const uint32_t* lb,
                             const uint32_t* ia, const uint32_t* ib,
                             const uint8_t* flags, const uint32_t* pos,
                             const uint32_t* idmap, const int64_t* seed_off,
                             int64_t R, int cap, uint32_t* out,
                             int32_t* counts, uint8_t* overflow,
                             cudaStream_t stream) {
    if (R < 0 || cap < 0) return (int)cudaErrorInvalidValue;
    if (R == 0) return (int)cudaGetLastError();
    const chain_core::Seeds S{la, lb, ia, ib, flags, pos, idmap};
    const int64_t nb = (R + TPB - 1) / TPB;
    chain_kernel<<<(unsigned)nb, TPB, 0, stream>>>(S, seed_off, R, cap, out,
                                                   counts, overflow);
    return (int)cudaGetLastError();
}

// The offsets form on `stream`, one launch; returns cudaGetLastError().
// R >= 1.  out holds at least floor(seeds / 3) rows of F; rec_off R + 1.
// scratch: a per-(device, stream) buffer of at least 1 + ceil(R / TPB)
// words, its word 0 zero and its flags of seq below `seq` (zero when
// first allocated); seq in [1, 2^30): greater than that of every earlier
// call on the buffer.
extern "C" int mz_chain_emit(const uint32_t* la, const uint32_t* lb,
                             const uint32_t* ia, const uint32_t* ib,
                             const uint8_t* flags, const uint32_t* pos,
                             const uint32_t* idmap, const int64_t* seed_off,
                             int64_t R, unsigned long long* scratch,
                             int64_t scratch_words, unsigned long long seq,
                             int64_t* rec_off, uint32_t* out,
                             cudaStream_t stream) {
    const int64_t ntiles = (R + TPB - 1) / TPB;
    if (R < 1 || ntiles >= (1LL << 31) || seq == 0 || seq >= (1ULL << 30)
        || scratch_words < 1 + ntiles)
        return (int)cudaErrorInvalidValue;
    const chain_core::Seeds S{la, lb, ia, ib, flags, pos, idmap};
    chain_tiles<<<(unsigned)ntiles, TPB, 0, stream>>>(
        S, seed_off, R, (int)ntiles, seq, scratch, rec_off, out);
    return (int)cudaGetLastError();
}

#else

extern "C" void mz_chain_host(const uint32_t* la, const uint32_t* lb,
                              const uint32_t* ia, const uint32_t* ib,
                              const uint8_t* flags, const uint32_t* pos,
                              const uint32_t* idmap, const int64_t* seed_off,
                              int64_t R, const int64_t* out_off, int cap,
                              uint32_t* out, int32_t* counts,
                              uint8_t* overflow) {
    const chain_core::Seeds S{la, lb, ia, ib, flags, pos, idmap};
    for (int64_t r = 0; r < R; ++r)
        chain_core::chain_one(S, seed_off, r, out_off, cap, out, counts,
                              overflow);
}

extern "C" int mz_chain_tile_reads() { return chain_core::TPB; }
extern "C" int mz_chain_rec_cap() { return chain_core::REC_CAP; }

// One tile of the offsets kernel as its warps run it: each warp's reads
// in rounds of K seeds, its lanes in turn over each round, the records
// staged in the order they come (REC_CAP at most, F fields and the tag
// each) and each read's count (counts[TPB]).  Returns the tile's records.
extern "C" int64_t mz_chain_host_tile(const uint32_t* la, const uint32_t* lb,
                                      const uint32_t* ia, const uint32_t* ib,
                                      const uint8_t* flags,
                                      const uint32_t* pos,
                                      const uint32_t* idmap,
                                      const int64_t* seed_off, int64_t R,
                                      int64_t tile, int32_t* counts,
                                      uint32_t* staged) {
    using namespace chain_core;
    const Seeds S{la, lb, ia, ib, flags, pos, idmap};
    int64_t nrec = 0;
    for (int w = 0; w < WARPS; ++w) {
        Block B[32] = {};
        int n[32] = {};
        int64_t a[32], b[32], rounds = 0;
        for (int l = 0; l < 32; ++l) {
            const int64_t r = tile * TPB + 32 * w + l;
            a[l] = r < R ? seed_off[r] : 0;
            b[l] = r < R ? seed_off[r + 1] : 0;
            const int64_t nr = (b[l] - a[l] + K - 1) / K;
            rounds = nr > rounds ? nr : rounds;
        }
        for (int l = 0; l < 32; ++l) {
            auto stage = [&](int j, const uint32_t* rec) {
                if (nrec < REC_CAP) {
                    for (int f = 0; f < F; ++f)
                        staged[nrec * (F + 1) + f] = rec[f];
                    staged[nrec * (F + 1) + F] = stage_tag(32 * w + l, j);
                }
                ++nrec;
            };
            for (int64_t t = 0; t < rounds; ++t) {
                const int64_t s0 = a[l] + K * t;
                uint32_t sla[K], sia[K], spos[K];
                uint8_t sfl[K];
                for (int j = 0; j < K && s0 + j < b[l]; ++j) {
                    sla[j] = la[s0 + j];
                    sia[j] = ia[s0 + j];
                    spos[j] = pos[s0 + j];
                    sfl[j] = flags[s0 + j];
                }
                chain_round(B[l], n[l], S, a[l], b[l], t,
                            Row{sla, sia, spos, sfl}, stage);
            }
            chain_finish(B[l], n[l], stage);
            counts[32 * w + l] = n[l];
        }
    }
    return nrec;
}

#endif
