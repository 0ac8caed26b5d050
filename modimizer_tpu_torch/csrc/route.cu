// Routing of rows to the shard that owns them, cap slots an owner (sm_90a).
//
// Replaces the pad-to-cap sort and gather of three JAX programs:
// modimizer_tpu/parallel/sharded.py::sharded_scan_route (:1692-1715),
// sharded_merge_step (:2101-2128) and parallel/lookup.py::_sharded_find
// (:136-157).  The TPU has no vector scatter, so each of them sorts the
// rows with n*cap pad rows keyed by owner and gathers each group's first
// cap rows.  Contract (modimizer_tpu_torch/ops/route.py::route_rows_ref):
// for rows i < N, owner(kmer[i]) by the mode's rule (builder and lookup:
// div_mod_owner of the canonical hash (kmer * factor1) >> shift; merge:
// of the k-mer itself); sentinel rows (-1) stay home except in lookup
// mode.  Slot o*cap + r of `index` holds owner o's r-th row in input
// order, -1 past its count; counts[o] counts all its rows, and `overflow`
// is set when one exceeds cap (rows past cap are dropped: the caller
// widens and routes again).  Builder mode also writes the routed k-mer and
// global position base + (u32)pos[i] (pads -1).
//
// What bounds it on this card: bytes.  Each row is read once (8 B of
// k-mer, and 4 B of position in builder mode) and each of the n*cap slots
// written once (a 4 B index, and 16 B of builder columns): 12 B a row at
// n = 1 in merge mode, 0.0637 ms for 17.8 M rows at 3.35 TB/s.  The work
// between is an owner (a multiply and a shift; a divide only for a w or n
// that is not a power of two) and a rank, a few dozen instructions a row.
//
// Design: one pass over the rows (route_tiles), then a small pad launch
// (route_pad); at most two launches a call, no memset.
// - A block of WARPS = 8 warps takes a tile of TILE rows, R rows a lane
//   (Rows<MODE>).  Its tile number is a ticket (atomicInc on the scratch's
//   word 0, which wraps to 0 after the last tile, so the word is 0 again
//   for the next call): tiles are numbered in the order blocks start, so a
//   block waits only on tiles whose blocks already run, and the look-back
//   cannot deadlock.
// - Warp w of tile t holds rows t*TILE + w*32R + 32s + lane, s < R: a lane
//   issues BATCH 8-byte loads (a warp's load is 256 contiguous bytes)
//   before it uses one.  The owners stay in registers, packed with the
//   row's rank within its warp.
// - A warp's rows are ranked step by step (s = 0..R-1, input order).  For
//   n a power of two up to 32: ballots of liveness and of the owner's
//   log2 n bits give each lane the lanes of its row's owner and those of
//   the owner numbered as the lane; lane o keeps the warp's tally of owner
//   o in a register; a row's rank is its owner's tally (a shuffle) plus its
//   earlier lanes in the group.  Else __match_any_sync groups, whose first
//   lane reads and advances the warp's tally in shared memory.
// - The block scans the warps' tallies per owner (a thread an owner): each
//   warp's exclusive base within the tile and the tile's aggregate.
// - Decoupled look-back across tiles: the scratch holds a flag word a tile
//   (seq << 2 | status; status 1: aggregate published, 2: inclusive prefix
//   published) and n aggregates and n inclusive prefixes a tile.  A tile
//   publishes its aggregates; then thread j polls the flag of tile p - j
//   (relaxed loads, a backoff) until it carries this call's seq, fences,
//   and the block takes the nearest inclusive prefix of the window of
//   LOOKBACK = 256 tiles and the aggregates after it, a thread a (tile,
//   owner) value added into shared memory; with no prefix in the window,
//   the next 256 tiles back.  Tile 0 publishes its prefix at once.  Then
//   the tile publishes its inclusive prefix.  Writers store with st.cg and
//   fence; one thread then releases the flag; readers load with ld.cg.
//   The wrapper gives each call a new seq, so a word left by an earlier
//   call is never read as ready.
// - The last tile's inclusive prefix is the totals: it writes counts and
//   the overflow flag.
// - A row's slot is owner*cap + the tile's prefix + its warp's base + its
//   rank in the warp: the order within an owner is the input order.
// - route_pad writes the slots [counts[o], cap) of each owner o, a grid of
//   (blocks, owners) striding from counts[o]: no division a slot, and
//   nothing written where nothing is padded.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): at the merge's 17.8 M
// rows the loads alone run near a copy's rate; a tile's wait for its
// predecessors' aggregates (their loads land at random times within a
// wave) and the stores set the rest.  Wider look-back windows, relaxed
// polling and persistent blocks that prefetch their next tile did not
// help; three blocks an SM did.
//
// Which n it serves: every n in [1, MAX_SHARDS], with one shape.  Shared
// memory is (WARPS + 2) * n ints, 40 KB at n = 1024, so registers, not n,
// set the blocks an SM holds.  The per-owner work of a tile (zeroing,
// scanning and folding the 8 warps' tallies, 2n descriptor words written,
// the look-back's reads) is about 20n operations against 8,192 rows: under
// 2 % of the per-row work up to n = 8 (the cards of one node) and 64, and
// comparable to it at n = 1024, where the descriptors add 1 B a row.  The
// register tallies serve n = 1, 2, 4, 8, 16, 32; other n take the
// __match_any_sync path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;             // a tile's warps
constexpr int TPB = 32 * WARPS;
constexpr int MAX_SHARDS = 1024;     // shared: (WARPS + 2) * 1024 * 4 B
constexpr int LOOKBACK = TPB;        // tiles a look-back step reads
constexpr int PAD_TPB = 256;
constexpr int PAD_BLOCKS = 132 * 8;  // route_pad's blocks, over all owners
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long AGGREGATE = 1, PREFIX = 2;

enum { BUILDER = 0, MERGE = 1, LOOKUP = 2 };

// R rows a lane, loaded BATCH at a time; blocks an SM by registers.
// Builder mode keeps each row's k-mer and position for its store: 16 rows a
// lane, all loaded at once, two blocks an SM.  Merge and lookup mode keep
// an int a row: 32 rows a lane in two batches of 16 loads, 80 registers,
// three blocks an SM (0.125 ms at the merge's 17.8 M rows on an H100
// 80GB HBM3 at 700 W, against 0.147 with 32 loads at once and two blocks:
// PERF.md).
template <int MODE> struct Rows {
    static constexpr int R = MODE == BUILDER ? 16 : 32;
    static constexpr int BATCH = MODE == BUILDER ? R : 16;
    static constexpr int BLOCKS = MODE == BUILDER ? 2 : 3;
    static constexpr int TILE = TPB * R;
};
static_assert(Rows<MERGE>::TILE <= (1 << 16), "a warp's rank fits 16 bits");

struct Owner {
    uint64_t factor1;
    int shift;                       // the hash's shift, 64 - 2k
    uint64_t w;
    int w_log2;                      // log2(w) for a power of two, else -1
    int n;
    int n_log2;                      // log2(n) for a power of two, else -1
};

// The owner of a row, or -1 for a row that stays home (div_mod_owner of
// modimizer_tpu/ops/packed.py: the power-of-two shortcuts on w and n).
template <int MODE>
__device__ __forceinline__ int owner_of(int64_t kmer, const Owner& o) {
    if (MODE != LOOKUP && kmer == -1) return -1;
    uint64_t x = (uint64_t)kmer;
    if (MODE != MERGE) x = (x * o.factor1) >> o.shift;
    const uint64_t q = o.w_log2 >= 0 ? x >> o.w_log2 : x / o.w;
    if (o.n_log2 >= 0) return (int)((uint32_t)q & (uint32_t)(o.n - 1));
    return (int)(q % (uint64_t)o.n);
}

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

// The scratch: word 0 the ticket (its low 32 bits), then a flag word a
// tile, then the tiles' aggregates [ntiles][n] and inclusive prefixes
// [ntiles][n], int32.
struct Scratch {
    unsigned* ticket;
    unsigned long long* flags;
    int* agg;
    int* incl;
    __device__ Scratch(unsigned long long* s, int ntiles, int n)
        : ticket((unsigned*)s), flags(s + 1),
          agg((int*)(s + 1 + ntiles)),
          incl((int*)(s + 1 + ntiles) + (int64_t)ntiles * n) {}
};

// One block's publication of vals[0..n) as tile t's aggregates or
// inclusive prefixes, then its flag.
__device__ __forceinline__ void publish(const Scratch& sc, int* dst, int t,
                                        int n, const int* vals,
                                        unsigned long long word) {
    for (int o = threadIdx.x; o < n; o += TPB)
        __stcg(dst + (int64_t)t * n + o, vals[o]);
    if (threadIdx.x < n) __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(sc.flags + t, word);
}

template <int MODE, bool BALLOT>
__global__ void __launch_bounds__(TPB, Rows<MODE>::BLOCKS)
route_tiles(const int64_t* __restrict__ kmers,
            const int32_t* __restrict__ pos, uint64_t base, int64_t N,
            Owner o, int cap, int ntiles, unsigned long long seq,
            unsigned long long* __restrict__ scratch,
            int32_t* __restrict__ index, int* __restrict__ counts,
            bool* __restrict__ overflow, int64_t* __restrict__ send_k,
            int64_t* __restrict__ send_p) {
    constexpr int R = Rows<MODE>::R, TILE = Rows<MODE>::TILE;
    constexpr int RB = MODE == BUILDER ? R : 1;
    extern __shared__ int smem[];
    __shared__ int s_tile;
    __shared__ unsigned s_prefix[WARPS];   // a warp's flags that are prefixes
    const int n = o.n;
    int* tally = smem;               // [WARPS][n], then each warp's base
    int* agg = smem + WARPS * n;     // the tile's rows per owner
    int* ex = agg + n;               // the rows of earlier tiles per owner
    const Scratch sc(scratch, ntiles, n);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t lane0 = warp * (32 * R) + lane;

    if (threadIdx.x == 0)
        s_tile = (int)atomicInc(sc.ticket, (unsigned)ntiles - 1);
    for (int t = threadIdx.x; t < WARPS * n; t += TPB) tally[t] = 0;
    for (int t = threadIdx.x; t < n; t += TPB) ex[t] = 0;
    __syncthreads();
    const int tile = s_tile;
    const int64_t row0 = (int64_t)tile * TILE + lane0;
    // the rows, BATCH loads in flight before any is used; owner << 16 |
    // rank in the warp, or -1 for a row that stays home
    constexpr int BATCH = Rows<MODE>::BATCH;
    int pk[R];
    int64_t km[RB];                  // builder mode: each row's k-mer
    int32_t ps[RB];                  // and position, for its store
#pragma unroll
    for (int b0 = 0; b0 < R; b0 += BATCH) {
        int64_t kb[BATCH];
#pragma unroll
        for (int s = 0; s < BATCH; ++s) {
            const int64_t i = row0 + 32 * (b0 + s);
            kb[s] = i < N ? __ldg(kmers + i) : -1;
            if constexpr (MODE == BUILDER) {
                km[s] = kb[s];
                ps[s] = i < N ? __ldg(pos + i) : 0;
            }
        }
#pragma unroll
        for (int s = 0; s < BATCH; ++s)
            pk[b0 + s] = row0 + 32 * (b0 + s) < N
                ? owner_of<MODE>(kb[s], o) : -1;
    }

    // rank each row within its warp, step by step
    int* h = tally + warp * n;
    const unsigned below = (1u << lane) - 1;
    if constexpr (BALLOT) {
        // lane o < n keeps the warp's tally of owner o in a register
        int mine_so_far = 0;
#pragma unroll
        for (int s = 0; s < R; ++s) {
            const int own = pk[s];
            const unsigned live = __ballot_sync(FULL, own >= 0);
            unsigned same = live, ours = live;  // own's; lane's owner's
#pragma unroll
            for (int b = 0; b < 5; ++b) {    // n_log2 <= 5
                if (b >= o.n_log2) break;
                const unsigned v = __ballot_sync(FULL, (own >> b) & 1);
                same &= (own >> b) & 1 ? v : ~v;
                ours &= (lane >> b) & 1 ? v : ~v;
            }
            const int hv = __shfl_sync(FULL, mine_so_far, own & 31);
            if (own >= 0)
                pk[s] = own << 16 | (hv + __popc(same & below));
            mine_so_far += __popc(ours);
        }
        if (lane < n) h[lane] = mine_so_far;
    } else {
#pragma unroll
        for (int s = 0; s < R; ++s) {
            const int own = pk[s];
            const unsigned m = __match_any_sync(FULL, own);
            const int lead = __ffs(m) - 1;
            int hv = 0;
            if (own >= 0 && lane == lead) {
                hv = h[own];
                h[own] = hv + __popc(m);
            }
            hv = __shfl_sync(FULL, hv, lead);
            if (own >= 0)
                pk[s] = own << 16 | (hv + __popc(m & below));
            __syncwarp();
        }
    }
    __syncthreads();

    // the warps' bases within the tile, and the tile's aggregate
    for (int t = threadIdx.x; t < n; t += TPB) {
        int run = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const int c = tally[w * n + t];
            tally[w * n + t] = run;
            run += c;
        }
        agg[t] = run;
    }
    __syncthreads();
    if (tile == 0) {
        publish(sc, sc.incl, 0, n, agg, seq << 2 | PREFIX);
    } else {
        publish(sc, sc.agg, tile, n, agg, seq << 2 | AGGREGATE);
        // look back: the nearest inclusive prefix, and the aggregates
        // of the tiles after it
        int p = tile - 1;
        while (p >= 0) {
            // thread j waits for the flag of tile p - j
            const int q = p - (int)threadIdx.x;
            unsigned long long f = 0;
            if (q >= 0) {
                f = ld_relaxed(sc.flags + q);
                for (int wait = 32; (f >> 2) != seq;
                     wait = min(2 * wait, 1024)) {
                    __nanosleep(wait);
                    f = ld_relaxed(sc.flags + q);
                }
            }
            __threadfence();
            const unsigned pm = __ballot_sync(FULL, (f & 3) == PREFIX);
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
            // the window's (tile, owner) values, a thread each
            for (int i = threadIdx.x; i < n * (last + 1); i += TPB) {
                const int l = i / n, t = i - l * n;
                const int* src = found && l == last ? sc.incl : sc.agg;
                atomicAdd(ex + t,
                          __ldcg(src + (int64_t)(p - l) * n + t));
            }
            p = found ? -1 : p - last - 1;
            __syncthreads();
        }
        for (int t = threadIdx.x; t < n; t += TPB) agg[t] += ex[t];
        __syncthreads();
        publish(sc, sc.incl, tile, n, agg, seq << 2 | PREFIX);
    }
    // agg now holds the inclusive prefix: the last tile's is the totals
    if (tile == ntiles - 1) {
        bool over = false;
        for (int t = threadIdx.x; t < n; t += TPB) {
            counts[t] = agg[t];
            over |= agg[t] > cap;
        }
        over = __syncthreads_or(over);
        if (threadIdx.x == 0) *overflow = over;
    }
    for (int t = threadIdx.x; t < n; t += TPB) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) tally[w * n + t] += ex[t];
    }
    __syncthreads();

    // each row to its slot
#pragma unroll
    for (int s = 0; s < R; ++s) {
        if (pk[s] < 0) continue;
        const int own = pk[s] >> 16;
        const int r = h[own] + (pk[s] & 0xFFFF);
        if (r < cap) {
            const int64_t slot = (int64_t)own * cap + r;
            index[slot] = (int32_t)(row0 + 32 * s);
            if constexpr (MODE == BUILDER) {
                send_k[slot] = km[s];
                send_p[slot] = (int64_t)(base + (uint32_t)ps[s]);
            }
        }
    }
}

// The pads: slots [counts[o], cap) of owner o = blockIdx.y.
__global__ void __launch_bounds__(PAD_TPB)
route_pad(int cap, const int* __restrict__ counts,
          int32_t* __restrict__ index, int64_t* __restrict__ send_k,
          int64_t* __restrict__ send_p) {
    const int64_t o0 = (int64_t)blockIdx.y * cap;
    const int64_t stride = (int64_t)gridDim.x * PAD_TPB;
    for (int64_t r = min(counts[blockIdx.y], cap) + blockIdx.x * PAD_TPB
                     + threadIdx.x; r < cap; r += stride) {
        index[o0 + r] = -1;
        if (send_k) {
            send_k[o0 + r] = -1;
            send_p[o0 + r] = -1;
        }
    }
}

template <int MODE, bool BALLOT>
void launch_tiles(int ntiles, size_t smem, cudaStream_t stream,
                  const int64_t* kmers, const int32_t* pos, uint64_t base,
                  int64_t N, const Owner& o, int cap,
                  unsigned long long seq, unsigned long long* scratch,
                  int32_t* index, int* counts, bool* overflow,
                  int64_t* send_k, int64_t* send_p) {
    route_tiles<MODE, BALLOT><<<ntiles, TPB, smem, stream>>>(
        kmers, pos, base, N, o, cap, ntiles, seq, scratch, index, counts,
        overflow, send_k, send_p);
}

template <int MODE>
void launch_mode(bool ballot, int ntiles, size_t smem, cudaStream_t stream,
                 const int64_t* kmers, const int32_t* pos, uint64_t base,
                 int64_t N, const Owner& o, int cap, unsigned long long seq,
                 unsigned long long* scratch, int32_t* index, int* counts,
                 bool* overflow, int64_t* send_k, int64_t* send_p) {
    if (ballot)
        launch_tiles<MODE, true>(ntiles, smem, stream, kmers, pos, base, N,
                                 o, cap, seq, scratch, index, counts,
                                 overflow, send_k, send_p);
    else
        launch_tiles<MODE, false>(ntiles, smem, stream, kmers, pos, base, N,
                                  o, cap, seq, scratch, index, counts,
                                  overflow, send_k, send_p);
}

}  // namespace

// Rows a tile in `mode` (ops/route.py's TILE_ROWS).
extern "C" int mz_route_tile_rows(int mode) {
    return mode == BUILDER ? Rows<BUILDER>::TILE : Rows<MERGE>::TILE;
}

// scratch: a per-(device, stream) buffer of at least
// 8 * (1 + ntiles) + 8 * ntiles * n bytes, its ticket word 0 and its flags
// of seq below `seq` (zero when first allocated); seq: this call's number,
// greater than that of every earlier call on the buffer.
extern "C" int mz_route_rows(const int64_t* kmers, const int32_t* pos,
                             uint64_t base, int64_t N, int mode,
                             uint64_t factor1, int shift, uint64_t w, int n,
                             int cap, unsigned long long* scratch,
                             int64_t scratch_bytes, unsigned long long seq,
                             int32_t* index, int* counts, bool* overflow,
                             int64_t* send_k, int64_t* send_p,
                             cudaStream_t stream) {
    if (n < 1 || n > MAX_SHARDS || cap < 1 || (int64_t)n * cap >= (1LL << 31)
        || N < 0 || N >= (1LL << 31) || mode < BUILDER || mode > LOOKUP
        || w == 0 || seq == 0 || seq >= (1ULL << 62)
        || (mode == BUILDER) != (send_k != nullptr && send_p != nullptr)
        || (mode == BUILDER && N > 0 && !pos) || (mode != BUILDER && pos))
        return (int)cudaErrorInvalidValue;
    const int64_t tile = mz_route_tile_rows(mode);
    const int ntiles = (int)(N > 0 ? (N + tile - 1) / tile : 1);
    if (scratch_bytes < 8 * (1 + (int64_t)ntiles) + 8 * (int64_t)ntiles * n)
        return (int)cudaErrorInvalidValue;
    Owner o;
    o.factor1 = factor1;
    o.shift = shift;
    o.w = w;
    o.w_log2 = (w & (w - 1)) ? -1 : __builtin_ctzll(w);
    o.n = n;
    o.n_log2 = (n & (n - 1)) ? -1 : __builtin_ctz((unsigned)n);
    const bool ballot = o.n_log2 >= 0 && n <= 32;
    const size_t smem = (size_t)(WARPS + 2) * n * sizeof(int);
    if (mode == BUILDER)
        launch_mode<BUILDER>(ballot, ntiles, smem, stream, kmers, pos, base,
                             N, o, cap, seq, scratch, index, counts,
                             overflow, send_k, send_p);
    else if (mode == MERGE)
        launch_mode<MERGE>(ballot, ntiles, smem, stream, kmers, pos, base,
                           N, o, cap, seq, scratch, index, counts, overflow,
                           send_k, send_p);
    else
        launch_mode<LOOKUP>(ballot, ntiles, smem, stream, kmers, pos, base,
                            N, o, cap, seq, scratch, index, counts, overflow,
                            send_k, send_p);
    // blocks an owner: enough for its cap slots, PAD_BLOCKS in all
    const int64_t per_owner = ((int64_t)cap + PAD_TPB - 1) / PAD_TPB;
    const int room = PAD_BLOCKS / n > 1 ? PAD_BLOCKS / n : 1;
    const int gx = (int)(per_owner < room ? per_owner : room);
    route_pad<<<dim3(gx, n), PAD_TPB, 0, stream>>>(cap, counts, index,
                                                   send_k, send_p);
    return (int)cudaGetLastError();
}
