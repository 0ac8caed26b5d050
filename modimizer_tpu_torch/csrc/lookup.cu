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
// What bounds it on this card.  The bytes are small (the keys, 8 B a query
// in and 4 B out), and the chain of a binary search is short; what the port's
// first kernel (a branchless binary search, a thread a query) ran into is
// the number of distinct cache lines a warp's load touches: below the top
// of the implicit tree each lane's step loads a sector of its own, so each
// step of a warp costs ~32 L1 wavefronts, 21 steps a query at modmap's
// config-3 shape (2.08 M keys, 0.97 M random queries).  The same queries
// sorted, whose lanes share lines, ran 3.5x faster.
//
// Design: a B+-tree of 16-key nodes laid over the sorted column with no
// copy of the keys.  Level k (k >= 1) is keys[::16^k], built once with the
// table (DeviceTable, by strided copies: ~1/15 of the keys) and passed as
// `index`; level 0 is the keys.  Node c - 1 of level k holds the 16
// entries that refine a count c of level k + 1 into one of level k.  The
// top level, at most TOP = 8192 entries (64 KB), is held in shared memory
// by each persistent block and searched by a thread per query; below it
// every node is read by 4 lanes, four keys a lane (one 128-byte line a
// node), eight queries a warp instruction, and the count of keys below the
// query comes from four ballots.  At config 3 that is a
// shared-memory search and two node lines a query, against 21 scattered
// loads.  A query hits when any entry it read equals it (the lower bound's
// key is always among them), and then its value is the one gather of the
// hits.
//
// The level geometry and the search arithmetic are in `namespace
// lookup_index`, which compiles as host code with `g++ -x c++
// -DMZ_LOOKUP_HOST` (the CPU tests replay the search with it against
// find_sorted_ref).

#include <cstdint>

#ifdef MZ_LOOKUP_HOST
#define MZ_HD inline
#else
#include <cuda_runtime.h>
#define MZ_HD __host__ __device__ __forceinline__
#endif

namespace lookup_index {

constexpr int FAN = 16;            // entries a node
constexpr int64_t TOP = 8192;      // entries of the top level, at most
constexpr int MAXLV = 8;           // 8192 * 16^7 > 2^63 keys

struct Levels {
    int K;                         // the top level (0: the keys themselves)
    int64_t len[MAXLV + 1];        // entries at level k; len[0] = n
    int64_t off[MAXLV + 1];        // level k >= 1 starts at index + off[k]
};

// Level k + 1 is every 16th entry of level k: keys[::16^(k+1)].  Each
// level of the index starts at a multiple of FAN entries, so that its
// nodes are 128-byte lines (the padding is never read).
MZ_HD Levels levels(int64_t n) {
    Levels L{};
    L.len[0] = n;
    int64_t total = 0;
    int k = 0;
    while (L.len[k] > TOP) {
        L.off[k + 1] = total;
        L.len[k + 1] = (L.len[k] + FAN - 1) / FAN;
        total += (L.len[k + 1] + FAN - 1) / FAN * FAN;
        ++k;
    }
    L.K = k;
    return L;
}

// Entries of the index (levels 1..K together).
MZ_HD int64_t index_len(const Levels& L) {
    return L.K ? L.off[L.K] + L.len[L.K] : 0;
}

// #{t < m : top[t] < q}, branchless: the steps depend on m alone, so the
// lanes of a warp never diverge.
MZ_HD int top_count(const int64_t* top, int m, int64_t q) {
    if (m == 0) return 0;
    int base = 0, len = m;
    while (len > 1) {
        const int half = len >> 1;
        base += top[base + half - 1] < q ? half : 0;
        len -= half;
    }
    return base + (top[base] < q);
}

// The node that refines count c >= 1 of the level above starts at entry
// node_base(c) of this level; c = 0 stays 0 (every entry is >= q).
MZ_HD int node_base(int c) { return FAN * (c - 1); }

// The count at this level: node_base(c) + u, u = the node's entries < q.
MZ_HD int refine(int c, int u) { return c > 0 ? node_base(c) + u : 0; }

// The answer for lower bound p, given whether an entry read equals q.
MZ_HD int32_t answer(const int32_t* vals, int64_t n, int64_t p, bool hit) {
    return hit && p < n ? vals[p] : 0;
}

}  // namespace lookup_index

#ifndef MZ_LOOKUP_HOST

namespace {

using namespace lookup_index;

constexpr int TPB = 512;
constexpr int WARPS = TPB / 32;
constexpr unsigned FULL = 0xffffffffu;
// lanes that read a node: 4 keys a lane in two 16-byte loads, 8 queries a
// warp instruction (8, 2 and 1 lanes were slower on the card)
constexpr int LANES = 4;

// ALIGNED: every level starts on 16 bytes (else the keys are read 8 bytes
// at a time).
template <bool ALIGNED>
__global__ void __launch_bounds__(TPB, 2)
find_sorted_kernel(const int64_t* __restrict__ keys,
                   const int32_t* __restrict__ vals,
                   const int64_t* __restrict__ index, Levels Lv,
                   const int64_t* __restrict__ q, int64_t nq,
                   int32_t* __restrict__ out) {
    constexpr int KPL = FAN / LANES;          // keys a lane
    constexpr int QPI = 32 / LANES;           // queries an instruction
    extern __shared__ int64_t top[];
    __shared__ int64_t sx[WARPS][32];         // a warp's queries
    __shared__ int sc[WARPS][32];             // their counts so far
    __shared__ int sh[WARPS][32];             // an entry read equals it
    const int64_t n = Lv.len[0];
    const int m = (int)Lv.len[Lv.K];
    const int64_t* tsrc = Lv.K ? index + Lv.off[Lv.K] : keys;
    for (int t = threadIdx.x; t < m; t += TPB) top[t] = tsrc[t];
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ln = lane % LANES, g = lane / LANES;
    const unsigned gmask = (LANES == 32 ? FULL : ((1u << LANES) - 1))
                           << (LANES * g);
    for (int64_t w0 = ((int64_t)blockIdx.x * WARPS + warp) * 32; w0 < nq;
         w0 += (int64_t)gridDim.x * TPB) {
        const int64_t i = w0 + lane;
        const int64_t x = i < nq ? __ldg(q + i) : 0;
        const int c0 = top_count(top, m, x);
        sx[warp][lane] = x;
        sc[warp][lane] = c0;
        sh[warp][lane] = c0 < m && top[c0] == x;
        __syncwarp();
        for (int k = Lv.K - 1; k >= 0; --k) {
            const int64_t* lv = k ? index + Lv.off[k] : keys;
            const int len = (int)Lv.len[k];
#pragma unroll 4
            for (int it = 0; it < LANES; ++it) {
                const int j = it * QPI + g;   // the query this group reads
                const int64_t xq = sx[warp][j];
                const int cq = sc[warp][j];
                const int b = node_base(cq) + KPL * ln;
                int64_t kk[KPL];
                if (ALIGNED && cq > 0 && b + KPL <= len) {
#pragma unroll
                    for (int e = 0; e < KPL; e += 2) {
                        const longlong2 v =
                            __ldg((const longlong2*)(lv + b + e));
                        kk[e] = v.x;
                        kk[e + 1] = v.y;
                    }
                } else {
#pragma unroll
                    for (int e = 0; e < KPL; ++e)
                        kk[e] = cq > 0 && b + e < len ? __ldg(lv + b + e)
                                                      : INT64_MAX;
                }
                int u = 0;
                bool eq = false;
#pragma unroll
                for (int e = 0; e < KPL; ++e) {
                    const bool valid = cq > 0 && b + e < len;
                    u += __popc(__ballot_sync(FULL, valid && kk[e] < xq)
                                & gmask);
                    eq |= valid && kk[e] == xq;
                }
                eq = (__ballot_sync(FULL, eq) & gmask) != 0;
                if (ln == 0) {
                    sc[warp][j] = refine(cq, u);
                    sh[warp][j] |= eq;
                }
            }
            __syncwarp();
        }
        if (i < nq) out[i] = answer(vals, n, sc[warp][lane], sh[warp][lane]);
        __syncwarp();
    }
}

template <bool ALIGNED>
cudaError_t launch(const int64_t* keys, const int32_t* vals,
                   const int64_t* index, const Levels& L, const int64_t* q,
                   int64_t nq, int32_t* out, cudaStream_t stream) {
    const auto kern = find_sorted_kernel<ALIGNED>;
    const size_t smem = (size_t)L.len[L.K] * sizeof(int64_t);
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(TOP * sizeof(int64_t)));
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TPB,
                                                          smem);
    if (e != cudaSuccess) return e;
    const int64_t need = (nq + TPB - 1) / TPB;
    const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    kern<<<(unsigned)(need < most ? need : most), TPB, smem, stream>>>(
        keys, vals, index, L, q, nq, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the first CUDA error.  keys int64 [n]
// ascending (n < 2^31), vals int32 [n], index int64 [index_len(levels(n))]
// (levels 1 to K of the search; may be NULL when that is 0), q int64
// [nq], out int32 [nq].
int mz_find_sorted(const void* keys, const void* vals, int64_t n,
                   const void* index, const void* q, int64_t nq, void* out,
                   void* stream) {
    if (n < 0 || n >= (1ll << 31) || nq <= 0)
        return (int)cudaErrorInvalidValue;
    const Levels L = levels(n);
    const bool aligned = ((uintptr_t)keys % 16 == 0) &&
                         ((uintptr_t)index % 16 == 0);
    const auto k = (const int64_t*)keys;
    const auto v = (const int32_t*)vals;
    const auto x = (const int64_t*)index;
    const auto qq = (const int64_t*)q;
    const auto o = (int32_t*)out;
    const auto st = (cudaStream_t)stream;
    return (int)(aligned ? launch<true>(k, v, x, L, qq, nq, o, st)
                         : launch<false>(k, v, x, L, qq, nq, o, st));
}

}  // extern "C"

#endif  // MZ_LOOKUP_HOST
