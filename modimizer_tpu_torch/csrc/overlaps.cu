// Overlap self-join with its reduce: for every read x, each distinct read y
// that shares a counted copy-1 mod with it, with the number of pair rows,
// their strand agreements and their smallest rank, written in key order
// (sm_90a).  No pair row is stored.
//
// Replaces modimizer_tpu/parallel/overlaps.py::_overlap_pairs_device
// (modasm's findOverlaps phase 1 on the device).  The JAX form rolls
// 1 + 2 (dmax - 1) copies of every hit row, masks the pairs that leave
// their mod's group and sorts them all, because a TPU has no vector
// scatter.  The port's first kernel (count and emit launches) wrote every
// pair row (131.8 M of 17 B at modasm's config-5 shape) and then sorted
// and reduced them with PyTorch ops; this one reduces each read's pairs in
// shared memory as it enumerates them.
//
// Contract (modimizer_tpu_torch/parallel/overlaps.py::overlap_pairs_ref).
// Hit rows arrive in (x, j) order.  The hkey of a row is h where the row
// is a counted copy-1 row, else 0xFFFFFFFF; sorted stably by hkey the rows
// are in (h, x, j) order, a group is a run of one live hkey and k = a
// row's rank in it.  Row a is an x side when it is live and first (its
// read's first occurrence of the mod); it pairs with every row b of its
// group, itself included: key (x_a << 32) | x_b, rank (j_a << 20) | k_b,
// agree st_a == st_b.  The output is one row per distinct key, ascending, with
// the pair rows' count, the sum of agree and the smallest rank.
//
// Launches (the caller first sorts the rows stably by a 32-bit key that
// keeps the hkeys' order, live_key, with torch.sort):
//   1. overlap_groups_kernel, a thread per sorted row p: its group's bounds
//      by a galloping search from p (O(log g) loads around p, not a search
//      of the whole column), scattered to the row's input position as
//      (start, size); the sorted row's y and strand packed in 32 bits; the
//      largest group (a warp max, one atomicMax a warp).
//   2. overlap_join_kernel, count pass: a block per tile of 256 input rows
//      takes the reads that start in its tile.  For a read, each warp takes
//      32 of its rows and enumerates their pairs as one range (the owner
//      lane of pair q by a five-step shuffle search over the lanes'
//      prefixes, so the group rows b are read in runs); every pair inserts
//      its y into an open-addressed table in shared memory.  The read's
//      distinct count goes to its first row; a read with more than `cap`
//      distinct partners is flagged and appended to a list instead.
//   3. (flagged reads only) overlap_dense_kernel, count pass: the same walk
//      into a table in device memory indexed by y, one per block.
//   The caller takes the exclusive prefix of the counts (torch.cumsum) and
//   reads the total, which sizes the outputs; then
//   4. overlap_join_kernel, emit pass: the table again, now with 32-bit
//      atomicAdds of the count and the agreement and an atomicMax of ~rank
//      where it lowers the rank; the read's entries are ranked by y and
//      written at its offset.  Reads go in x order and entries in y order,
//      so the keys come out ascending.
//   5. (flagged reads only) overlap_dense_kernel, emit pass: a block scan
//      over the dense table writes the entries in y order.
//
// What bounds it on this card.  The output is small (~0.6 M pairs of 32 B
// at config 5) and the inputs are read once (~67 MB); the work is the
// enumeration: ~132 M pair updates a pass, each a 4-byte load of the group
// row b (about 0.66 GB of reads from L2, where the sorted columns stay)
// and one to three shared-memory updates.  Both passes repeat it, which
// buys offsets without a tensor sized by the pair rows or a slab per read.
//
// The table, the overflow path and the placement are in `namespace
// overlap_place`, which compiles as host code with `g++ -x c++
// -DMZ_OVERLAPS_HOST` (the CPU tests replay the launches with it and hold
// the rows against overlap_pairs_ref).

#include <cstdint>

#ifdef MZ_OVERLAPS_HOST
#define MZ_HD inline
#else
#include <cuda_runtime.h>
#define MZ_HD __host__ __device__ __forceinline__
#endif

namespace overlap_place {

constexpr int TPB = 256;                  // threads a block; rows a tile
// The card sorts 32-bit keys: h | 0x80000000 (negative) for a counted
// copy-1 row, 0 for the rest, which keeps the order of the hkeys.
MZ_HD bool live_key(int32_t k) { return k < 0; }
constexpr int32_t EMPTY = -1;             // a free table slot

// First index s <= p with v[s..p] all equal to v[p] (v sorted, or runs).
template <class T>
MZ_HD int64_t run_start(const T* v, int64_t p) {
    const T x = v[p];
    int64_t good = p, bad = -1, step = 1;
    while (p - step >= 0) {
        if (v[p - step] != x) {
            bad = p - step;
            break;
        }
        good = p - step;
        step <<= 1;
    }
    while (good - bad > 1) {
        const int64_t mid = bad + (good - bad) / 2;
        if (v[mid] == x) good = mid; else bad = mid;
    }
    return good;
}

// One past the last index e > p with v[p..e) all equal to v[p].
template <class T>
MZ_HD int64_t run_end(const T* v, int64_t n, int64_t p) {
    const T x = v[p];
    int64_t good = p, bad = n, step = 1;
    while (p + step < n) {
        if (v[p + step] != x) {
            bad = p + step;
            break;
        }
        good = p + step;
        step <<= 1;
    }
    while (bad - good > 1) {
        const int64_t mid = good + (bad - good) / 2;
        if (v[mid] == x) good = mid; else bad = mid;
    }
    return good + 1;
}

// Slots of a read's shared table for `cap` distinct partners: a power of
// two, at most half full below the cap, with room for TPB keys more (the
// threads may insert a few keys before they see the cap passed; a table
// that fills flags its read as well).
MZ_HD constexpr int table_slots(int cap) {
    int s = 1;
    while (s < 2 * cap || s < cap + TPB + 1) s <<= 1;
    return s;
}

// Dynamic shared memory of the join for `cap`: S slots of ~rank, count,
// agreement and key (20 B), and the read's cap keys and their slots.
MZ_HD constexpr int64_t join_smem(int cap) {
    return (int64_t)table_slots(cap) * 20 + (int64_t)cap * 8;
}

// The largest cap whose table fits the 227 KB of shared memory a block may
// take on sm_90 (less 4 KB for the kernel's static arrays): at 4097 the
// table doubles to 16,384 slots.
constexpr int64_t SMEM_LIMIT = 227 * 1024 - 4096;
constexpr int MAX_CAP = 4096;
static_assert(join_smem(MAX_CAP) <= SMEM_LIMIT &&
              join_smem(MAX_CAP + 1) > SMEM_LIMIT,
              "MAX_CAP is the largest cap whose table fits");

MZ_HD uint32_t slot_of(int32_t y, uint32_t mask) {
    const uint32_t v = (uint32_t)y * 0x9E3779B1u;
    return (v ^ (v >> 15)) & mask;
}

// The slot of key y in the open-addressed table `keys` (mask + 1 slots),
// inserting y where it is absent (*fresh = true); -1 when the table is
// full.  `cas(ptr, expected, desired)` returns the old value: an atomicCAS
// on the card, a plain compare-and-store on the host.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Cas>
MZ_HD int find_slot(int32_t* keys, uint32_t mask, int32_t y, Cas cas,
                    bool* fresh) {
    uint32_t s = slot_of(y, mask);
    for (uint32_t probes = 0; probes <= mask; ++probes) {
        const int32_t k = ((volatile int32_t*)keys)[s];
        if (k == y) {
            *fresh = false;
            return (int)s;
        }
        if (k == EMPTY) {
            const int32_t old = cas(keys + s, EMPTY, y);
            if (old == EMPTY || old == y) {
                *fresh = old == EMPTY;
                return (int)s;
            }
        }
        s = (s + 1) & mask;
    }
    *fresh = false;
    return -1;
}

// A pair's contribution: count in the high word, agree in the low one.
MZ_HD uint64_t pair_inc(bool agree) {
    return (1ull << 32) | (uint64_t)agree;
}

MZ_HD uint64_t pair_rank(int32_t ja, int64_t kb) {
    return ((uint64_t)(uint32_t)ja << 20) | (uint64_t)kb;
}

MZ_HD int64_t pair_key(int32_t x, int32_t y) {
    return ((int64_t)x << 32) | (int64_t)(uint32_t)y;
}

// A sorted row's read and strand in one word (x < 2^31).
MZ_HD uint32_t pack_y(int32_t x, uint8_t st) {
    return ((uint32_t)x << 1) | (uint32_t)(st & 1);
}

// Position of key y among a read's nd distinct keys (their output order).
MZ_HD int rank_in(const int32_t* list, int nd, int32_t y) {
    int r = 0;
    for (int j = 0; j < nd; ++j) r += list[j] < y;
    return r;
}

// The lane of a warp's 32 rows that owns pair q of their joint range: the
// largest l with p(l) <= q, p(l) lane l's exclusive prefix of pair counts
// (non-decreasing, p(0) = 0).  *pl = p(l).  On the card p is a shuffle, so
// every lane calls it at every step.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Prefix, class I>
MZ_HD int lane_of(Prefix p, I q, I* pl) {
    int l = 0;
    I at = 0;
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
        const I v = p(l + step);
        if (v <= q) {
            l += step;
            at = v;
        }
    }
    *pl = at;
    return l;
}

// Bytes of the overflow path's tables: count | agree and ~rank, 8 B each,
// for every y in [0, nid), one table a block.
MZ_HD int64_t dense_bytes(int64_t nid, int64_t blocks) {
    return 16 * nid * blocks;
}

}  // namespace overlap_place

#ifndef MZ_OVERLAPS_HOST

namespace {

using namespace overlap_place;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = TPB / 32;
constexpr int UNROLL = 4;          // pairs a lane walks at a time

struct Rows {
    const int32_t* xs;      // input order
    const int32_t* js;
    const uint8_t* st;
    const uint8_t* first;
    const int2* grp;        // the row's group: start in sorted order, size
                            // (0 outside a group)
    const uint32_t* yb;     // sorted order: pack_y(x, strand)
    int64_t n;
};

struct Out {
    int64_t* key;
    int64_t* cnt;
    int64_t* agree;
    int64_t* rank;
};

__global__ void __launch_bounds__(TPB)
overlap_groups_kernel(const int32_t* __restrict__ h,
                      const int64_t* __restrict__ order,
                      const int32_t* __restrict__ xs,
                      const uint8_t* __restrict__ st, int64_t n,
                      int2* __restrict__ grp, uint32_t* __restrict__ yb,
                      unsigned* __restrict__ max_group) {
    const int64_t p = (int64_t)blockIdx.x * TPB + threadIdx.x;
    int32_t g = 0;
    if (p < n) {
        const int64_t a = order[p];
        int32_t s = 0;
        if (live_key(h[p])) {
            const int64_t s0 = run_start(h, p);
            s = (int32_t)s0;
            g = (int32_t)(run_end(h, n, p) - s0);
        }
        grp[a] = make_int2(s, g);
        yb[p] = pack_y(xs[a], st[a]);
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) g = max(g, __shfl_xor_sync(FULL, g, d));
    if ((threadIdx.x & 31) == 0 && g > 0) atomicMax(max_group, (unsigned)g);
}

// Every pair of read [rs, re): ins(y, agree, rank).  Warps take 32 rows at
// a time; a warp leaves its loop when *stop is set.
template <class Insert>
__device__ void walk_pairs(const Rows& R, int64_t rs, int64_t re,
                           Insert ins, const volatile int* stop) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int64_t g0 = rs + 32 * warp; g0 < re; g0 += TPB) {
        if (__any_sync(FULL, *stop)) return;
        const int64_t a = g0 + lane;
        int c = 0, start = 0, ja = 0, sa = 0;
        if (a < re && R.first[a]) {
            const int2 gr = R.grp[a];
            start = gr.x;
            c = gr.y;
            ja = R.js[a];
            sa = R.st[a];
        }
        // a warp's 32 rows pair with at most 32 groups of < 2^16 rows
        int inc = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += v;
        }
        const int excl = inc - c;
        const int wsum = __shfl_sync(FULL, inc, 31);
        const auto prefix = [excl](int l) {
            return __shfl_sync(FULL, excl, l);
        };
        // UNROLL pairs a lane: their group rows' loads in flight together
        for (int q0 = 0; q0 < wsum; q0 += 32 * UNROLL) {
            if (__any_sync(FULL, *stop)) return;
            uint32_t v[UNROLL];
            int kb[UNROLL], ja_l[UNROLL], sa_l[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int q = q0 + 32 * u + lane;
                int pl;
                const int l = lane_of(prefix, q, &pl);
                const int32_t sb = __shfl_sync(FULL, start, l);
                ja_l[u] = __shfl_sync(FULL, ja, l);
                sa_l[u] = __shfl_sync(FULL, sa, l);
                kb[u] = q - pl;
                v[u] = q < wsum ? __ldg(R.yb + sb + kb[u]) : 0;
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                if (q0 + 32 * u + lane < wsum)
                    ins((int32_t)(v[u] >> 1), (int)(v[u] & 1) == sa_l[u],
                        pair_rank(ja_l[u], kb[u]));
        }
    }
}

struct AtomicCas {
    __device__ int32_t operator()(int32_t* p, int32_t e, int32_t d) const {
        return atomicCAS(p, e, d);
    }
};

// Block exclusive scan of one int a thread; *total = the block's sum.
__device__ __forceinline__ int block_excl(int v, int* total, int* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc += t;
    }
    if (lane == 31) sh[warp] = inc;
    __syncthreads();
    int base = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        base += w < warp ? sh[w] : 0;
        sum += sh[w];
    }
    __syncthreads();
    *total = sum;
    return base + inc - v;
}

// incl == nullptr: the count pass; else the emit pass.
__global__ void __launch_bounds__(TPB)
overlap_join_kernel(Rows R, int cap, int32_t* __restrict__ dcnt,
                    int32_t* __restrict__ flags, int* __restrict__ nflag,
                    const int64_t* __restrict__ incl, Out out) {
    extern __shared__ uint64_t smem[];
    const int S = table_slots(cap);
    const uint32_t mask = (uint32_t)S - 1;
    uint64_t* tnr = smem;                          // S: ~rank (max)
    uint32_t* tcnt = (uint32_t*)(tnr + S);         // S: pair rows
    uint32_t* tagr = tcnt + S;                     // S: their agreements
    int32_t* tkey = (int32_t*)(tagr + S);          // S
    int32_t* lkey = tkey + S;                      // cap: the read's keys
    int32_t* lslot = lkey + cap;                   // cap: their slots
    __shared__ int starts[TPB];
    __shared__ int nst, nd, nl;
    __shared__ volatile int ovf;
    __shared__ int64_t re_sh;
    const bool emit = incl != nullptr;
    const int tid = threadIdx.x;
    for (int s = tid; s < S; s += TPB) {
        tkey[s] = EMPTY;
        tcnt[s] = tagr[s] = 0;
        tnr[s] = 0;
    }
    if (tid == 0) {
        nst = 0;
        nd = 0;
        nl = 0;
        ovf = 0;
    }
    __syncthreads();
    const int64_t a = (int64_t)blockIdx.x * TPB + tid;
    if (a < R.n && (a == 0 || R.xs[a - 1] != R.xs[a]))
        starts[atomicAdd(&nst, 1)] = (int)(a - (int64_t)blockIdx.x * TPB);
    __syncthreads();
    for (int r = 0; r < nst; ++r) {
        const int64_t rs = (int64_t)blockIdx.x * TPB + starts[r];
        if (tid == 0) re_sh = run_end(R.xs, R.n, rs);
        __syncthreads();
        const int64_t re = re_sh;
        walk_pairs(R, rs, re, [&](int32_t y, bool agree, uint64_t rank) {
            bool fresh;
            const int s = find_slot(tkey, mask, y, AtomicCas(), &fresh);
            if (s < 0) {
                ovf = 1;
                return;
            }
            if (fresh && atomicAdd(&nd, 1) >= cap) ovf = 1;
            if (emit) {
                // two 32-bit atomics: the 64-bit shared add is not native
                atomicAdd(tcnt + s, 1u);
                if (agree) atomicAdd(tagr + s, 1u);
                // ranks grow with j along a read: most pairs of a key
                // come after its smallest and leave its rank as it is
                if (~rank > ((volatile uint64_t*)tnr)[s])
                    atomicMax((unsigned long long*)(tnr + s),
                              (unsigned long long)~rank);
            }
        }, &ovf);
        __syncthreads();
        const bool flagged = ovf;
        if (!emit) {
            if (tid == 0) {
                dcnt[rs] = flagged ? 0 : nd;
                if (flagged) flags[atomicAdd(nflag, 1)] = (int32_t)rs;
            }
        } else if (!flagged) {
            for (int s = tid; s < S; s += TPB) {
                if (tkey[s] != EMPTY) {
                    const int i = atomicAdd(&nl, 1);
                    lkey[i] = tkey[s];
                    lslot[i] = s;
                }
            }
            __syncthreads();
            const int64_t off = incl[rs] - dcnt[rs];
            const int32_t x = R.xs[rs];
            for (int i = tid; i < nl; i += TPB) {
                const int32_t y = lkey[i];
                const int s = lslot[i];
                const int64_t o = off + rank_in(lkey, nl, y);
                out.key[o] = pair_key(x, y);
                out.cnt[o] = (int64_t)tcnt[s];
                out.agree[o] = (int64_t)tagr[s];
                out.rank[o] = (int64_t)~tnr[s];
            }
        }
        __syncthreads();
        for (int s = tid; s < S; s += TPB) {
            tkey[s] = EMPTY;
            tcnt[s] = tagr[s] = 0;
            tnr[s] = 0;
        }
        if (tid == 0) {
            nd = 0;
            nl = 0;
            ovf = 0;
        }
        __syncthreads();
    }
}

// The flagged reads, a block each in turn, with a table in device memory
// indexed by y (nid = the largest read id + 1).  incl == nullptr: count.
__global__ void __launch_bounds__(TPB)
overlap_dense_kernel(Rows R, const int32_t* __restrict__ flags,
                     const int* __restrict__ nflag, int64_t nid,
                     uint64_t* __restrict__ table,
                     int32_t* __restrict__ dcnt,
                     const int64_t* __restrict__ incl, Out out) {
    __shared__ int64_t re_sh;
    __shared__ int scan_sh[WARPS];
    __shared__ int stop;
    uint64_t* tv = table + 2 * nid * blockIdx.x;
    uint64_t* tn = tv + nid;
    const int tid = threadIdx.x;
    if (tid == 0) stop = 0;
    for (int f = blockIdx.x; f < *nflag; f += gridDim.x) {
        const int64_t rs = flags[f];
        for (int64_t y = tid; y < nid; y += TPB) {
            tv[y] = 0;
            tn[y] = 0;
        }
        if (tid == 0) re_sh = run_end(R.xs, R.n, rs);
        __syncthreads();
        walk_pairs(R, rs, re_sh, [&](int32_t y, bool agree, uint64_t rank) {
            atomicAdd((unsigned long long*)(tv + y),
                      (unsigned long long)pair_inc(agree));
            atomicMax((unsigned long long*)(tn + y),
                      (unsigned long long)~rank);
        }, &stop);
        __syncthreads();
        if (incl == nullptr) {
            int count = 0;
            for (int64_t y0 = 0; y0 < nid; y0 += TPB) {
                const int64_t y = y0 + tid;
                count += __syncthreads_count(y < nid && tv[y] != 0);
            }
            if (tid == 0) dcnt[rs] = count;
        } else {
            int64_t o = incl[rs] - dcnt[rs];
            const int32_t x = R.xs[rs];
            for (int64_t y0 = 0; y0 < nid; y0 += TPB) {
                const int64_t y = y0 + tid;
                const uint64_t v = y < nid ? tv[y] : 0;
                int total;
                const int pos = block_excl(v != 0, &total, scan_sh);
                if (v) {
                    out.key[o + pos] = pair_key(x, (int32_t)y);
                    out.cnt[o + pos] = (int64_t)(v >> 32);
                    out.agree[o + pos] = (int64_t)(v & 0xffffffffu);
                    out.rank[o + pos] = (int64_t)~tn[y];
                }
                o += total;
            }
        }
        __syncthreads();
    }
}

Rows rows_of(const void* xs, const void* js, const void* st,
             const void* first, const void* grp, const void* yb,
             int64_t n) {
    return Rows{(const int32_t*)xs, (const int32_t*)js, (const uint8_t*)st,
                (const uint8_t*)first, (const int2*)grp,
                (const uint32_t*)yb, n};
}

}  // namespace

extern "C" {

// Launch 1 on `stream`: h int32 [n] the sorted keys (live_key), order
// int64 [n] their input positions, xs int32 and st uint8 [n] in input
// order; writes grp int32 [n, 2] (input order: group start, size), yb
// uint32 [n] (sorted order) and raises *max_group (uint32, zeroed by the
// caller).  Returns the first CUDA error.
int mz_overlap_groups(const void* h, const void* order, const void* xs,
                      const void* st, int64_t n, void* grp, void* yb,
                      void* max_group, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (n + TPB - 1) / TPB;
    overlap_groups_kernel<<<(unsigned)blocks, TPB, 0, (cudaStream_t)stream>>>(
        (const int32_t*)h, (const int64_t*)order, (const int32_t*)xs,
        (const uint8_t*)st, n, (int2*)grp, (uint32_t*)yb,
        (unsigned*)max_group);
    return (int)cudaGetLastError();
}

// The join on `stream`, a block per 256 input rows.  incl == NULL: the
// count pass, which writes each read's distinct count at its first row of
// dcnt int32 [n] (zeroed by the caller) and appends the first row of each
// read with more than `cap` distinct partners to flags int32 [n], counting
// them in *nflag (int32, zeroed).  Else the emit pass: incl int64 [n] the
// inclusive prefix of dcnt; writes the rows of every read not flagged to
// key, cnt, agree, rank int64.  Returns the first CUDA error.
int mz_overlap_join(const void* xs, const void* js, const void* st,
                    const void* first, const void* grp, const void* yb,
                    int64_t n, int cap, void* dcnt,
                    void* flags, void* nflag, const void* incl,
                    void* out_key, void* out_cnt, void* out_agree,
                    void* out_rank, void* stream) {
    if (n <= 0 || cap < 1 || cap > MAX_CAP) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)join_smem(cap);
    cudaError_t e = cudaFuncSetAttribute(
        overlap_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (n + TPB - 1) / TPB;
    overlap_join_kernel<<<(unsigned)blocks, TPB, smem,
                          (cudaStream_t)stream>>>(
        rows_of(xs, js, st, first, grp, yb, n), cap, (int32_t*)dcnt,
        (int32_t*)flags, (int*)nflag, (const int64_t*)incl,
        Out{(int64_t*)out_key, (int64_t*)out_cnt, (int64_t*)out_agree,
            (int64_t*)out_rank});
    return (int)cudaGetLastError();
}

// The overflow path on `stream`: `blocks` blocks take the *nflag flagged
// reads of flags in turn, each with its own table of dense_bytes(nid, 1)
// bytes in `table` (nid = the largest read id + 1).  incl == NULL: writes
// each flagged read's distinct count to dcnt; else its rows at its offset.
// Returns the first CUDA error.
int mz_overlap_dense(const void* xs, const void* js, const void* st,
                     const void* first, const void* grp, const void* yb,
                     int64_t n, const void* flags,
                     const void* nflag, int64_t nid, int blocks, void* table,
                     void* dcnt, const void* incl, void* out_key,
                     void* out_cnt, void* out_agree, void* out_rank,
                     void* stream) {
    if (n <= 0 || nid <= 0 || blocks < 1) return (int)cudaErrorInvalidValue;
    overlap_dense_kernel<<<(unsigned)blocks, TPB, 0, (cudaStream_t)stream>>>(
        rows_of(xs, js, st, first, grp, yb, n), (const int32_t*)flags,
        (const int*)nflag, nid, (uint64_t*)table, (int32_t*)dcnt,
        (const int64_t*)incl,
        Out{(int64_t*)out_key, (int64_t*)out_cnt, (int64_t*)out_agree,
            (int64_t*)out_rank});
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // MZ_OVERLAPS_HOST
