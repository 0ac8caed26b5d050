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
// padding of reads to a common length.  Records go straight to their
// slots.  Slots mode (out_off null): record j of read r to slot r*cap + j
// when j < cap, the read's other slots all ones, counts[r] and the
// overflow flag (a read with more than cap records), JAX's [R, cap]
// output.  Offsets mode: a count pass (out null) and an emit pass to
// out_off[r] + j, the exact records with no cap and no retry.
//
// What bounds it on this card: the bytes (21 B a seed in, 28 B a record
// out), or the longest read's chain of dependent steps (an idmap load a
// step, whose address is the state), whichever is longer.
//
// The core (chain_read) compiles as host code too: g++ -x c++
// -DMZ_CHAIN_HOST exports mz_chain_host, which runs the same function read
// after read for the CPU tests.

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
    uint32_t loc0, locN, p0, pN, i0, iN, n1, n2;
};

__host__ __device__ __forceinline__ bool far(uint32_t a, uint32_t b) {
    const int32_t d = (int32_t)(a - b);
    return d > 50 || d < -50;
}

// modmap.c:232-241: does the seed at `loc` (sequence `id`) end the block?
__host__ __device__ __forceinline__ bool block_break(const Block& B,
                                                     uint32_t loc,
                                                     uint32_t id,
                                                     const uint32_t* idmap) {
    if (id != idmap[B.loc0]) return true;
    const uint32_t span = B.iN - B.i0;
    if (B.loc0 < B.locN)
        return loc < B.locN || far(B.locN - B.loc0, span);
    if (B.loc0 > B.locN)
        return loc > B.locN || far(B.loc0 - B.locN, span);
    return false;
}

// Runs the seeds [a, b) of one read; emit(j, rec) gets record j.  Returns
// the number of records.
template <class Emit>
__host__ __device__ int chain_read(const Seeds& S, int64_t a, int64_t b,
                                   Emit emit) {
    Block B{0, 0, 0, 0, 0, 0, 0, 0};
    int n = 0;
    for (int64_t s = a; s < b; ++s) {
        const uint8_t fl = S.flags[s];
        if (!(fl & LIVE)) continue;              // a dead seed changes nothing
        const bool one = fl & IS1;
        const uint32_t t = (uint32_t)(s - a);
        uint32_t loc = S.la[s];
        bool end = B.loc0 == 0;
        if (!end) {
            end = block_break(B, loc, S.ia[s], S.idmap);
            if (end && !one) {                   // the copy-2 retry
                loc = S.lb[s];
                end = block_break(B, loc, S.ib[s], S.idmap);
            }
        }
        const uint32_t p = S.pos[s];
        if (end) {
            if (B.n1 > 2) {
                const uint32_t rec[F] = {B.p0, B.pN, B.loc0, B.locN, B.n1,
                                         B.n2, 0};
                emit(n++, rec);
            }
            B.n1 = B.n2 = 0;
            B.loc0 = loc;
            B.i0 = t;
            B.p0 = p;
        }
        if (one) ++B.n1; else ++B.n2;
        B.locN = loc;
        B.iN = t;
        B.pN = p;
    }
    if (B.n2 > 2) {                              // modmap.c:269
        const uint32_t rec[F] = {B.p0, B.pN, B.loc0, B.locN, B.n1, B.n2, 1};
        emit(n++, rec);
    }
    return n;
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

constexpr int TPB = 128;

__global__ void __launch_bounds__(TPB)
chain_kernel(const chain_core::Seeds S, const int64_t* __restrict__ seed_off,
             int64_t R, const int64_t* __restrict__ out_off, int cap,
             uint32_t* __restrict__ out, int32_t* __restrict__ counts,
             uint8_t* __restrict__ overflow) {
    const int64_t r = (int64_t)blockIdx.x * TPB + threadIdx.x;
    if (r < R)
        chain_core::chain_one(S, seed_off, r, out_off, cap, out, counts,
                              overflow);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError().  overflow (slots mode)
// must be zeroed by the caller.
extern "C" int mz_chain_scan(const uint32_t* la, const uint32_t* lb,
                             const uint32_t* ia, const uint32_t* ib,
                             const uint8_t* flags, const uint32_t* pos,
                             const uint32_t* idmap, const int64_t* seed_off,
                             int64_t R, const int64_t* out_off, int cap,
                             uint32_t* out, int32_t* counts,
                             uint8_t* overflow, cudaStream_t stream) {
    if (R < 0 || (!out_off && cap < 0)) return (int)cudaErrorInvalidValue;
    if (R == 0) return (int)cudaGetLastError();
    const chain_core::Seeds S{la, lb, ia, ib, flags, pos, idmap};
    const int64_t nb = (R + TPB - 1) / TPB;
    chain_kernel<<<(unsigned)nb, TPB, 0, stream>>>(S, seed_off, R, out_off,
                                                   cap, out, counts,
                                                   overflow);
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

#endif
