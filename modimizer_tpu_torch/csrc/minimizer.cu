// The all-window minimizer pass over one chunk of hash positions (sm_90a).
//
// Replaces modimizer_tpu/ops/minimizer.py::_minimizer_chunk (:135-159),
// an XLA program.  Contract (modimizer_tpu_torch/ops/minimizer.py::
// minimizer_chunk_ref), for the C positions p of a chunk (C a multiple of
// 32, sw holding C/32 + 1 big-endian-per-word packed words):
//   fwd, rc, hf, hr, isF and the canonical hash as in scan_compact.cu;
//   hh[p]  = hash[p] for p < m_ext, else PAD (INT64_MAX; JAX pads with the
//            all-ones u64, which is above every hash too);
//   A[s]   = min(hh[s .. s+w-1]), positions at or past C reading PAD;
//   valid  = s + base < n_win (a full window of the whole sequence);
//   M[p]   = max over valid s in [p-w+1, p] of A[s] (0 where none);
//   emit   = M[p] == hh[p] and p < m_ext and some valid s covers p.
// Outputs: hash[C] (int64, the unpadded canonical hash), isF[C] and
// emit[C] (bytes).  Hashes are below 2^62 (k <= 31), so int64 order is
// their u64 order.
//
// Design.  Tile path (w <= W_TILE): a block owns T output positions
// [t0, t0+T); it computes the hashes of [t0-(w-1), t0+T+(w-1)) into shared
// memory (both halos of w-1), takes A over the tile by log-step shifted
// minima (ceil(log2 w) passes, two shared buffers in turn), masks the
// invalid starts to 0 and takes M by log-step shifted maxima the same way.
// `covered` needs no pass: the valid starts are the prefix s < n_win -
// base, so p is covered when max(0, p-w+1) < n_win - base.  Wide path
// (w > W_TILE, where the halos no longer fit in shared memory): the same
// log-step passes over the whole chunk in global memory, a launch a pass,
// in a scratch of 2C int64 (hh, then A and M in turn).
//
// What bounds it on this card: bytes for the tile path at small w (C/4
// bytes of bases in, 10 B a position out), shared-memory passes as w
// grows (2 ceil(log2 w) passes over T + 2(w-1) values a tile).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int T = 2048;                 // output positions a tile
constexpr int W_TILE = 256;             // widest w on the tile path
constexpr int L_MAX = T + 2 * (W_TILE - 1);
constexpr int64_t PAD = INT64_MAX;

struct Params {
    int64_t C, m_ext, n_win, base;
    uint64_t factor1;
    int k, w;
};

// complement of x with its 32 2-bit groups reversed (tw = ~grev64(sw))
__device__ __forceinline__ uint64_t rc64(uint64_t x) {
    x = __brevll(x);
    return ~(((x >> 1) & 0x5555555555555555ull)
             | ((x & 0x5555555555555555ull) << 1));
}

// Canonical hash and strand of position q in [0, C).
__device__ __forceinline__ int64_t hash_at(const uint64_t* __restrict__ sw,
                                           int64_t q, const Params& P,
                                           bool& isF) {
    const int64_t i = q >> 5;
    const int r2 = 2 * (int)(q & 31);
    const uint64_t w0 = sw[i], w1 = sw[i + 1];
    const uint64_t t0 = rc64(w0), t1 = rc64(w1);
    const uint64_t hs = r2 ? (w0 << r2) | (w1 >> (64 - r2)) : w0;
    const uint64_t ht = r2 ? (t0 >> r2) | (t1 << (64 - r2)) : t0;
    const int sh = 64 - 2 * P.k;
    const uint64_t f = hs >> sh;
    const uint64_t c = ht & ((1ull << (2 * P.k)) - 1);
    const uint64_t hf = (f * P.factor1) >> sh, hr = (c * P.factor1) >> sh;
    isF = hf < hr;
    return (int64_t)(isF ? hf : hr);
}

__device__ __forceinline__ bool covered(int64_t p, const Params& P) {
    const int64_t lo = p - P.w + 1 > 0 ? p - P.w + 1 : 0;
    return lo < P.n_win - P.base;
}

__device__ __forceinline__ int64_t masked(int64_t a, int64_t s,
                                          const Params& P) {
    return s >= 0 && s < P.C && s + P.base < P.n_win ? a : 0;
}

// ---------------------------------------------------------- tile path

__global__ void __launch_bounds__(THREADS)
minimizer_tile(const uint64_t* __restrict__ sw, const Params P,
               int64_t* __restrict__ out_h, uint8_t* __restrict__ out_f,
               uint8_t* __restrict__ out_e) {
    __shared__ int64_t buf[2][L_MAX];
    const int64_t t0 = (int64_t)blockIdx.x * T;
    const int h = P.w - 1;                       // each halo
    const int L = T + 2 * h;                     // hashes a tile
    const int LA = T + h;                        // window starts a tile
    // hashes of q = t0 - h + j
    for (int j = threadIdx.x; j < L; j += THREADS) {
        const int64_t q = t0 - h + j;
        int64_t v = PAD;
        if (q >= 0 && q < P.C) {
            bool f;
            const int64_t x = hash_at(sw, q, P, f);
            if (q < P.m_ext) v = x;
            if (j >= h && j < h + T) {
                out_h[q] = x;
                out_f[q] = f;
            }
        }
        buf[0][j] = v;
    }
    __syncthreads();
    // A[t0 - h + j] = min(buf[j .. j+w-1]): log-step shifted minima
    int cur = 0;
    for (int done = 1; done < P.w;) {
        const int step = min(done, P.w - done);
        const int64_t* src = buf[cur];
        int64_t* dst = buf[cur ^ 1];
        for (int j = threadIdx.x; j < L; j += THREADS) {
            const int64_t a = src[j];
            const int64_t b = j + step < L ? src[j + step] : PAD;
            dst[j] = a < b ? a : b;
        }
        cur ^= 1;
        done += step;
        __syncthreads();
    }
    // the starts that are not full windows count 0
    {
        const int64_t* src = buf[cur];
        int64_t* dst = buf[cur ^ 1];
        for (int j = threadIdx.x; j < LA; j += THREADS)
            dst[j] = masked(src[j], t0 - h + j, P);
        cur ^= 1;
        __syncthreads();
    }
    // M[t0 + i] = max(Am[i .. i+w-1]) over the LA starts
    for (int done = 1; done < P.w;) {
        const int step = min(done, P.w - done);
        const int64_t* src = buf[cur];
        int64_t* dst = buf[cur ^ 1];
        for (int j = threadIdx.x; j < LA; j += THREADS) {
            const int64_t a = src[j];
            const int64_t b = j + step < LA ? src[j + step] : 0;
            dst[j] = a > b ? a : b;
        }
        cur ^= 1;
        done += step;
        __syncthreads();
    }
    for (int i = threadIdx.x; i < T; i += THREADS) {
        const int64_t p = t0 + i;
        if (p >= P.C) break;
        bool e = false;
        if (p < P.m_ext && covered(p, P)) {
            bool f;
            e = buf[cur][i] == hash_at(sw, p, P, f);
        }
        out_e[p] = e;
    }
}

// ---------------------------------------------------------- wide path

__global__ void minimizer_hash(const uint64_t* __restrict__ sw,
                               const Params P, int64_t* __restrict__ out_h,
                               uint8_t* __restrict__ out_f,
                               int64_t* __restrict__ hh) {
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         q < P.C; q += (int64_t)gridDim.x * blockDim.x) {
        bool f;
        const int64_t x = hash_at(sw, q, P, f);
        out_h[q] = x;
        out_f[q] = f;
        hh[q] = q < P.m_ext ? x : PAD;
    }
}

// dst[i] = min(src[i], src[i + step]) (PAD past C), forward windows
__global__ void minimizer_min_step(const int64_t* __restrict__ src,
                                   int64_t* __restrict__ dst, int64_t C,
                                   int64_t step) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < C;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int64_t a = src[i];
        const int64_t b = i + step < C ? src[i + step] : PAD;
        dst[i] = a < b ? a : b;
    }
}

__global__ void minimizer_mask(int64_t* __restrict__ a, const Params P) {
    for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         s < P.C; s += (int64_t)gridDim.x * blockDim.x)
        a[s] = masked(a[s], s, P);
}

// dst[i] = max(src[i], src[i - step]) (0 before 0), backward windows
__global__ void minimizer_max_step(const int64_t* __restrict__ src,
                                   int64_t* __restrict__ dst, int64_t C,
                                   int64_t step) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < C;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int64_t a = src[i];
        const int64_t b = i - step >= 0 ? src[i - step] : 0;
        dst[i] = a > b ? a : b;
    }
}

__global__ void minimizer_emit(const int64_t* __restrict__ M,
                               const int64_t* __restrict__ out_h,
                               const Params P, uint8_t* __restrict__ out_e) {
    for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         p < P.C; p += (int64_t)gridDim.x * blockDim.x)
        out_e[p] = p < P.m_ext && covered(p, P) && M[p] == out_h[p];
}

}  // namespace

extern "C" int mz_minimizer_tile() { return T; }
extern "C" int mz_minimizer_w_tile() { return W_TILE; }

// Launch on `stream`; returns cudaGetLastError().  C is a multiple of 32
// with C/32 + 1 words in sw; scratch holds 2C int64 when w > W_TILE (null
// otherwise).
extern "C" int mz_minimizer_chunk(const uint64_t* sw, int64_t C,
                                  int64_t m_ext, int64_t n_win, int64_t base,
                                  int k, int64_t w, uint64_t factor1,
                                  int64_t* out_h, uint8_t* out_f,
                                  uint8_t* out_e, int64_t* scratch,
                                  cudaStream_t stream) {
    if (C <= 0 || C % 32 || k < 1 || k > 31 || w < 1 || w > C
        || (w > W_TILE && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    const Params P{C, m_ext, n_win, base, factor1, k, (int)w};
    if (w <= W_TILE) {
        const int64_t nb = (C + T - 1) / T;
        minimizer_tile<<<(unsigned)nb, THREADS, 0, stream>>>(sw, P, out_h,
                                                            out_f, out_e);
        return (int)cudaGetLastError();
    }
    const int grid = 132 * 8, tpb = 256;
    int64_t* a = scratch;
    int64_t* b = scratch + C;
    minimizer_hash<<<grid, tpb, 0, stream>>>(sw, P, out_h, out_f, a);
    for (int64_t done = 1; done < w;) {
        const int64_t step = done < w - done ? done : w - done;
        minimizer_min_step<<<grid, tpb, 0, stream>>>(a, b, C, step);
        int64_t* t = a; a = b; b = t;
        done += step;
    }
    minimizer_mask<<<grid, tpb, 0, stream>>>(a, P);
    for (int64_t done = 1; done < w;) {
        const int64_t step = done < w - done ? done : w - done;
        minimizer_max_step<<<grid, tpb, 0, stream>>>(a, b, C, step);
        int64_t* t = a; a = b; b = t;
        done += step;
    }
    minimizer_emit<<<grid, tpb, 0, stream>>>(a, out_h, P, out_e);
    return (int)cudaGetLastError();
}
