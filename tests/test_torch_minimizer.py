"""The port's minimizer scan (modimizer_tpu_torch/ops/minimizer.py) against
the JAX package's (modimizer_tpu/ops/minimizer.py), exactly.

``minimizer_scan`` on device="cpu" (the plain version of the kernel,
``minimizer_chunk_ref``) against JAX's ``minimizer_scan`` on the same codes:
k from 8 to 24 (16 and 17 on either side of the 32/64-bit split), w = 1, 2,
31, 255 and 300 (wider than the kernel's tile), n below k, below k + w - 1,
many chunks at chunk=512 so that the halos cross, and a sequence of all A.
``minimizer_scan_host`` against JAX's on random cases, and the all-window
set against brute force.  Then a replay of ``csrc/minimizer.cu``'s index
arithmetic in numpy (the tile path's halos, its log-step passes in the
tile, the masked starts and the covered test; the wide path's passes over
the chunk), held against ``minimizer_chunk_ref`` chunk by chunk, with
mutated maps that must fail.
"""

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

from modimizer_tpu.core.seqhash import Seqhash  # noqa: E402
from modimizer_tpu.ops import minimizer as jmin  # noqa: E402
from modimizer_tpu_torch.native import lib as native_lib  # noqa: E402
from modimizer_tpu_torch.ops import minimizer as tmin  # noqa: E402

U64 = np.uint64
PAD = tmin.PAD


def codes_for(seed, n, poly_a=False):
    if poly_a:
        return np.zeros(n, np.uint8)
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


# (k, w, n): widths on both sides of the 32/64-bit split; n below k, below
# k + w - 1 (no full window), one full window, and many 512-chunks
SCAN_CASES = [(8, 1, 700), (16, 16, 3000), (17, 16, 3000), (16, 2, 1500),
              (17, 31, 5000), (24, 31, 2600), (19, 255, 3000),
              (13, 300, 4000), (16, 31, 10), (16, 31, 45), (16, 31, 46),
              (21, 5, 2100)]


@pytest.mark.parametrize("k,w,n", SCAN_CASES)
def test_minimizer_scan_equals_jax(k, w, n):
    sh = Seqhash.create(k, w, 17)
    codes = codes_for(k * 1000 + w, n)
    want = jmin.minimizer_scan(sh, codes, chunk=512)
    got = tmin.minimizer_scan(sh, codes, chunk=512, device="cpu")
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    if n >= k + w - 1 + 1000:
        assert len(got[1]) > 10 and got[1].max() > 512   # several chunks


@pytest.mark.parametrize("k,w", [(16, 16), (19, 31)])
def test_minimizer_scan_all_a_equals_jax(k, w):
    sh = Seqhash.create(k, w, 17)
    codes = codes_for(0, 2000, poly_a=True)
    want = jmin.minimizer_scan(sh, codes, chunk=512)
    got = tmin.minimizer_scan(sh, codes, chunk=512, device="cpu")
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert len(got[1]) == 2000 - k + 1          # every hash ties


def test_minimizer_scan_host_equals_jax():
    rng = np.random.default_rng(3)
    for _ in range(25):
        k = int(rng.integers(8, 24))
        w = int(rng.integers(3, 40))
        n = int(rng.integers(k, 2500))
        codes = rng.integers(0, 4, size=n).astype(np.uint8)
        sh = Seqhash.create(k, w, 17)
        for a, b in zip(tmin.minimizer_scan_host(sh, codes),
                        jmin.minimizer_scan_host(sh, codes)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (k, w, n)


def test_minimizer_scan_host_short():
    sh = Seqhash.create(16, 10, 17)
    for a, b in zip(tmin.minimizer_scan_host(sh, codes_for(1, 12)),
                    jmin.minimizer_scan_host(sh, codes_for(1, 12))):
        assert len(a) == 0 and a.dtype == b.dtype


def test_minimizer_all_window_set_brute_force():
    rng = np.random.default_rng(5)
    for _ in range(8):
        k = int(rng.integers(8, 24))
        w = int(rng.integers(3, 30))
        n = int(rng.integers(k + w + 2, 4000))
        codes = rng.integers(0, 4, size=n).astype(np.uint8)
        sh = Seqhash.create(k, w, 17)
        _km, hashes, _f = sh.scan(codes)
        want = set()
        for s0 in range(len(hashes) - w + 1):
            wnd = hashes[s0:s0 + w]
            want.update(s0 + int(j) for j in np.nonzero(wnd == wnd.min())[0])
        _du, dp, _df = tmin.minimizer_scan(sh, codes, chunk=512,
                                           device="cpu")
        assert set(dp.tolist()) == want, (k, w, n)


def test_minimizer_scan_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmin.minimizer_scan(Seqhash.create(16, 16, 17), codes_for(1, 100))


# ---------------------------------------------- the kernel's map, replayed

def chunks(sh, codes, chunk):
    """minimizer_scan's chunks: (sw int64 tensor, m_ext, n_win, base, C)."""
    k, w = sh.k, sh.w
    npos = len(codes) - k + 1
    n_win = npos - w + 1
    C = min(chunk, ((npos + 63) // 64) * 64)
    Cext = ((C + 2 * (w - 1) + 31) // 32) * 32
    for s in range(0, npos, C):
        lo = min(w - 1, s)
        base = s - lo
        seg = np.ascontiguousarray(codes[base:base + Cext + k - 1])
        sw = np.empty(Cext // 32 + 1, U64)
        native_lib().pk_pack2(seg, len(seg), sw, len(sw))
        yield (torch.from_numpy(sw.view(np.int64)), min(Cext, npos - base),
               n_win, base, Cext)


def grev64(x):
    """The 32 2-bit groups of each u64 in reverse order."""
    for s, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                 (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF),
                 (32, 0x00000000FFFFFFFF)):
        x = ((x & U64(m)) << U64(s)) | ((x >> U64(s)) & U64(m))
    return x


def hash_at(sw, q, k, factor1):
    """csrc/minimizer.cu's hash_at for positions q (numpy u64): the word
    pair, the funnel shifts both ways, the multiply and the strand."""
    i = q >> 5
    r2 = (2 * (q & 31)).astype(U64)
    w0, w1 = sw[i], sw[i + 1]
    t0, t1 = ~grev64(w0), ~grev64(w1)
    inv = np.where(r2 == 0, U64(1), U64(64) - r2)     # unused where r2 = 0
    hs = np.where(r2 == 0, w0, (w0 << r2) | (w1 >> inv))
    ht = np.where(r2 == 0, t0, (t0 >> r2) | (t1 << inv))
    sh = U64(64 - 2 * k)
    f = hs >> sh
    c = ht & U64((1 << (2 * k)) - 1)
    with np.errstate(over="ignore"):
        hf = (f * U64(factor1)) >> sh
        hr = (c * U64(factor1)) >> sh
    isf = hf < hr
    return np.where(isf, hf, hr).astype(np.int64), isf


def log_passes(x, w, op, pad):
    """The kernel's log-step passes: after them x[j] = op(x[j .. j+w-1]),
    ``pad`` past the end; two buffers in turn."""
    done = 1
    while done < w:
        step = min(done, w - done)
        nxt = x.copy()
        nxt[:len(x) - step] = op(x[:len(x) - step], x[step:])
        nxt[len(x) - step:] = op(x[len(x) - step:], pad)
        x = nxt
        done += step
    return x


def tile_lanes(sw, m_ext, n_win, base, k, w, factor1, C, mutant=None):
    """The tile path, block by block: hashes of q = t0 - h + j into the
    tile (h = w - 1 each side), A by log-step minima, invalid starts to 0,
    M by log-step maxima over the LA = T + h starts, covered from the first
    start, the emit.  Mutants: "halo" (the tile starts one position late),
    "m_shift" (M of p read from the windows of p + 1), "unmasked" (the
    invalid starts keep their minima).  (Taking the first covering start as
    p - w is no mutant: every live p is covered.)"""
    T, h = tmin.TILE, w - 1
    L, LA = T + 2 * h, T + h
    out_h = np.full(C, -2, np.int64)
    out_f = np.zeros(C, bool)
    out_e = np.zeros(C, bool)
    for t0 in range(0, C, T):
        q = t0 - h + np.arange(L) + (mutant == "halo")
        inside = (q >= 0) & (q < C)
        hq, fq = hash_at(sw, np.clip(q, 0, C - 1), k, factor1)
        v = np.where(inside & (q < m_ext), hq, PAD)
        mine = inside & (np.arange(L) >= h) & (np.arange(L) < h + T)
        out_h[q[mine]] = hq[mine]
        out_f[q[mine]] = fq[mine]
        a = log_passes(v, w, np.minimum, PAD)[:LA]
        s = t0 - h + np.arange(LA)
        valid = (s >= 0) & (s < C) & (s + base < n_win)
        am = a if mutant == "unmasked" else np.where(valid, a, 0)
        m = log_passes(am, w, np.maximum, 0)
        m = m[1:T + 1] if mutant == "m_shift" else m[:T]
        p = t0 + np.arange(T)
        keep = p < C
        lo = np.maximum(0, p - w + 1)
        cov = lo < n_win - base
        hp, _ = hash_at(sw, np.clip(p, 0, C - 1), k, factor1)
        e = (p < m_ext) & cov & (m == hp)
        out_e[p[keep]] = e[keep]
    return out_h, out_f, out_e


def wide_lanes(sw, m_ext, n_win, base, k, w, factor1, C, mutant=None):
    """The wide path: hashes (hh padded past m_ext), forward min passes,
    the mask, backward max passes (0 before position 0), the emit.  Mutant
    "forward_max": the max passes look forward."""
    q = np.arange(C)
    hq, fq = hash_at(sw, q, k, factor1)
    a = log_passes(np.where(q < m_ext, hq, PAD), w, np.minimum, PAD)
    a = np.where(q + base < n_win, a, 0)
    if mutant == "forward_max":
        m = log_passes(a, w, np.maximum, 0)
    else:
        m = log_passes(a[::-1], w, np.maximum, 0)[::-1]
    cov = np.maximum(0, q - w + 1) < n_win - base
    return hq, fq, (q < m_ext) & cov & (m == hq)


REPLAY = [(16, 16, 9000), (17, 31, 9000), (8, 1, 5000), (16, 2, 5000),
          (19, 255, 9000), (11, 256, 6000), (16, 257, 7000), (13, 300, 9000)]


def replay(k, w, n, mutant=None, chunk=4096, poly_a=False):
    """Every chunk of a sequence through the replay of the kernel's path
    for w; returns the number of chunks that differ from
    minimizer_chunk_ref."""
    sh = Seqhash.create(k, w, 17)
    lanes = tile_lanes if w <= tmin.W_TILE else wide_lanes
    bad = 0
    for sw, m_ext, n_win, base, C in chunks(sh, codes_for(n + w, n, poly_a),
                                            chunk):
        want = tmin.minimizer_chunk_ref(sw, m_ext, n_win, base, k=k, w=w,
                                        factor1=sh.factor1, C=C)
        got = lanes(sw.numpy().view(U64), m_ext, n_win, base, k, w,
                    sh.factor1, C, mutant)
        bad += not all(np.array_equal(g, x.numpy())
                       for g, x in zip(got, want))
    return bad


@pytest.mark.parametrize("k,w,n", REPLAY)
def test_minimizer_kernel_map_equals_ref(k, w, n):
    assert replay(k, w, n) == 0


def test_minimizer_kernel_map_poly_a():
    assert replay(16, 16, 6000, poly_a=True) == 0


@pytest.mark.parametrize("mutant,w", [("halo", 31), ("m_shift", 16),
                                      ("unmasked", 31),
                                      ("forward_max", 300)])
def test_minimizer_kernel_map_mutants_fail(mutant, w):
    assert replay(16, w, 9000, mutant) > 0
