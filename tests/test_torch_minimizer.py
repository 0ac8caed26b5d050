"""The port's minimizer scan (modimizer_tpu_torch/ops/minimizer.py) against
the JAX package's (modimizer_tpu/ops/minimizer.py), exactly.

``minimizer_scan`` on device="cpu" (the plain version of the kernel,
``minimizer_chunk_ref``) against JAX's ``minimizer_scan`` on the same codes:
k from 8 to 24 (16 and 17 on either side of the 32/64-bit split), w = 1, 2,
31, 255 and 300 (wider than the kernel's tile), n below k, below k + w - 1,
many chunks at chunk=512 so that the halos cross, and a sequence of all A.
``minimizer_scan_host`` against JAX's on random cases, and the all-window
set against brute force.  Then a replay of ``csrc/minimizer.cu``'s schedule
in numpy (the tile path's slots, halos and runs of 16 a thread, its four
segmented scans with the kernel's shuffle steps and warp carries, the
exchanges at distance w - 1, the masked starts and the emit test; the wide
path's three launches over blocks of 4,096 positions, with the carries
across blocks), held against ``minimizer_chunk_ref`` chunk by chunk
for w from 1 to the tile's widest and past it, with mutated schedules that
must fail.
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


THREADS, RUN = 256, 16            # csrc/minimizer.cu's threads, positions each
WARPS = THREADS // 32


def hash_runs(sw, q0, k, factor1):
    """csrc/minimizer.cu's hashes of the runs of 16 positions from q0 (a
    multiple of 16, numpy int64 [...]): the run's two words, shifted once
    so that q0 is at bit 63 (w1's low half dropped), then each position at
    the constant offset 2r.  Returns (hashes, isF) [..., 16]."""
    i = q0 >> 5
    w0, w1 = sw[i], sw[i + 1]
    odd = (q0 & 31) != 0
    w0 = np.where(odd, (w0 << U64(32)) | (w1 >> U64(32)), w0)
    w1 = np.where(odd, w1 << U64(32), w1)
    t0, t1 = ~grev64(w0), ~grev64(w1)
    sh = U64(64 - 2 * k)
    hs, fs = [], []
    for r in range(RUN):
        r2 = U64(2 * r)
        if r:
            hs_, ht = ((w0 << r2) | (w1 >> (U64(64) - r2)),
                       (t0 >> r2) | (t1 << (U64(64) - r2)))
        else:
            hs_, ht = w0, t0
        f = hs_ >> sh
        c = ht & U64((1 << (2 * k)) - 1)
        with np.errstate(over="ignore"):
            hf = (f * U64(factor1)) >> sh
            hr = (c * U64(factor1)) >> sh
        hs.append(np.where(hf < hr, hf, hr).astype(np.int64))
        fs.append(hf < hr)
    return np.stack(hs, -1), np.stack(fs, -1)


def seg_scan(x, cut, fwd, is_min):
    """csrc/minimizer.cu's seg_scan on B tiles at once: x [B, THREADS, RUN],
    cut [THREADS, RUN] or [B, THREADS, RUN] (a segment's first position
    forward, its last backward).  Each thread's run, then the kernel's
    shuffle steps over the runs' (cut seen, value) pairs, the exclusive
    lane value, the warps' carries, the carry joined before the first cut
    (after the last)."""
    op = np.minimum if is_min else np.maximum
    ident = PAD if is_min else 0
    x = x.copy()
    B = len(x)
    cut = np.broadcast_to(cut, x.shape)
    run = np.full((B, THREADS), ident, np.int64)
    for r in (range(RUN) if fwd else range(RUN - 1, -1, -1)):
        run = np.where(cut[:, :, r], x[:, :, r], op(run, x[:, :, r]))
        x[:, :, r] = run
    v = run.reshape(B, WARPS, 32)
    has = cut.any(2)                                      # [B, THREADS]
    f = has.reshape(B, WARPS, 32)
    lane = np.arange(32)
    sh = 1 if fwd else -1                 # shfl_up / shfl_down
    d = 1
    while d < 32:
        ov, of = np.roll(v, sh * d, 2), np.roll(f, sh * d, 2)
        act = lane >= d if fwd else lane + d < 32
        v, f = np.where(act & ~f, op(v, ov), v), np.where(act, f | of, f)
        d <<= 1
    ev, ef = np.roll(v, sh, 2), np.roll(f, sh, 2)
    edge, agg = (0, 31) if fwd else (31, 0)
    ev[:, :, edge] = ident
    ef[:, :, edge] = False
    wv, wf = v[:, :, agg], f[:, :, agg]
    wc = np.full((B, WARPS), ident, np.int64)
    for w in range(WARPS):
        stop = np.zeros(B, bool)
        for o in (range(w - 1, -1, -1) if fwd else range(w + 1, WARPS)):
            wc[:, w] = np.where(stop, wc[:, w], op(wc[:, w], wv[:, o]))
            stop |= wf[:, o]
    carry = np.where(ef, ev, op(wc[:, :, None], ev)).reshape(B, THREADS)
    r = np.arange(RUN)
    if fwd:
        edge_r = np.where(has, cut.argmax(2), RUN)
        join = r < edge_r[:, :, None]
    else:
        edge_r = np.where(has, RUN - 1 - cut[:, :, ::-1].argmax(2), -1)
        join = r > edge_r[:, :, None]
    return np.where(join, op(x, carry[:, :, None]), x)


def tile_lanes(sw, m_ext, n_win, base, k, w, factor1, C, mutant=None):
    """The tile path, every tile at once: slot j of tile b is position
    b T - HL + j; a run of 16 slots a thread; the hashes once; P (prefix
    minima) to shared memory and S in registers; A = min(S[j], P[j + h])
    masked to 0 at the invalid starts; S' of it to shared memory, P' in
    registers; M = max(S'[j - h], P'[j]) against the thread's hash.
    Mutants: "halo" (no right halo in the tile), "neighbour" (the emit
    compared with the next position's hash), "unmasked" (the invalid
    starts keep their minima)."""
    h = w - 1
    hl, T = tmin.tile_geometry(w)
    if mutant == "halo":
        T = (tmin.TILE - hl) // 16 * 16
    B = -(-C // T)
    j = np.arange(tmin.TILE)
    q = (np.arange(B)[:, None] * T - hl) + j              # [B, TILE]
    inside = (q >= 0) & (q < C)
    q0 = np.clip(q.reshape(B, THREADS, RUN)[:, :, 0], 0, C - 16)
    hq, fq = (x.reshape(B, -1) for x in hash_runs(sw, q0, k, factor1))
    hh = np.where(inside & (q < m_ext), hq, PAD)
    mine = inside & (j >= hl) & (j < hl + T)
    out_h = np.full(C, -2, np.int64)
    out_f = np.zeros(C, bool)
    out_e = np.zeros(C, bool)
    assert len(np.unique(q[mine])) == mine.sum() == C  # each output once
    out_h[q[mine]] = hq[mine]
    out_f[q[mine]] = fq[mine]
    c = j % w
    first = (c == 0).reshape(THREADS, RUN)
    last = (c == h).reshape(THREADS, RUN)
    runs = hh.reshape(B, THREADS, RUN)
    xs = seg_scan(runs, first, True, True).reshape(B, -1)        # P
    s = seg_scan(runs, last, False, True).reshape(B, -1)         # S
    jh = np.minimum(j + h, tmin.TILE - 1)
    a = np.where(j + h < tmin.TILE, np.minimum(s, xs[:, jh]), s)
    valid = (q >= 0) & (q < C) & (q + base < n_win)
    am = a if mutant == "unmasked" else np.where(valid, a, 0)
    runs = am.reshape(B, THREADS, RUN)
    xs = seg_scan(runs, last, False, False).reshape(B, -1)       # S'
    p2 = seg_scan(runs, first, True, False).reshape(B, -1)       # P'
    m = np.maximum(xs[:, np.maximum(j - h, 0)], p2)
    ref_h = np.roll(hh, -1, 1) if mutant == "neighbour" else hh
    cov = np.maximum(0, q - h) < n_win - base
    e = (q < m_ext) & cov & (m == ref_h)
    out_e[q[mine]] = e[mine]
    return out_h, out_f, out_e


def wide_lanes(sw, m_ext, n_win, base, k, w, factor1, C, mutant=None):
    """The wide path's three launches: blocks of TILE slots from 0, segments
    of w from 0; in each block the runs of 16 hashed once and the tile
    path's segmented scans (seg_scan); the carry into a block from the
    blocks before it in its segment (forward: their prefixes at their last
    slots) or after it (backward: their suffixes at their first), the op
    over a range of those aggregates; A from S[s] and P[s + w - 1] (past
    C: P[C - 1] in the same segment, else PAD), masked to 0 at the invalid
    starts; P' and S' of it the same way; M from S'[p - w + 1] and P'[p]
    against the stored hash.  Mutants: "edge" (P past C read as PAD),
    "carry" (a forward carry's range one block short)."""
    nb = -(-C // tmin.TILE)
    q = np.arange(nb * tmin.TILE)
    blk = q // tmin.TILE
    inside = q < C
    q0 = np.minimum(q.reshape(nb, THREADS, RUN)[:, :, 0], C - 16)
    hq, fq = (x.reshape(-1) for x in hash_runs(sw, q0, k, factor1))
    hh = np.where(inside & (q < m_ext), hq, PAD)
    c = (q % w).reshape(nb, THREADS, RUN)
    b = np.arange(nb)
    f_lo = b * tmin.TILE // w * w // tmin.TILE + (mutant == "carry")
    b_hi = np.minimum((b * tmin.TILE + tmin.TILE - 1) // w * w + w - 1,
                      nb * tmin.TILE) // tmin.TILE
    f_end = (b * tmin.TILE + w - 1) // w * w   # the first segment start
    b_begin = (b + 1) * tmin.TILE // w * w     # the segment across the end

    def scan2(x, is_min):
        """P and S of x, each block's scans with their carries."""
        op = np.minimum if is_min else np.maximum
        ident = PAD if is_min else 0
        runs = x.reshape(nb, THREADS, RUN)
        pre = seg_scan(runs, c == 0, True, is_min).reshape(nb, -1)
        suf = seg_scan(runs, c == w - 1, False, is_min).reshape(nb, -1)
        af, ab = pre[:, -1], suf[:, 0]
        cf = np.array([op.reduce(af[f_lo[i]:i], initial=ident) for i in b])
        cb = np.array([op.reduce(ab[i + 1:b_hi[i] + 1], initial=ident)
                       for i in b])
        pre, suf = pre.reshape(-1), suf.reshape(-1)
        pre = np.where(q < f_end[blk], op(pre, cf[blk]), pre)
        suf = np.where(q >= b_begin[blk], op(suf, cb[blk]), suf)
        return pre, suf
    pm, sm = scan2(hh, True)
    e = q + w - 1
    pe = pm[np.minimum(e, C - 1)]
    pad_from = C if mutant == "edge" else ((C - 1) // w + 1) * w
    pe = np.where(e >= pad_from, PAD, pe)
    am = np.where(inside & (q + base < n_win), np.minimum(sm, pe), 0)
    pm2, sm2 = scan2(am, False)
    lo = q - w + 1
    m = np.where(lo >= 0, np.maximum(sm2[np.maximum(lo, 0)], pm2), pm2)
    cov = np.maximum(0, lo) < n_win - base
    emit = (q < m_ext) & cov & (m == hq)
    return hq[:C], fq[:C], emit[:C]


# w = 1, 2, 16, 31, 255, 256, 257, 300, the tile path's widest (W_TILE) and
# one more (the wide path), at k on both sides of the 32/64-bit split
REPLAY = [(8, 1, 5000), (16, 2, 5000), (16, 16, 9000), (17, 31, 9000),
          (19, 255, 9000), (11, 256, 6000), (16, 257, 7000), (13, 300, 9000),
          (16, tmin.W_TILE, 9000), (14, tmin.W_TILE + 1, 9000)]


# the wide path with segments across many blocks: (k, w, n, chunk)
WIDE = [(16, 1100, 20000, 16384), (13, 5000, 40000, 16384),
        (17, 9000, 30000, 8192)]


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


@pytest.mark.parametrize("k,w,n,chunk", WIDE)
def test_minimizer_kernel_map_wide_equals_ref(k, w, n, chunk):
    assert replay(k, w, n, chunk=chunk) == 0


@pytest.mark.parametrize("w", [3 * tmin.TILE + 96, 3 * tmin.TILE + 95,
                               tmin.TILE + 1, 2 * tmin.TILE])
def test_minimizer_kernel_map_wide_whole_chunk(w):
    """One chunk of 3 TILE + 96 positions, w up to the whole chunk: the
    carries' ranges reach its first and last blocks; live positions and
    full windows ending before C, or none."""
    C = 3 * tmin.TILE + 96
    rng = np.random.default_rng(w)
    sw = rng.integers(-(1 << 63), (1 << 63) - 1, C // 32 + 1, dtype=np.int64)
    sh = Seqhash.create(16, w, 17)
    for m_ext, n_win, base in ((C, C, 0), (C - 700, C + 50, 100),
                               (C, 3000, 0), (C, 5, 7)):
        want = tmin.minimizer_chunk_ref(torch.from_numpy(sw), m_ext, n_win,
                                        base, k=16, w=w, factor1=sh.factor1,
                                        C=C)
        got = wide_lanes(sw.view(U64), m_ext, n_win, base, 16, w,
                         sh.factor1, C)
        assert all(np.array_equal(g, x.numpy()) for g, x in zip(got, want))


@pytest.mark.parametrize("w", [16, tmin.W_TILE + 1])
def test_minimizer_kernel_map_poly_a(w):
    assert replay(16, w, 6000, poly_a=True) == 0


def test_minimizer_kernel_map_short_chunk():
    """One chunk whose live positions (m_ext) end inside its first tile,
    and the halo slots past C."""
    assert replay(16, 31, 100) == 0
    assert replay(16, 2, 40) == 0


def test_minimizer_tile_geometry():
    for w in range(1, tmin.W_TILE + 1):
        hl, T = tmin.tile_geometry(w)
        assert hl % 16 == 0 and T % 16 == 0 and hl >= w - 1
        assert hl + T + w - 1 <= tmin.TILE and T >= tmin.TILE // 2


@pytest.mark.parametrize("mutant,w", [("halo", 31), ("neighbour", 16),
                                      ("unmasked", 31), ("edge", 1100),
                                      ("carry", 5000)])
def test_minimizer_kernel_map_mutants_fail(mutant, w):
    assert replay(16, w, 9000, mutant) > 0
