"""modasm phase 2 of -b and -c in two steps (``native/modasm_native.cpp``):
the answer pass ``rs_phase2_answers`` (OpenMP over reads) computes each
candidate pair's isPlus, isContained, nBadOrder and nBadFlip and each read's
nRepeat; the in-order step of ``rs_mark_bad_pre`` and
``rs_mark_contained_pre`` sets the flags from them.

The answer pass is held, row by row, against a NumPy re-derivation of
``foPhase2`` written here, on tests/test_overlaps.py's ``make_readset``
seeds, on readsets of the benchmark cell's shape (reads drawn from a
genome of mods on both strands, some contained, a few repeated mods) and
on edge readsets (a self pair, a read with repeats, the nHit < 3 break,
wrapped U16 counts, a minus-strand contained pair, reads without
candidates, a bad y that must be skipped).  The two engines, at 1 and at 4
OpenMP threads, are held against the serial walk (``rs_mark_bad`` then
``rs_mark_contained``): ``bad[]``, ``contained[]`` and the MB and MC
lines.  The counter ``phase2.pairs`` of a recording ``modasm -b -c`` job
is the rows the answer pass answered.  Candidates are phase 1's, from
``Readset.device_overlap_candidates`` on the CPU."""

import contextlib
import ctypes
import io
import os
import types

import numpy as np
import pytest

from modimizer_tpu_torch.cli import modasm, modutils
from modimizer_tpu_torch.core.readset import Readset
from modimizer_tpu_torch.native import lib
from modimizer_tpu_torch.utils import profiling
from tests.test_overlaps import make_readset

TOPBIT = 0x80000000
TOPMASK = 0x7FFFFFFF
BAD_REPEAT, BAD_NOMATCH, BAD_LOWHIT = 1, 8, 16


class _Modset:
    """The modset fields the native view reads."""

    def __init__(self, info, depth):
        self.info = np.ascontiguousarray(info, np.uint8)
        self.depth = np.ascontiguousarray(depth, np.uint16)
        self.max = len(self.info) - 1
        self.hasher = types.SimpleNamespace(w=31)


def readset(hits, off, dx, rlen, info):
    """A port Readset over the CSR rows (read 0 empty), its depth counted
    from the hits and saturated as the readset's build does, then
    inv_build (the serial walk's inverse lists, nCopy)."""
    hits = np.ascontiguousarray(hits, np.uint32)
    info = np.asarray(info, np.uint8)
    depth = np.minimum(np.bincount(hits & TOPMASK, minlength=len(info)),
                       0xFFFF)
    rs = Readset(_Modset(info, depth))
    n = len(off) - 1
    rs.n_reads = n
    rs.len = np.ascontiguousarray(rlen, np.int32)
    rs.hit_off = np.ascontiguousarray(off, np.int64)
    rs.n_hit = np.diff(rs.hit_off).astype(np.int32)
    rs.n_miss = np.zeros(n, np.int32)
    rs.bad = np.zeros(n, np.uint8)
    rs.other_flags = np.zeros(n, np.uint8)
    rs.contained = np.zeros(n, np.int32)
    rs.n_copy = np.zeros((n, 4), np.int32)
    rs.hits = hits
    rs.dx = np.ascontiguousarray(dx, np.uint16)
    rs.tot_hit = len(hits)
    rs.inv_build()
    return rs


def from_make_readset(seed):
    """tests/test_overlaps.py's readset, with gaps and lengths drawn from
    the same seed."""
    fake = make_readset(seed)
    rng = np.random.default_rng(1000 + seed)
    off = fake.hit_off
    dx = rng.integers(1, 120, len(fake.hits)).astype(np.uint16)
    rlen = np.array([int(dx[off[r]:off[r + 1]].sum()) + int(
        rng.integers(19, 80)) if off[r + 1] > off[r] else 0
        for r in range(len(off) - 1)], np.int32)
    return readset(fake.hits, off, dx, rlen, fake.ms.info)


def cell_shape(seed, n_reads=240, slots=4000):
    """The benchmark cell's kind at a small size: a genome of mods (one
    every 20-80 bases; ids unique but for 1 % of the slots, which repeat
    another slot's id), reads of lognormal length (about 8x coverage),
    every second reverse-complemented (order and strands flipped), 3 % of
    the hits dropped and 2 % added at random; 80 % of the mods copy-1."""
    rng = np.random.default_rng(seed)
    gpos = np.cumsum(rng.integers(20, 80, slots))
    glen = int(gpos[-1]) + 100
    gmod = rng.permutation(slots).astype(np.int64) + 1
    dup = rng.random(slots) < 0.01
    gmod[dup] = gmod[rng.integers(0, slots, int(dup.sum()))]
    gstr = rng.integers(0, 2, slots)
    info = np.where(rng.random(slots + 1) < 0.8, 1,
                    rng.choice([0, 2, 3], slots + 1)).astype(np.uint8)
    info[0] = 0
    hits, dxs, rlen, off = [], [], [0], [0, 0]
    for i in range(n_reads - 1):
        L = int(np.clip(rng.lognormal(np.log(9000), 0.5), 1500, glen - 1))
        s = int(rng.integers(0, glen - L))
        sel = np.flatnonzero((gpos >= s) & (gpos < s + L))
        sel = sel[rng.random(len(sel)) >= 0.03]
        p, m, st = gpos[sel] - s, gmod[sel], gstr[sel]
        n_add = int(rng.binomial(len(sel), 0.02))
        p = np.concatenate([p, rng.integers(0, L, n_add)])
        m = np.concatenate([m, rng.integers(1, slots + 1, n_add)])
        st = np.concatenate([st, rng.integers(0, 2, n_add)])
        if i % 2:
            p, st = L - 1 - p, 1 - st
        o = np.argsort(p, kind="stable")
        p, m, st = p[o], m[o], st[o]
        hits.append(m.astype(np.uint32) | np.where(st == 1, TOPBIT, 0)
                    .astype(np.uint32))
        dxs.append(np.diff(p, prepend=0))
        rlen.append(L)
        off.append(off[-1] + len(m))
    return readset(np.concatenate(hits), off, np.concatenate(dxs), rlen,
                   info)


def listed(reads, info, gap=50):
    """A readset of ``reads``: per read a list of (mod, strand) or
    (mod, strand, gap); a read's length is its last position + gap."""
    hits, dx, rlen, off = [], [], [], [0]
    for r in reads:
        pos = 0
        for k, h in enumerate(r):
            g = h[2] if len(h) > 2 else gap
            pos += g if k else g // 2
            hits.append(h[0] | (TOPBIT if h[1] else 0))
            dx.append(g if k else g // 2)
        rlen.append(pos + gap if r else 0)
        off.append(len(hits))
    return readset(np.array(hits, np.uint32), off, np.array(dx, np.uint16),
                   rlen, info)


# mods 1-40 copy-1, 41-45 copy 0, 46-50 copy 2
INFO = np.array([0] + [1] * 40 + [0] * 5 + [2] * 5, np.uint8)


def edge(case):
    if case == "self_pair":
        # two reads on the same strand, the second inside the first
        return listed([[], [(m, 0) for m in range(1, 13)],
                       [(m, 0) for m in range(4, 9)]], INFO)
    if case == "repeats":
        # read 1 repeats mod 1: BAD_REPEAT before its own self pair;
        # read 2 shares its mods
        return listed([[], [(1, 0), (2, 0), (3, 0), (1, 0), (4, 0), (5, 0)],
                       [(m, 0) for m in range(1, 7)]], INFO)
    if case == "break":
        # read 1 shares 3 mods with read 2 and 2 with read 3
        return listed([[], [(m, 0) for m in (1, 2, 3, 4, 5, 6, 7)],
                       [(m, 0) for m in (1, 2, 3, 20, 21)],
                       [(m, 0) for m in (6, 7, 30, 31)]], INFO)
    if case == "wrapped":
        # read 2 holds mods 1-3 65,539 times (a count of 3 once wrapped),
        # read 3 mods 4-6 65,537 times (1 once wrapped: past the break);
        # strands alternate, so nBadFlip and nBadOrder are large
        y = [(1 + k % 3, (k // 3) & 1, 1) for k in range(65539)]
        w = [(4 + k % 3, k & 1, 1) for k in range(65537)]
        return listed([[], [(m, 0) for m in range(1, 10)], y, w], INFO)
    if case == "minus_contained":
        # read 2 lies inside read 1 on the other strand (reversed order,
        # strands flipped); read 3 inside read 1 on the same strand
        one = [(m, m & 1) for m in range(1, 21)]
        two = [(m, 1 - (m & 1)) for m in range(14, 4, -1)]
        three = [(m, m & 1) for m in range(8, 16)]
        return listed([[], one, two, three], INFO)
    if case == "no_candidates":
        # read 1 only copy-0 and copy-2 mods, read 2 no hit, read 4 a
        # single copy-1 mod (a self pair of count 1: past the break)
        return listed([[], [(41, 0), (42, 1), (46, 0), (47, 0)], [],
                       [(m, 0) for m in range(1, 8)], [(20, 1)]], INFO)
    if case == "bad_y_skipped":
        # read 1 repeats mod 1 (bad from its visit on); read 2 lies inside
        # it on the same strand: y = 1 is skipped, so read 2 is not
        # contained; read 3 repeats too and matches only read 1 and
        # itself, both bad: no match
        return listed([[], [(m, 0) for m in (1, 2, 3, 4, 5, 6, 7, 8, 1)],
                       [(m, 0) for m in (3, 4, 5, 6)],
                       [(m, 0) for m in (2, 3, 4, 2)]], INFO)
    raise ValueError(case)


EDGES = ("self_pair", "repeats", "break", "wrapped", "minus_contained",
         "no_candidates", "bad_y_skipped")
CASES = ([("make_readset", s) for s in range(6)]
         + [("cell_shape", s) for s in range(3)]
         + [("edge", c) for c in EDGES])
IDS = ["%s-%s" % c for c in CASES]


def build(kind, arg):
    return {"make_readset": from_make_readset, "cell_shape": cell_shape,
            "edge": edge}[kind](arg)


def candidates(rs):
    return rs.device_overlap_candidates(device="cpu")


# ---- the NumPy re-derivation of foPhase2 ----

def _i32(v):
    """C int arithmetic: wrap to 32 bits."""
    return ((np.asarray(v, np.int64) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _c_int(d):
    """(int) of a double on x86: truncation, INT_MIN out of range."""
    d = np.trunc(np.asarray(d, np.float64))
    ok = (d >= -2.0 ** 31) & (d < 2.0 ** 31)
    return np.where(ok, d, -2.0 ** 31).astype(np.int64)


def numpy_answers(rs, cy, ch, co, visit):
    """Per candidate row isPlus, isContained, nBadOrder, nBadFlip, and per
    read the rows answered and nRepeat, as foPhase2 computes them for the
    reads ``visit`` marks; zero elsewhere."""
    n, rows = rs.n_reads, len(cy)
    plus, cont = np.zeros(rows, np.uint8), np.zeros(rows, np.uint8)
    order, flip = np.zeros(rows, np.uint16), np.zeros(rows, np.uint16)
    n_rows, n_rep = np.zeros(n, np.int32), np.zeros(n, np.int32)
    c1 = (rs.ms.info & 3) == 1
    off = rs.hit_off
    for x in range(1, n):
        if not visit[x]:
            continue
        hx = rs.hits[off[x]:off[x + 1]]
        xpos = np.concatenate([[0], np.cumsum(rs.dx[off[x]:off[x + 1]],
                                              dtype=np.uint32)])
        x_len, nhx = int(rs.len[x]), len(hx)
        hmap = np.zeros(len(rs.ms.info), np.uint16)
        for j, m in enumerate(hx & TOPMASK):
            if not c1[m]:
                continue
            if hmap[m]:
                n_rep[x] += 1
            else:
                hmap[m] = (j + 1) & 0xFFFF
        for r in range(co[x], co[x + 1]):
            if ch[r] < 3:
                break
            n_rows[x] += 1
            y = int(cy[r])
            hy = rs.hits[off[y]:off[y + 1]]
            ypos = np.cumsum(rs.dx[off[y]:off[y + 1]].astype(np.int64))
            ihx = hmap[hy & TOPMASK].astype(np.int64)
            m = ihx > 0
            k, yp = ihx[m], ypos[m].astype(np.float64)
            same = (hy[m] & TOPBIT) == (hx[k - 1] & TOPBIT)
            n_plus, n_minus = int(same.sum()), int((~same).sum())
            y_len = int(rs.len[y])
            if n_plus > n_minus:
                plus[r], flip[r] = 1, n_minus & 0xFFFF
                diff = _c_int(xpos[k].astype(np.float64) - yp)
                order[r] = int((k[1:] < k[:-1]).sum()) & 0xFFFF
                contained = diff[0] < 0          # the first match: last == 0
                last_diff = diff[-1]
            elif n_minus and not n_plus:
                wrapped = (x_len - xpos[k].astype(np.int64)) % 2 ** 32
                diff = _c_int(wrapped.astype(np.float64) - yp)
                prev = np.concatenate([[nhx], k[:-1]])
                order[r] = int((k > prev).sum()) & 0xFFFF
                contained = nhx == 0 and diff[0] < 0   # last starts at nHitX
                last_diff = diff[-1]
            else:
                continue
            if contained and _i32(x_len - last_diff) > y_len:
                contained = False
            cont[r] = contained
    return plus, cont, order, flip, n_rows, n_rep


@contextlib.contextmanager
def omp_threads(n):
    """OpenMP's threads for the native library's passes on this thread."""
    L = lib()
    was = L.io_max_threads()
    L.omp_set_num_threads(n)
    try:
        assert L.io_max_threads() == n
        yield
    finally:
        L.omp_set_num_threads(was)


def native_answers(rs, cy, ch, co, skip_bad, threads):
    rows, n = len(cy), rs.n_reads
    out = (np.full(rows, 7, np.uint8), np.full(rows, 7, np.uint8),
           np.full(rows, 7, np.uint16), np.full(rows, 7, np.uint16),
           np.full(n, 7, np.int32), np.full(n, 7, np.int32))
    with omp_threads(threads):
        total = lib().rs_phase2_answers(ctypes.byref(rs._view()), cy, ch,
                                        co, skip_bad, *out)
    return out, total


NAMES = ("isPlus", "isContained", "nBadOrder", "nBadFlip", "nRows",
         "nRepeat")


def check_answers(got, total, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name
    assert total == int(want[4].sum())


@pytest.mark.parametrize("kind,arg", CASES, ids=IDS)
def test_answers_match_numpy(kind, arg):
    rs = build(kind, arg)
    cy, ch, co = candidates(rs)
    want = numpy_answers(rs, cy, ch, co, np.ones(rs.n_reads, bool))
    for threads in (1, 4):
        check_answers(*native_answers(rs, cy, ch, co, 0, threads), want)


@pytest.mark.parametrize("kind,arg", CASES[::3], ids=IDS[::3])
def test_answers_skip_the_bad_reads(kind, arg):
    """skipBad: a read bad when the pass starts has no answers."""
    rs = build(kind, arg)
    cy, ch, co = candidates(rs)
    rs.bad[np.random.default_rng(5).random(rs.n_reads) < 0.4] = BAD_REPEAT
    want = numpy_answers(rs, cy, ch, co, rs.bad == 0)
    check_answers(*native_answers(rs, cy, ch, co, 1, 3), want)


def test_edges_read_as_foPhase2_answers_them():
    """What the edge readsets must give, spelled out."""
    def answers(case):
        rs = edge(case)
        cy, ch, co = candidates(rs)
        got, _total = native_answers(rs, cy, ch, co, 0, 2)
        rows = {(x, int(cy[r])): tuple(int(a[r]) for a in got[:4])
                for x in range(1, rs.n_reads) for r in range(co[x], co[x + 1])}
        return rows, got[4], got[5], ch, co

    rows, n_rows, rep, _ch, _co = answers("self_pair")
    assert rows[(1, 1)] == rows[(2, 2)] == (1, 0, 0, 0)
    assert rows[(2, 1)] == (1, 1, 0, 0) and rows[(1, 2)] == (1, 0, 0, 0)
    rows, n_rows, rep, _ch, _co = answers("repeats")
    assert list(rep) == [0, 1, 0]
    assert rows[(1, 1)] == (1, 0, 1, 0)          # mod 1's first row again
    rows, n_rows, rep, ch, co = answers("break")
    assert list(n_rows) == [0, 2, 2, 1]           # read 1: itself, read 2
    assert list(ch[co[1]:co[2]]) == [7, 3, 2]
    rows, n_rows, rep, ch, co = answers("wrapped")
    assert list(ch[co[1]:co[2]]) == [9, 3, 1] and n_rows[1] == 2
    assert rows[(1, 2)][0] == 1 and rows[(1, 2)][3] == 32769 & 0xFFFF
    assert rep[2] == 65536 and rep[3] == 65534
    rows, n_rows, rep, _ch, _co = answers("minus_contained")
    assert rows[(2, 1)] == (0, 0, 0, 0)          # minus: never contained
    assert rows[(3, 1)] == (1, 1, 0, 0)
    rows, n_rows, rep, ch, co = answers("no_candidates")
    assert co[2] - co[1] == 0 and co[3] - co[2] == 0
    assert list(ch[co[4]:co[5]]) == [1] and n_rows[4] == 0


@pytest.mark.parametrize("kind,arg", CASES, ids=IDS)
def test_rh_lines_match_the_jax_package(kind, arg, tmp_path):
    """foPhase2 and the answer pass share one per-pair routine: the serial
    walk's RH and RR lines (``-o1``'s level 2) for every read in turn, and
    the flags it leaves, against the JAX package's native library, whose
    foPhase2 is the code before the split."""
    from modimizer_tpu import native as jax_native
    texts, bads = [], []
    for L, view_type in ((lib(), None), (jax_native.lib(), jax_native.RSView)):
        rs = build(kind, arg)
        path = tmp_path / ("%d.out" % len(texts))
        with open(path, "w") as f:
            v = rs._view(f.fileno(), f.fileno())
            ref = (ctypes.byref(v) if view_type is None else ctypes.cast(
                ctypes.pointer(v), ctypes.POINTER(view_type)))
            for ix in range(1, rs.n_reads):
                L.rs_find_overlaps(ref, ix, 2)
        texts.append(path.read_text())
        bads.append(rs.bad)
    assert texts[0] == texts[1] and texts[0].count("RR ") == rs.n_reads - 1
    assert np.array_equal(bads[0], bads[1])


# ---- the engines against the serial walk ----

def run_engines(rs, path, cands=None):
    """-b then -c, each engine's MB/MC lines written to ``path``; the
    serial walk without ``cands``.  Returns the lines and the engines'
    results."""
    got = []
    with open(path, "w") as f:
        v = rs._view(f.fileno(), f.fileno())
        for name in ("rs_mark_bad", "rs_mark_contained"):
            if cands is None:
                got.append(getattr(lib(), name)(ctypes.byref(v)))
            else:
                got.append(getattr(lib(), name + "_pre")(ctypes.byref(v),
                                                         *cands))
    with open(path) as f:
        return f.read(), got


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("kind,arg", CASES, ids=IDS)
def test_engines_match_the_serial_walk(kind, arg, threads, tmp_path):
    serial, pre = build(kind, arg), build(kind, arg)
    cands = candidates(pre)
    want, _ = run_engines(serial, tmp_path / "serial.out")
    rows_bad = int(numpy_answers(pre, *cands, np.ones(pre.n_reads, bool)
                                 )[4].sum())
    with omp_threads(threads):
        got, (n_bad, n_cont) = run_engines(pre, tmp_path / "pre.out", cands)
    assert got == want and got.count("MB  ") == 3 and got.count("MC  ") == 1
    assert np.array_equal(pre.bad, serial.bad)
    assert np.array_equal(pre.contained, serial.contained)
    assert n_bad == rows_bad and 0 <= n_cont <= n_bad


def test_bad_y_is_skipped():
    """The flags the skip of a bad y decides, spelled out."""
    rs = edge("bad_y_skipped")
    cands = candidates(rs)
    with open(os.devnull, "w") as f:
        v = rs._view(f.fileno(), f.fileno())
        lib().rs_mark_bad_pre(ctypes.byref(v), *cands)
        assert list(rs.bad) == [0, BAD_REPEAT, 0,
                                BAD_REPEAT | BAD_NOMATCH | BAD_LOWHIT]
        lib().rs_mark_contained_pre(ctypes.byref(v), *cands)
    assert list(rs.contained) == [0, 0, 0, 0]
    plus, cont = native_answers(rs, *cands, 0, 1)[0][:2]
    cy, _ch, co = cands
    (r,) = [r for r in range(co[2], co[3]) if cy[r] == 1]
    assert plus[r] == cont[r] == 1               # contained, were y not bad


def test_phase2_pairs_counts_the_rows_answered(tmp_path, monkeypatch):
    """modasm -b -c with the device phase 1 on the CPU: phase2.pairs is
    the rows the answer pass answered in the two passes, every read in
    -b's, the reads not bad at its start in -c's."""
    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, 8000)
    with open(tmp_path / "reads.fa", "wb") as f:
        for i in range(60):
            s = int(rng.integers(0, len(genome) - 1500))
            r = genome[s:s + 1500]
            f.write(b">r%d\n" % i + acgt[r if i % 2 else 3 - r[::-1]].tobytes()
                    + b"\n")
    quiet = (contextlib.redirect_stdout(io.StringIO()),
             contextlib.redirect_stderr(io.StringIO()))
    with quiet[0], quiet[1]:
        modutils.main(["-c", "20", "16", "16", "17", "-a",
                       str(tmp_path / "reads.fa"), "-s", "4", "18", "40",
                       "-w", str(tmp_path / "X.mod")], device="cpu")
    want, returned = [], []
    real = Readset.native_call

    def spied(self, name, out_f, *extra):
        if name in ("rs_mark_bad_pre", "rs_mark_contained_pre"):
            visit = (np.ones(self.n_reads, bool) if name == "rs_mark_bad_pre"
                     else self.bad == 0)
            want.append(int(numpy_answers(self, *extra, visit)[4].sum()))
        returned.append(real(self, name, out_f, *extra))
        return returned[-1]

    monkeypatch.setattr(Readset, "native_call", spied)
    monkeypatch.setattr(profiling, "_jobs", [])
    monkeypatch.setenv("MODIMIZER_STAGES", "1")
    monkeypatch.delenv("MODIMIZER_TRACE", raising=False)
    monkeypatch.setenv("MODIMIZER_OVERLAPS", "device")
    with open(tmp_path / "asm.out", "w") as f, contextlib.redirect_stdout(f), \
            contextlib.redirect_stderr(io.StringIO()):
        modasm.main(["-m", str(tmp_path / "X.mod"), "-f",
                     str(tmp_path / "reads.fa"), "-b", "-c"], device="cpu")
    (rec,) = profiling.jobs()
    assert len(want) == 2 and want[0] >= want[1] > 0
    assert returned == want
    assert rec.counters["phase2.pairs"] == sum(want)
