"""findOverlaps phase 1's host preparation in the port
(``modimizer_tpu_torch/parallel/overlaps.py`` ``overlap_inputs``, the
native pass ``rs_overlap_inputs``) against the numpy form it replaced,
kept here as the oracle: array by array and dtype by dtype on
tests/test_overlaps.py's readsets, a readset of the benchmark cell's kind
(many rows, a small mod table, frequent repeats) and edge readsets (empty
reads, one mod a read, repeated non-copy-1 mods, a saturated depth, the
largest mod id, no hit).  A mod id past the modset's arrays raises; the
counter ``overlaps.prep_rows`` adds each call's hit rows to a recording
job (``modasm -b -c`` on the CPU: two calls)."""

import contextlib
import io

import numpy as np
import pytest

from modimizer_tpu_torch.cli import modasm, modutils
from modimizer_tpu_torch.parallel import overlaps
from modimizer_tpu_torch.parallel.overlaps import overlap_inputs
from modimizer_tpu_torch.utils import profiling
from tests.test_overlaps import FakeMS, FakeRS, TOPBIT, make_readset

TOPMASK = np.uint32(0x7FFFFFFF)


def numpy_overlap_inputs(readset):
    """The numpy form of overlap_inputs: first occurrences from a lexsort
    of the rows by (x, h, j)."""
    hits = np.ascontiguousarray(readset.hits, np.uint32)
    off = np.asarray(readset.hit_off, np.int64)
    n_reads = len(off) - 1
    info = readset.ms.info
    h = hits & TOPMASK
    strand = (hits >> np.uint32(31)).astype(np.uint32)
    x = np.repeat(np.arange(n_reads, dtype=np.uint32), np.diff(off))
    j = (np.arange(len(hits), dtype=np.uint32)
         - np.repeat(off[:-1], np.diff(off)).astype(np.uint32))
    is_c1 = (info[h] & 3) == 1
    depth_ok = readset.ms.depth[h] != np.uint16(0xFFFF)
    o = np.lexsort((j, h, x))
    xo, ho, c1o = x[o], h[o], is_c1[o]
    same = np.concatenate([[False], (xo[1:] == xo[:-1]) & (ho[1:] == ho[:-1])])
    firstc1 = np.zeros(len(hits), bool)
    firstc1[o] = (~same) & c1o
    dup_c1 = np.zeros(len(hits), bool)
    dup_c1[o] = same & c1o
    n_repeat = np.bincount(x[dup_c1], minlength=n_reads).astype(np.int32)
    bad_repeat = n_repeat > 0
    return ((x, j, h, strand, is_c1 & depth_ok, firstc1 & depth_ok),
            n_repeat, bad_repeat)


def readset(reads, info, depth=None):
    """A FakeRS of ``reads`` (per read a list of (mod, strand)); depth
    counted from the hits unless given."""
    rows = [m | (TOPBIT if s else 0) for r in reads for m, s in r]
    hits = np.array(rows, np.uint32)
    off = np.concatenate([[0], np.cumsum([len(r) for r in reads])])
    info = np.asarray(info, np.uint8)
    if depth is None:
        depth = np.bincount(hits & TOPMASK, minlength=len(info))
    return FakeRS(hits, off.astype(np.int64),
                  FakeMS(info, np.asarray(depth, np.uint16)))


def cell_shape(seed, n_reads=2000, n_mods=300, mean_hits=60):
    """The benchmark cell's kind at a small size: CSR reads of varied hit
    counts (some empty) over a small mod table, so a read often repeats a
    mod; a third of the mods copy-1, a few saturated."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(mean_hits, n_reads)
    counts[rng.random(n_reads) < 0.02] = 0
    counts[0] = 0
    n = int(counts.sum())
    h = rng.integers(1, n_mods + 1, n).astype(np.uint32)
    hits = h | np.where(rng.random(n) < 0.5, np.uint32(TOPBIT), np.uint32(0))
    info = rng.choice([0, 1, 1, 2, 3], n_mods + 1).astype(np.uint8)
    info[0] = 0
    depth = np.minimum(np.bincount(h, minlength=n_mods + 1), 0xFFFE)
    depth[rng.choice(n_mods + 1, 5, replace=False)] = 0xFFFF
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return FakeRS(hits.astype(np.uint32), off,
                  FakeMS(info, depth.astype(np.uint16)))


C1 = [0, 1, 1, 2, 3, 1, 0, 1]   # info of mods 0-7: 1, 2, 5, 7 copy-1


def edge(case):
    if case == "empty_reads":
        return readset([[], [(1, 0), (2, 1)], [], [], [(2, 0), (1, 1)], [],
                        [(5, 0)], [], []], C1)
    if case == "one_mod_a_read":
        return readset([[], [(2, k & 1) for k in range(9)], [(2, 0)],
                        [(1, 0)] * 3], C1)
    if case == "repeated_non_copy1":
        return readset([[], [(3, 0), (3, 1), (4, 0), (4, 0), (6, 1), (6, 0)],
                        [(3, 0), (1, 0), (3, 0), (1, 1)]], C1)
    if case == "saturated_repeat":
        rs = readset([[], [(5, 0), (1, 0), (5, 1), (5, 0)], [(5, 0), (2, 0)]],
                     C1)
        rs.ms.depth[5] = 0xFFFF
        return rs
    if case == "largest_mod":
        return readset([[], [(7, 0), (7, 1), (1, 0)], [(7, 1)]], C1)
    if case == "no_hit":
        return readset([[], [], []], C1)
    raise ValueError(case)


EDGES = ("empty_reads", "one_mod_a_read", "repeated_non_copy1",
         "saturated_repeat", "largest_mod", "no_hit")
CASES = ([("make_readset", s) for s in range(6)]
         + [("cell_shape", s) for s in range(3)]
         + [("edge", c) for c in EDGES])


def build(kind, arg):
    return {"make_readset": make_readset, "cell_shape": cell_shape,
            "edge": edge}[kind](arg)


@pytest.mark.parametrize("kind,arg", CASES,
                         ids=["%s-%s" % c for c in CASES])
def test_native_pass_matches_the_numpy_form(kind, arg):
    rs = build(kind, arg)
    (rows, n_repeat, bad), (want_rows, want_rep, want_bad) = (
        overlap_inputs(rs), numpy_overlap_inputs(rs))
    names = ("x", "j", "h", "strand", "is_c1_cnt", "firstc1_cnt")
    for name, got, want in zip(names, rows, want_rows):
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
    assert n_repeat.dtype == want_rep.dtype == np.int32
    assert np.array_equal(n_repeat, want_rep)
    assert bad.dtype == want_bad.dtype and np.array_equal(bad, want_bad)
    assert len(rows[0]) == len(rs.hits)
    assert len(n_repeat) == len(rs.hit_off) - 1


def test_edges_read_as_findoverlaps_counts_them():
    """What the edge readsets must give, spelled out."""
    (_x, _j, _h, _s, c1, first), rep, _b = overlap_inputs(
        edge("one_mod_a_read"))
    assert list(rep) == [0, 8, 0, 2]
    assert first.sum() == 3 and c1.sum() == 13
    _r, rep, _b = overlap_inputs(edge("repeated_non_copy1"))
    assert list(rep) == [0, 0, 1]          # mod 1's second row alone
    (_x, _j, h, _s, c1, first), rep, bad = overlap_inputs(
        edge("saturated_repeat"))
    assert list(rep) == [0, 2, 0] and list(bad) == [False, True, False]
    assert not (c1 | first)[h == 5].any()
    assert list(first) == [False, True, False, False, False, True]
    (_x, _j, h, _s, _c, first), rep, _b = overlap_inputs(edge("largest_mod"))
    assert h.max() == 7 and list(rep) == [0, 1, 0]
    rows, rep, bad = overlap_inputs(edge("no_hit"))
    assert all(len(a) == 0 for a in rows) and list(rep) == [0, 0, 0]


@pytest.mark.parametrize("case", ["past_both", "past_info", "past_depth"])
def test_a_mod_past_the_modset_raises(case):
    rs = edge("largest_mod")
    if case == "past_both":
        rs.hits[2] = 8
    elif case == "past_info":
        rs.ms.info = rs.ms.info[:7]
    else:
        rs.ms.depth = rs.ms.depth[:7]
    with pytest.raises(IndexError):
        overlap_inputs(rs)
    with pytest.raises(IndexError):
        numpy_overlap_inputs(rs)


def test_prep_rows_counts_each_call_in_a_recording_job(tmp_path, monkeypatch):
    """modasm -b -c with the device phase 1 on the CPU: two calls of
    overlap_inputs, each adding its readset's tot_hit."""
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
    seen = []
    real = overlaps.overlap_inputs

    def spied(rs):
        seen.append(rs.tot_hit)
        return real(rs)

    monkeypatch.setattr(overlaps, "overlap_inputs", spied)
    monkeypatch.setattr(profiling, "_jobs", [])
    monkeypatch.setenv("MODIMIZER_STAGES", "1")
    monkeypatch.delenv("MODIMIZER_TRACE", raising=False)
    monkeypatch.setenv("MODIMIZER_OVERLAPS", "device")
    with open(tmp_path / "asm.out", "w") as f, contextlib.redirect_stdout(f), \
            contextlib.redirect_stderr(io.StringIO()):
        modasm.main(["-m", str(tmp_path / "X.mod"), "-f",
                     str(tmp_path / "reads.fa"), "-b", "-c"], device="cpu")
    (rec,) = profiling.jobs()
    assert len(seen) == 2 and seen[0] == seen[1] > 0
    assert rec.counters["overlaps.prep_rows"] == sum(seen)
