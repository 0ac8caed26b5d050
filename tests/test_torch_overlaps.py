"""The port's overlap self-join (modimizer_tpu_torch/parallel/overlaps.py)
against the JAX package's ``overlap_counts`` and the literal phase-1 oracle
of tests/test_overlaps.py, on the CPU: ``overlap_counts`` with the pair
kernel's plain version, ``device_overlap_candidates`` on
tests/test_overlaps_pre.py's dataset, edge readsets (no copy-1 row, groups
of one row, a group of more than 64 rows, a group on one read), and the
kernel's arithmetic (``namespace overlap_place`` of csrc/overlaps.cu: the
group bounds, the per-read table, the overflow path, the placement)
compiled by g++ and replayed against ``overlap_pairs_ref``, with the
table's capacity lowered to force the overflow path.  Exact throughout:
ids, counts and ranks."""

import contextlib
import io
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

from modimizer_tpu.cli import modutils as jax_modutils  # noqa: E402
from modimizer_tpu.core.modset import Modset as JaxModset  # noqa: E402
from modimizer_tpu.core.readset import Readset as JaxReadset  # noqa: E402
from modimizer_tpu.parallel.overlaps import (  # noqa: E402
    overlap_counts as jax_overlap_counts)
from modimizer_tpu_torch.core.modset import Modset  # noqa: E402
from modimizer_tpu_torch.core.readset import Readset  # noqa: E402
from modimizer_tpu_torch import _build  # noqa: E402
from modimizer_tpu_torch.parallel.overlaps import (  # noqa: E402
    HNONE, MAX_CAP, TABLE_CAP, overlap_counts, overlap_inputs, overlap_join,
    overlap_pairs,
    overlap_pairs_ref, sort_key)
from tests.test_overlaps import (FakeMS, FakeRS, TOPBIT,  # noqa: E402
                                 make_readset, oracle)

CSRC = Path(__file__).resolve().parent.parent / "modimizer_tpu_torch" / "csrc"
KEYS = ("x", "y", "n_hit", "n_agree", "first_rank", "n_repeat", "bad_repeat")
CPU = torch.device("cpu")


def assert_same(got, want):
    for k in KEYS:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], np.asarray(want[k])), k


def by_read(res, n_reads):
    out = {x: [] for x in range(n_reads)}
    for x, y, c, a in zip(res["x"], res["y"], res["n_hit"], res["n_agree"]):
        out[int(x)].append((int(y), int(c), int(a)))
    return out


@pytest.mark.parametrize("dmax", [8, 64])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_overlap_counts_match_jax(seed, dmax):
    rs = make_readset(seed)
    assert_same(overlap_counts(rs, dmax=dmax, device="cpu"),
                jax_overlap_counts(rs, dmax=dmax))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_overlap_counts_match_oracle(seed):
    rs = make_readset(seed)
    got = overlap_counts(rs, device="cpu")
    want_pairs, want_rep = oracle(rs)
    assert np.array_equal(got["n_repeat"], want_rep)
    n_reads = len(rs.hit_off) - 1
    got_pairs = by_read(got, n_reads)
    for x in range(n_reads):
        assert got_pairs[x] == want_pairs.get(x, []), x


def edge_readset(case):
    """A FakeRS for one edge: no copy-1 row, groups of one row, a group of
    more than 64 rows (the JAX sweep's widen case), or every row of a group
    on one read (only its first occurrence is an x side)."""
    rng = np.random.default_rng(7)
    n_mods = 40
    info = np.ones(n_mods + 1, np.uint8)
    info[0] = 0
    reads = []
    if case == "no_copy1":
        info[:] = 2
        reads = [list(rng.integers(1, n_mods + 1, 12)) for _ in range(10)]
    elif case == "singletons":
        reads = [[1 + 4 * r + i for i in range(4)] for r in range(10)]
    elif case == "big_group":
        reads = [[5, int(rng.integers(6, n_mods + 1)), 5 if r % 7 == 0
                  else 6] for r in range(100)]
    elif case == "one_read":
        reads = [[3, 9, 3, 3, 12, 3, 3], [9, 12, 3], [3]]
    hits, off = [], [0, 0]          # read 0 is burned, as in a readset
    for r in reads:
        for m in r:
            hits.append(int(m) | (TOPBIT if rng.integers(0, 2) else 0))
        off.append(len(hits))
    hits = np.array(hits, np.uint32)
    depth = np.bincount(hits & 0x7FFFFFFF, minlength=n_mods + 1
                        ).astype(np.uint16)
    return FakeRS(hits, np.array(off, np.int64), FakeMS(info, depth))


EDGES = ("no_copy1", "singletons", "big_group", "one_read")


@pytest.mark.parametrize("case", EDGES)
def test_overlap_counts_edges_match_oracle(case):
    rs = edge_readset(case)
    got = overlap_counts(rs, dmax=8, device="cpu")
    want_pairs, want_rep = oracle(rs)
    assert np.array_equal(got["n_repeat"], want_rep)
    n_reads = len(rs.hit_off) - 1
    got_pairs = by_read(got, n_reads)
    for x in range(n_reads):
        assert got_pairs[x] == want_pairs.get(x, []), x
    rows = [torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32 if a.dtype == np.uint32 else np.uint8))
        for a in overlap_inputs(rs)[0]]
    _k, _c, _a, _r, n_pairs, max_group = overlap_pairs(*rows)
    if case == "no_copy1":
        assert n_pairs == 0 and max_group == 1 and len(got["x"]) == 0
    elif case == "singletons":
        assert max_group == 1 and np.array_equal(got["x"], got["y"])
    elif case == "big_group":
        assert max_group > 64
    elif case == "one_read":
        assert got["n_repeat"][1] == 4 and got["bad_repeat"][1]


def test_overlap_counts_big_group_matches_jax():
    rs = edge_readset("big_group")
    assert_same(overlap_counts(rs, dmax=64, device="cpu"),
                jax_overlap_counts(rs, dmax=64))


def test_overlap_pairs_ref_is_overlap_pairs_on_the_cpu():
    rows = [torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32 if a.dtype == np.uint32 else np.uint8))
        for a in overlap_inputs(make_readset(2))[0]]
    before = dict(_build.LAUNCHES)
    got, want = overlap_pairs(*rows), overlap_pairs_ref(*rows)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert got[4:] == want[4:]
    # on CPU tensors the wrapper is the plain version and launches nothing
    assert _build.LAUNCHES == before


def test_overlap_counts_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        overlap_counts(make_readset(1))


# ---- device_overlap_candidates on test_overlaps_pre.py's dataset ----

BASES = np.array(list("ACGT"))
RC = {"A": "T", "C": "G", "G": "C", "T": "A"}


def overlaps_pre_dataset(d):
    """tests/test_overlaps_pre.py's reads (a tandem repeat, reverse-
    complemented reads, a contained read) and its modset, built by the JAX
    modutils in this process."""
    rng = np.random.default_rng(11)
    core = "".join(BASES[rng.integers(0, 4, size=12000)])
    genome = core[:6000] + core[2000:4000] + core[6000:]
    with open(d / "reads.fa", "w") as f:
        for i in range(150):
            s = int(rng.integers(0, len(genome) - 2600))
            seq = genome[s:s + 2500]
            if i % 3 == 2:
                seq = "".join(RC[c] for c in reversed(seq))
            f.write(f">r{i}\n{seq}\n")
        f.write(f">contained\n{genome[500:1300]}\n")
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        jax_modutils.main(["-c", "20", "16", "16", "17", "-a",
                           str(d / "reads.fa"), "-s", "4", "18", "40", "-w",
                           str(d / "X.mod")])
    return d


@pytest.fixture(scope="module")
def pre_dataset(tmp_path_factory):
    return overlaps_pre_dataset(tmp_path_factory.mktemp("ovpre_torch"))


def test_device_overlap_candidates_match_jax(pre_dataset, monkeypatch):
    monkeypatch.setenv("MODIMIZER_SCAN", "host")
    jrs = JaxReadset(JaxModset.read(str(pre_dataset / "X.mod")))
    jrs.file_read(str(pre_dataset / "reads.fa"))
    prs = Readset(Modset.read(str(pre_dataset / "X.mod")))
    prs.file_read(str(pre_dataset / "reads.fa"))
    assert prs.device is None
    want = jrs.device_overlap_candidates()
    got = prs.device_overlap_candidates(device="cpu")
    assert want[2][-1] > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the same readset scanned on the CPU device keeps its device
    monkeypatch.delenv("MODIMIZER_SCAN")
    crs = Readset(Modset.read(str(pre_dataset / "X.mod")))
    crs.file_read(str(pre_dataset / "reads.fa"), device="cpu")
    assert crs.device == CPU
    assert np.array_equal(crs.hits, jrs.hits)
    for a, b in zip(crs.device_overlap_candidates(), want):
        assert np.array_equal(a, b)


# ---- csrc/overlaps.cu's arithmetic, compiled by g++ ----

_HOST_REPLAY = r"""
// Replays overlaps.cu's launches on the host with its overlap_place
// helpers: the group bounds of every sorted row, the count pass (each
// read's pairs walked 32 rows at a time, owner lanes by lane_of, into the
// open-addressed table with a capacity of argv[3]), the flagged reads'
// dense counts, the prefix, the emit pass (the table's entries ranked by
// y) and the flagged reads' dense rows.
#include "overlaps.cu"
#include <cstdio>
#include <cstdlib>
#include <vector>
using namespace overlap_place;

struct Cas {
    int32_t operator()(int32_t* p, int32_t e, int32_t d) const {
        const int32_t o = *p;
        if (o == e) *p = d;
        return o;
    }
};

template <class T> static bool get(FILE* f, std::vector<T>& v, int64_t n) {
    v.resize(n);
    return n == 0 || fread(v.data(), sizeof(T), n, f) == (size_t)n;
}

int64_t n;
std::vector<int32_t> xs, js, gs, gn;
std::vector<uint8_t> st, first;
std::vector<uint32_t> yb;

// Every pair of read [rs, re) as the card's warps walk it; false when
// ins() asks to stop.
template <class Insert> static bool walk(int64_t rs, int64_t re, Insert ins) {
    for (int64_t g0 = rs; g0 < re; g0 += 32) {
        int64_t excl[32], sum = 0;
        for (int l = 0; l < 32; ++l) {
            const int64_t a = g0 + l;
            excl[l] = sum;
            sum += a < re && first[a] ? gn[a] : 0;
        }
        auto prefix = [&](int l) { return excl[l]; };
        for (int64_t q = 0; q < sum; ++q) {
            int64_t pl;
            const int l = lane_of(prefix, q, &pl);
            const int64_t a = g0 + l, kb = q - pl;
            if (a >= re || !first[a] || kb >= gn[a]) exit(2);
            const uint32_t v = yb[gs[a] + kb];
            if (!ins((int32_t)(v >> 1), (int)(v & 1) == st[a],
                     pair_rank(js[a], kb)))
                return false;
        }
    }
    return true;
}

int main(int argc, char** argv) {
    FILE* f = fopen(argv[1], "rb");
    const int cap = atoi(argv[3]);
    if (fread(&n, 8, 1, f) != 1) return 1;
    std::vector<int32_t> h;
    std::vector<int64_t> order;
    if (!get(f, h, n) || !get(f, order, n) || !get(f, xs, n) ||
        !get(f, js, n) || !get(f, st, n) || !get(f, first, n)) return 1;
    fclose(f);
    // launch 1
    gs.assign(n, 0);
    gn.assign(n, 0);
    yb.assign(n, 0);
    int32_t max_group = 0;
    for (int64_t p = 0; p < n; ++p) {
        const int64_t a = order[p];
        if (live_key(h[p])) {
            const int64_t s = run_start(h.data(), p);
            const int64_t e = run_end(h.data(), n, p);
            if (s > p || e <= p || h[s] != h[p] || h[e - 1] != h[p] ||
                (s > 0 && h[s - 1] == h[p]) || (e < n && h[e] == h[p]))
                return 4;
            gs[a] = (int32_t)s;
            gn[a] = (int32_t)(e - s);
            if (gn[a] > max_group) max_group = gn[a];
        }
        yb[p] = pack_y(xs[a], st[a]);
    }
    // the reads, by their first rows
    std::vector<int64_t> starts, ends;
    for (int64_t a = 0; a < n; ++a)
        if (a == 0 || xs[a - 1] != xs[a]) {
            starts.push_back(a);
            const int64_t e = run_end(xs.data(), n, a);
            for (int64_t b = a; b < e; ++b) if (xs[b] != xs[a]) return 5;
            if (e < n && xs[e] == xs[a]) return 5;
            ends.push_back(e);
        }
    const int S = table_slots(cap);
    const uint32_t mask = (uint32_t)S - 1;
    std::vector<int32_t> tkey(S, EMPTY), lkey(cap), lslot(cap);
    std::vector<uint64_t> tval(S, 0), tnr(S, 0);
    std::vector<int32_t> dcnt(n, 0);
    std::vector<int64_t> flags;
    // launch 2 (count) and launch 4 (emit): the shared table
    auto table_walk = [&](size_t r, bool emit, int* nd) {
        bool ovf = false;
        *nd = 0;
        walk(starts[r], ends[r], [&](int32_t y, bool agree, uint64_t rank) {
            bool fresh;
            const int s = find_slot(tkey.data(), mask, y, Cas(), &fresh);
            if (s < 0) {
                ovf = true;
                return false;
            }
            if (fresh && (*nd)++ >= cap) ovf = true;
            if (emit) {
                tval[s] += pair_inc(agree);
                if (~rank > tnr[s]) tnr[s] = ~rank;
            }
            return !ovf;
        });
        return ovf;
    };
    auto clear = [&]() {
        for (int s = 0; s < S; ++s) {
            tkey[s] = EMPTY;
            tval[s] = tnr[s] = 0;
        }
    };
    for (size_t r = 0; r < starts.size(); ++r) {
        int nd;
        if (table_walk(r, false, &nd)) {
            flags.push_back(starts[r]);
        } else {
            dcnt[starts[r]] = nd;
        }
        clear();
    }
    // launch 3: the dense table of the flagged reads
    int32_t nid = n ? xs[n - 1] + 1 : 1;
    std::vector<uint64_t> dv(nid), dn(nid);
    auto dense_walk = [&](int64_t rs) {
        std::fill(dv.begin(), dv.end(), 0);
        std::fill(dn.begin(), dn.end(), 0);
        walk(rs, run_end(xs.data(), n, rs),
             [&](int32_t y, bool agree, uint64_t rank) {
            dv[y] += pair_inc(agree);
            if (~rank > dn[y]) dn[y] = ~rank;
            return true;
        });
    };
    for (int64_t rs : flags) {
        dense_walk(rs);
        int c = 0;
        for (int32_t y = 0; y < nid; ++y) c += dv[y] != 0;
        if (c <= cap) return 6;
        dcnt[rs] = c;
    }
    std::vector<int64_t> incl(n);
    int64_t run = 0;
    for (int64_t a = 0; a < n; ++a) incl[a] = run += dcnt[a];
    std::vector<int64_t> key(run), cnt(run), agr(run), rnk(run);
    std::vector<int> writes(run, 0);
    auto put = [&](int64_t o, int32_t x, int32_t y, uint64_t v, uint64_t nr) {
        if (o < 0 || o >= run) exit(7);
        key[o] = pair_key(x, y);
        cnt[o] = (int64_t)(v >> 32);
        agr[o] = (int64_t)(v & 0xffffffffu);
        rnk[o] = (int64_t)~nr;
        ++writes[o];
    };
    for (size_t r = 0; r < starts.size(); ++r) {
        int nd;
        const int64_t rs = starts[r];
        if (!table_walk(r, true, &nd)) {
            int nl = 0;
            for (int s = 0; s < S; ++s)
                if (tkey[s] != EMPTY) {
                    lkey[nl] = tkey[s];
                    lslot[nl++] = s;
                }
            if (nl != dcnt[rs]) return 8;
            const int64_t off = incl[rs] - dcnt[rs];
            for (int i = 0; i < nl; ++i)
                put(off + rank_in(lkey.data(), nl, lkey[i]), xs[rs], lkey[i],
                    tval[lslot[i]], tnr[lslot[i]]);
        }
        clear();
    }
    // launch 5
    for (int64_t rs : flags) {
        dense_walk(rs);
        int64_t o = incl[rs] - dcnt[rs];
        for (int32_t y = 0; y < nid; ++y)
            if (dv[y]) put(o++, xs[rs], y, dv[y], dn[y]);
    }
    for (int64_t i = 0; i < run; ++i)
        if (writes[i] != 1) return 3;
    f = fopen(argv[2], "wb");
    fwrite(key.data(), 8, run, f);
    fwrite(cnt.data(), 8, run, f);
    fwrite(agr.data(), 8, run, f);
    fwrite(rnk.data(), 8, run, f);
    fclose(f);
    printf("%d %zu\n", max_group, flags.size());
    return 0;
}
"""


@pytest.fixture(scope="module")
def join_replay(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: overlaps.cu's host helpers "
                    "cannot be compiled as host code")
    d = tmp_path_factory.mktemp("overlaps_host")
    (d / "replay.cpp").write_text(_HOST_REPLAY)
    exe = d / "replay"
    r = subprocess.run([gxx, "-std=c++17", "-O1", "-Wall",
                        "-Wno-unknown-pragmas", "-x", "c++",
                        "-DMZ_OVERLAPS_HOST", "-I", str(CSRC),
                        str(d / "replay.cpp"), "-o", str(exe)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return exe


# (readset, the table's capacity): the seeded sets and the edges at the
# default capacity, then capacities below some reads' distinct partners
JOIN_CASES = ([("seed%d" % s, TABLE_CAP) for s in (1, 2, 3)]
              + [(e, TABLE_CAP) for e in EDGES]
              + [("seed1", 3), ("seed2", 1), ("big_group", 2)])


@pytest.mark.parametrize("case,cap", JOIN_CASES)
def test_overlap_join_host(join_replay, tmp_path, case, cap):
    """overlaps.cu's groups, join and overflow arithmetic, compiled by g++,
    writes every distinct pair once, in key order, equal to
    overlap_pairs_ref; a capacity below a read's distinct partners sends
    that read down the overflow path."""
    rs = (make_readset(int(case[4:])) if case.startswith("seed")
          else edge_readset(case))
    rows = [torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32 if a.dtype == np.uint32 else np.uint8))
        for a in overlap_inputs(rs)[0]]
    xs, js, hs, strand, is_c1, firstc1 = rows
    hkey = torch.where(is_c1.bool(), hs.to(torch.int64),
                       torch.full_like(hs, HNONE, dtype=torch.int64))
    # the card's 32-bit sort key orders the rows as the int64 hkey does
    h, order = torch.sort(sort_key(hs, is_c1), stable=True)
    assert h.dtype == torch.int32
    assert torch.equal(order, torch.sort(hkey, stable=True)[1])
    src = tmp_path / "in.bin"
    with open(src, "wb") as f:
        f.write(np.int64(xs.numel()).tobytes())
        for t in (h, order, xs, js, strand.to(torch.uint8),
                  firstc1.to(torch.uint8)):
            f.write(t.numpy().tobytes())
    dst = tmp_path / "out.bin"
    r = subprocess.run([str(join_replay), str(src), str(dst), str(cap)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.returncode, r.stderr)
    keys, counts, n_agree, first, n_pairs, max_group = overlap_pairs_ref(
        *rows)
    got = np.fromfile(dst, np.int64).reshape(4, -1)
    assert got.shape[1] == n_pairs
    for g, w in zip(got, (keys, counts, n_agree, first)):
        assert np.array_equal(g, w.numpy())
    mg, n_flagged = map(int, r.stdout.split())
    assert max(1, mg) == max_group
    if cap < TABLE_CAP:
        assert n_flagged > 0


_CAP_PROBE = r"""
#include "overlaps.cu"
#include <cstdio>
int main() {
    using namespace overlap_place;
    printf("%d %lld %lld %lld\n", MAX_CAP, (long long)SMEM_LIMIT,
           (long long)join_smem(MAX_CAP), (long long)join_smem(MAX_CAP + 1));
    return 0;
}
"""


def test_cap_limit_is_the_tables_fit(tmp_path):
    """MAX_CAP in parallel/overlaps.py is overlaps.cu's: the largest table
    capacity whose shared-memory table fits a block on sm_90, and the
    default capacity is within it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: overlaps.cu's host helpers "
                    "cannot be compiled as host code")
    (tmp_path / "cap.cpp").write_text(_CAP_PROBE)
    exe = tmp_path / "cap"
    r = subprocess.run([gxx, "-std=c++17", "-Wall", "-Wno-unknown-pragmas",
                        "-x", "c++", "-DMZ_OVERLAPS_HOST", "-I", str(CSRC),
                        str(tmp_path / "cap.cpp"), "-o", str(exe)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    cap, limit, fits, over = map(int, subprocess.run(
        [str(exe)], capture_output=True, text=True, check=True).stdout.split())
    assert cap == MAX_CAP and 1 <= TABLE_CAP <= MAX_CAP
    assert fits <= limit < over


@pytest.mark.parametrize("cap", [0, -1, MAX_CAP + 1])
def test_overlap_join_rejects_a_cap_out_of_range(cap):
    """overlap_join refuses a capacity outside [1, MAX_CAP] before it builds
    or launches anything."""
    rows = [torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32 if a.dtype == np.uint32 else np.uint8))
        for a in overlap_inputs(make_readset(1))[0]]
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="cap must be"):
        overlap_join(*rows, cap=cap)
    assert _build.LAUNCHES == before
