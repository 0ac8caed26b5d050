"""The port's overlap self-join (modimizer_tpu_torch/parallel/overlaps.py)
against the JAX package's ``overlap_counts`` and the literal phase-1 oracle
of tests/test_overlaps.py, on the CPU: ``overlap_counts`` with the pair
kernel's plain version, ``device_overlap_candidates`` on
tests/test_overlaps_pre.py's dataset, edge readsets (no copy-1 row, groups
of one row, a group of more than 64 rows, a group on one read), and the
kernel's slot arithmetic (``namespace overlap_place`` of csrc/overlaps.cu)
compiled by g++ and replayed against ``pair_rows_ref``.  Exact throughout:
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
from modimizer_tpu_torch.parallel.overlaps import (  # noqa: E402
    overlap_counts, overlap_inputs, overlap_pairs, overlap_pairs_ref,
    pair_rows, pair_rows_ref, sort_rows)
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
    got, want = overlap_pairs(*rows), overlap_pairs_ref(*rows)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert got[4:] == want[4:]
    srt = sort_rows(*rows)
    for a, b in zip(pair_rows(*srt), pair_rows_ref(*srt)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


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


# ---- csrc/overlaps.cu's slot arithmetic, compiled by g++ ----

_HOST_REPLAY = r"""
// Replays overlaps.cu's two launches on the host with its overlap_place
// helpers: every row counted, every warp's range placed lane by lane.
#include "overlaps.cu"
#include <cstdio>
#include <vector>
using namespace overlap_place;
int main(int argc, char** argv) {
    FILE* f = fopen(argv[1], "rb");
    int64_t n;
    if (fread(&n, 8, 1, f) != 1) return 1;
    std::vector<int64_t> h(n);
    std::vector<int32_t> xs(n), js(n);
    std::vector<uint8_t> st(n), first(n);
    if (n && (fread(h.data(), 8, n, f) != (size_t)n ||
              fread(xs.data(), 4, n, f) != (size_t)n ||
              fread(js.data(), 4, n, f) != (size_t)n ||
              fread(st.data(), 1, n, f) != (size_t)n ||
              fread(first.data(), 1, n, f) != (size_t)n)) return 1;
    fclose(f);
    std::vector<int32_t> krank(n), cnt(n);
    int32_t max_group = 0;
    for (int64_t p = 0; p < n; ++p) {
        const Count c = count_row(h.data(), first.data(), n, p);
        krank[p] = c.k;
        cnt[p] = c.cnt;
        if (c.g > max_group) max_group = c.g;
    }
    std::vector<int64_t> incl(n);
    int64_t run = 0;
    for (int64_t p = 0; p < n; ++p) incl[p] = run += cnt[p];
    std::vector<int64_t> key(run), rank(run);
    std::vector<uint8_t> agree(run);
    std::vector<int> writes(run, 0);
    for (int64_t a0 = 0; a0 < n; a0 += 32) {
        int64_t excl[32], start[32];
        int64_t sum = 0;
        for (int l = 0; l < 32; ++l) {
            const int64_t a = a0 + l;
            const int64_t c = a < n ? cnt[a] : 0;
            excl[l] = sum;
            sum += c;
            start[l] = a < n ? a - krank[a] : 0;
        }
        const int64_t d0 = incl[a0] - cnt[a0];
        auto prefix = [&](int l) { return excl[l]; };
        for (int64_t q = 0; q < sum; ++q) {
            int64_t pl;
            const int l = lane_of(prefix, q, &pl);
            const int64_t a = a0 + l, kb = q - pl, b = start[l] + kb;
            if (a >= n || kb >= cnt[a]) return 2;
            const Pair r = pair_row(xs[a], js[a], st[a], xs[b], st[b], kb);
            key[d0 + q] = r.key;
            rank[d0 + q] = r.rank;
            agree[d0 + q] = r.agree;
            ++writes[d0 + q];
        }
    }
    for (int64_t i = 0; i < run; ++i)
        if (writes[i] != 1) return 3;
    f = fopen(argv[2], "wb");
    fwrite(key.data(), 8, run, f);
    fwrite(rank.data(), 8, run, f);
    fwrite(agree.data(), 1, run, f);
    fclose(f);
    printf("%d\n", max_group);
    return 0;
}
"""


@pytest.fixture(scope="module")
def placement_replay(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: overlaps.cu's placement helpers "
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


@pytest.mark.parametrize("case", ["seed1", "seed2", "seed3"] + list(EDGES))
def test_overlap_placement_host(placement_replay, tmp_path, case):
    """overlaps.cu's count and emit arithmetic, compiled by g++, writes
    every pair row where pair_rows_ref does and each slot once."""
    rs = (make_readset(int(case[4:])) if case.startswith("seed")
          else edge_readset(case))
    rows = [torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32 if a.dtype == np.uint32 else np.uint8))
        for a in overlap_inputs(rs)[0]]
    h, xs, js, st, first = sort_rows(*rows)
    n = h.shape[0]
    src = tmp_path / "in.bin"
    with open(src, "wb") as f:
        f.write(np.int64(n).tobytes())
        for t in (h, xs, js, st, first):
            f.write(t.numpy().tobytes())
    dst = tmp_path / "out.bin"
    r = subprocess.run([str(placement_replay), str(src), str(dst)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.returncode, r.stderr)
    key, rank, agree, max_group = pair_rows_ref(h, xs, js, st, first)
    m = key.numel()
    got = np.fromfile(dst, np.uint8)
    assert got.size == 17 * m
    assert np.array_equal(got[:8 * m].view(np.int64), key.numpy())
    assert np.array_equal(got[8 * m:16 * m].view(np.int64), rank.numpy())
    assert np.array_equal(got[16 * m:], agree.numpy())
    assert max(1, int(r.stdout)) == max_group
