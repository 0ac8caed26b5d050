"""The modset input, the assembly reference and the asm cell on the CPU at
test size: the plain writer against the port's ``modutils -w``, the
plain re-derivation of modasm against the port's ``modasm`` (both phase-1
paths), the cell's run, planted faults, the unchanged FASTA inputs and
the per-layer readers.  The control: ``test_portbench_control.py``.
``test_a_broken_program_is_not_correct_at_the_cells_size`` plants the
faults at the cell's own size, on the card."""

import functools
import gzip
import hashlib
import json
import os
import time
from types import SimpleNamespace as NS

import numpy as np
import pytest

from bench_data import make_inputs, write_inputs
from bench_harness import Spy, run_cell, run_job
from bench_roofline import HBM_BYTES_S
from bench_trace import Window
from checks import asm, text_lines
from conftest import ROOT, tiny
from reference import asm_ref
from reference.build_ref import build

CELL = "ecoli_hifi30x.asm"
# 6x coverage, so that copy-1 mods (depth 3 to 11) join most reads
SMALL = dict(genome_len=20_000, n_reads=60, read_len=2_000,
             copy_thresholds=[3, 12, 20], table_bits=20)


def small_cfg(spec, **over):
    return tiny(spec.config(spec.cell(CELL)), **dict(SMALL, **over))


def small_traffic(spec):
    """The cell's traffic with a share of inverted duplicates that gives
    three of the 60 reads at test size."""
    t = spec.traffic(spec.cell(CELL))
    return dict(t, read_lengths=dict(t["read_lengths"], inverted=0.05))


def argv(spec, u=False):
    """The cell's argv (files named as the harness names them), with -u
    before -S where ``u``."""
    got = list(spec.traffic(spec.cell(CELL))["argv"])
    if u:
        got.insert(got.index("-S"), "-u")
    return got


def edge(inputs, seed):
    """Reads the walk has to flag: a copy-1 stretch repeated within a read
    (BAD_REPEAT, twice), halves swapped (order violations), a half
    reverse-complemented (strand flips), random bases (no match).  Every
    read is 2,000 bases or more at test size."""
    r, lens = inputs["reads"], inputs["read_lens"]

    def read(i):
        return r[i, :lens[i]]

    r[3, 1200:1500] = r[3, 200:500]
    r[17, :1000] = r[17, 1000:2000]
    read(7)[:] = np.concatenate([read(7)[1000:], read(7)[:1000]])
    read(11)[1000:] = 3 - read(11)[1000:][::-1]
    read(13)[:] = np.random.default_rng(seed + 99).integers(
        0, 4, lens[13], dtype=np.uint8)
    return inputs


@functools.lru_cache(maxsize=None)
def case(seed, edged, directory):
    """The inputs of one small case, written once."""
    from bench_harness import Spec
    spec = Spec(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = small_cfg(spec)
    inputs = make_inputs(cfg, seed, small_traffic(spec))
    if edged:
        edge(inputs, seed)
    d = os.path.join(directory, "s%d%s" % (seed, "e" if edged else ""))
    os.makedirs(d, exist_ok=True)
    return cfg, inputs, write_inputs(inputs, cfg, ["reads", "modset"], d)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("asm"))


def port_job(paths, commands, out):
    """One port modasm job on the CPU: (stdout, what the check compares of
    the kept Readset and the phase-1 passes)."""
    from modimizer_tpu_torch.cli import modasm
    with Spy(asm.SPY, 1, asm.RETURNS) as spy:
        spy.job_start()
        ok, err = run_job(modasm.main, ["-m", paths["modset"], "-f",
                                        paths["reads"], *commands], out,
                          "cpu")
        spy.job_done(0)
    assert ok, err
    with open(out) as f:
        return f.read(), asm.port_output(spy.kept, spy.kept_returned)


# -- the modset input ----------------------------------------------------

@pytest.mark.parametrize("k,w", [(19, 31), (16, 16)])
def test_the_modset_file_is_the_ports(spec, tmp_path, k, w):
    from modimizer_tpu_torch.cli import modutils
    from modimizer_tpu_torch.core.modset import Modset
    cfg = small_cfg(spec, k=k, w=w)
    inputs = make_inputs(cfg, 2 ** 32 + 3, spec.traffic(spec.cell(CELL)))
    paths = write_inputs(inputs, cfg, ["reads", "modset"], str(tmp_path))
    assert paths["modset"].endswith(".mod")
    port = str(tmp_path / "port.mod")
    ok, err = run_job(modutils.main, [
        "-c", str(cfg["table_bits"]), str(k), str(w), str(cfg["hash_seed"]),
        "-a", paths["reads"], "-s", *map(str, cfg["copy_thresholds"]),
        "-w", port], str(tmp_path / "out.txt"), "cpu")
    assert ok, err
    mine = gzip.open(paths["modset"]).read()
    assert mine == gzip.open(port).read()
    ms = Modset.read(paths["modset"])
    t = build(inputs["reads"], cfg, "cpu", lens=inputs["read_lens"])
    n = int(ms.max)
    assert n == len(t["kmers"])
    assert np.array_equal(ms.value[1:n + 1], t["kmers"])
    assert np.array_equal(ms.depth[1:n + 1], t["depth"])
    assert np.array_equal(ms.info[1:n + 1], t["info"])


def test_an_unknown_input_kind_is_refused(tmp_path):
    with pytest.raises(ValueError, match="no input of the kind"):
        write_inputs({}, {}, ["reads", "quals"], str(tmp_path))


# the FASTA bytes of the inputs, before modset inputs came: the cells'
# inputs must not move (sha256 of genome.fa and reads.fa, seed 2^33 + 5)
FASTA_SHA256 = {
    ("ecoli_hifi30x.build", "tiny"): (
        "6c050853238735265c050073f46059858453ca68df76592e20a5fc8a1e70febd",
        "dce36a1f98a193ef3f999540c9f3167c24c52aca8649a609f632b9cdbf203139"),
    ("grch38_chr20.map", "tiny"): (
        "a75c744319cef3f7c3e53f0d5c8f99fa2475c0e494be110702bfc136eee92873",
        "0fb3a5fbecf29720b18f0d0504cef4a86573f40641370d509a1859067563f334"),
    ("ecoli_hifi30x.build", "full"): (
        "156aed651d550a19c26b7307a99def842e61d3c8b041264cfe70806a8eb17a4f",
        "dea190a9088cef70c7e15d04aa67f9ecbc325dd0287caca3ea3fefaf45068f60"),
    ("grch38_chr20.map", "full"): (
        "d8099fd383c298ec514af9245a6676ffd00d7c0a1fe490723a12183089938cec",
        "8f5d3d7a858b6f79ed1aa519e54b8b4efc5559adc8d07eed5465e67144bd860a"),
}


@pytest.mark.parametrize("cell,size", sorted(FASTA_SHA256))
def test_the_fasta_inputs_are_unchanged(spec, tmp_path, cell, size):
    cfg = spec.config(spec.cell(cell))
    cfg = tiny(cfg) if size == "tiny" else cfg
    paths = write_inputs(make_inputs(cfg, 2 ** 33 + 5,
                                     spec.traffic(spec.cell(cell))), cfg,
                         ["genome", "reads"], str(tmp_path))
    got = tuple(hashlib.sha256(open(paths[k], "rb").read()).hexdigest()
                for k in ("genome", "reads"))
    assert got == FASTA_SHA256[cell, size]


# -- the reference against the port --------------------------------------

# seeds on which -u's link walk ends (test_cluster_link_cycle: where it
# does not); 4 with reads built to be flagged too
SEEDS = [(1, False), (3, False), (4, False), (4, True)]
CYCLE_SEED = 2


@pytest.mark.parametrize("overlaps", ["device", "host"])
@pytest.mark.parametrize("u", [False, True], ids=["cell", "with_u"])
@pytest.mark.parametrize("seed,edged", SEEDS)
def test_the_reference_is_the_ports_modasm(spec, monkeypatch, work, overlaps,
                                           u, seed, edged):
    monkeypatch.setenv("MODIMIZER_OVERLAPS", overlaps)
    cfg, inputs, paths = case(seed, edged, work)
    job = argv(spec, u)
    want = asm.expected(inputs, cfg, "cpu", job)
    text, port = port_job(paths, asm.commands(job), os.path.join(
        work, "%d%s%s%d.out" % (seed, edged, overlaps, u)))
    assert text_lines(text) == want["lines"]
    assert asm.numbers(port, [text], want) == dict.fromkeys(asm.LIMITS, 0)
    # phase 1 on the device hands each pass its candidates; the host walk
    # none
    assert len(port["passes"]) == (want["passes"] if overlaps == "device"
                                   else 0)
    assert want["pairs"] > 0 and (want["pair_cnt"] >= 3).any()
    # shorter reads inside longer ones; the inverted duplicates repeat
    # their copy-1 mods
    assert (want["contained"] != 0).any()
    assert (want["bad"] & asm_ref.BAD_REPEAT).any()
    if edged:
        bad = want["bad"]
        assert bad[3] & asm_ref.BAD_REPEAT and bad[17] & asm_ref.BAD_REPEAT
        assert bad[13] & asm_ref.BAD_NOMATCH
        assert (bad & asm_ref.BAD_ORDER1).any()


def test_the_edge_case_repeats_a_copy1_mod(spec, work):
    cfg, inputs, _paths = case(4, True, work)
    rs = asm_ref.readset(inputs["reads"], cfg, "cpu",
                         lens=inputs["read_lens"])
    repeat, _pairs = asm_ref.pair_stats(rs, "cpu")
    assert repeat[4] and repeat[18]
    info = np.concatenate([[0], rs["info"]])
    ids = rs["id"][rs["read"] == 4]
    c1 = ids[(info[ids] & 3) == 1]
    assert len(c1) > len(np.unique(c1))


def test_cluster_link_cycle(spec, work):
    """-u's link walk (modasm.c:474-481, kept in the port's native
    rs_cluster): a read whose candidate's cluster root is the read just
    before it writes link[i - 1] = i - 1, and the next walk that reaches
    it never ends.  The reference finds the cycle (the port's job runs on
    past any limit there: PERF.md, Open questions)."""
    cfg, inputs, _paths = case(CYCLE_SEED, False, work)
    with pytest.raises(asm_ref.LinkCycle):
        asm.expected(inputs, cfg, "cpu", argv(spec, u=True))


def test_the_commands_are_the_argv_without_its_inputs(spec):
    assert asm.commands(argv(spec)) == ("-b", "-c", "-S")
    assert asm.commands(["-m", "x.mod", "-b", "-f", "r.fa", "-u"]) == (
        "-b", "-u")


# -- the cell -----------------------------------------------------------

def run_small(spec, trace=False, seed=2 ** 31 + 11):
    return run_cell(spec, CELL, seed, 0.01, trace, "cpu",
                    time.perf_counter(), cfg=small_cfg(spec),
                    say=lambda _s: None)


@pytest.mark.parametrize("overlaps", ["device", "host"])
@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_is_correct(spec, monkeypatch, overlaps, trace):
    monkeypatch.setenv("MODIMIZER_OVERLAPS", overlaps)
    r = run_small(spec, trace)
    assert r["correct"] is True and r["failed"] == 0, r
    json.dumps(r)
    want = {m["name"] for m in spec.metrics(
        "per_layer" if trace else "end_to_end", spec.cell(CELL))}
    if trace:
        # no card: no device time, so no roofline; the host walk: no phases
        want -= {"overlap_roofline.asm"}
        if overlaps == "host":
            want -= {"phase1_share.asm", "phase2_share.asm"}
        assert set(r["metrics"]) == want
    else:
        assert set(r["metrics"]) == want == {"asm_rate", "setup_s"}
    assert all(c["value"] == 0 for c in r["checks"].values())


def fault(monkeypatch, name):
    from modimizer_tpu_torch.cli import modasm
    from modimizer_tpu_torch.core.readset import Readset
    monkeypatch.setenv("MODIMIZER_OVERLAPS", "device")
    if name == "strand_flipped":            # one hit's strand bit
        orig = Readset.file_read

        def flip(self, *a, **k):
            orig(self, *a, **k)
            self.hits[len(self.hits) // 2] ^= np.uint32(0x80000000)
        monkeypatch.setattr(Readset, "file_read", flip)
    elif name == "contained_changed":      # one read marked contained
        orig = modasm._find_overlaps

        def mark(rs, fn, *a, **k):
            orig(rs, fn, *a, **k)
            if fn == "rs_mark_contained":
                rs.contained[5] = 7
        monkeypatch.setattr(modasm, "_find_overlaps", mark)
    elif name == "line_changed":           # one line of -S altered
        orig = Readset.stats

        def stats(self, out):
            import io
            buf = io.StringIO()
            orig(self, buf)
            out.write(buf.getvalue().replace("RS ", "RS  ", 1))
        monkeypatch.setattr(Readset, "stats", stats)
    elif name in ("pair_dropped", "count_changed"):   # phase 1's answer
        orig = Readset.device_overlap_candidates

        def alter(self, *a, **k):
            cy, ch, co = orig(self, *a, **k)
            i = len(cy) // 2
            if name == "count_changed":
                ch = ch.copy()
                ch[i] += 1
                return cy, ch, co
            co = co.copy()
            co[np.searchsorted(co, i, "right"):] -= 1
            return np.delete(cy, i), np.delete(ch, i), co
        monkeypatch.setattr(Readset, "device_overlap_candidates", alter)
    elif name == "state_unchanged":        # -b and -c do nothing
        monkeypatch.setattr(modasm, "_find_overlaps",
                            lambda rs, fn, *a, **k: None)
    elif name == "half_the_reads":         # the readset of every other read
        from modimizer_tpu_torch.io import seqio
        real = seqio.read_seq_file

        def every_other(*a, **k):
            batch, t = real(*a, **k)
            off = np.asarray(batch.offsets, np.int64)
            keep = np.arange(0, batch.n, 2)
            codes = np.concatenate([batch.codes[off[i]:off[i + 1]]
                                    for i in keep])
            new = np.zeros(len(keep) + 1, np.int64)
            np.cumsum(off[keep + 1] - off[keep], out=new[1:])
            return seqio.SeqBatch(codes=codes, offsets=new), t
        monkeypatch.setattr(seqio, "read_seq_file", every_other)


FAULTS = ["strand_flipped", "contained_changed", "line_changed",
          "state_unchanged", "half_the_reads", "pair_dropped",
          "count_changed"]


@pytest.mark.parametrize("name", FAULTS)
def test_a_broken_program_is_not_correct(spec, monkeypatch, name):
    fault(monkeypatch, name)
    r = run_small(spec)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
    if name in ("pair_dropped", "count_changed"):
        assert r["checks"]["pairs_wrong"]["value"] > 0


@pytest.mark.chip
@pytest.mark.parametrize("name,seed", [("pair_dropped", 2 ** 31 + s)
                                       for s in (21, 22, 23)]
                         + [(n, 2 ** 31 + 24) for n in FAULTS
                            if n != "pair_dropped"])
def test_a_broken_program_is_not_correct_at_the_cells_size(
        spec, cuda_card, monkeypatch, name, seed):
    fault(monkeypatch, name)
    r = run_cell(spec, CELL, seed, 1, False, cuda_card, time.perf_counter(),
                 say=lambda _s: None)
    print(json.dumps({"fault": name, "seed": seed, "checks": r["checks"]}))
    assert r["correct"] is False


# -- the per-layer readers -----------------------------------------------

SIZES = {"hit_rows": 4_480_000, "pairs": 564_339, "passes": 2}


def test_the_overlap_roofline(spec):
    dev = [("void overlap_groups_kernel(int const*)", 0, 100),
           ("overlap_join_kernel(Rows, int)", 100, 400),
           ("void at::native::radixSortKVInPlace<long>(int)", 400, 900),
           ("overlap_dense_kernel(Rows)", 900, 1000)]
    w = Window(10.0, 3, [], SIZES, (0, 10_000_000), dev)
    got = spec.reader("overlap_roofline.asm")(w)
    n = 3 * 2 * (4_480_000 * 15 + 564_339 * 32)
    assert got == pytest.approx(100 * n / HBM_BYTES_S / 500e-6)
    assert spec.reader("idle_share.asm")(w) == pytest.approx(
        100 * (1 - 1_000 / 10_000_000))


def record(children):
    S = 1_000_000_000
    spans = [NS(name="modasm", parent=None, start_ns=0, end_ns=10 * S)]
    spans += [NS(name=n, parent=p, start_ns=int(a * S), end_ns=int(b * S))
              for n, p, a, b in children]
    return NS(name="modasm", counters={}, spans=spans)


def test_the_span_readers(spec, monkeypatch):
    from modimizer_tpu_torch.utils import profiling
    job = record([("mod.summary", 0, 0.5, 0.6), ("rs.parse", 0, 1, 2),
                  ("rs.scan", 0, 2, 3.5), ("rs.lookup", 0, 3.5, 4),
                  ("asm.phase1", 0, 4.5, 7), ("overlaps.prep", 5, 4.5, 6),
                  ("asm.phase2", 0, 7, 8), ("asm.phase1", 0, 8, 9),
                  ("asm.phase2", 0, 9, 9.5)])
    monkeypatch.setattr(profiling, "jobs", lambda: [job, job])
    w = Window(40.0, 2, [], SIZES)
    want = {"readset_share.asm": 2 * 3.0, "phase1_share.asm": 2 * 3.5,
            "phase2_share.asm": 2 * 1.5,
            "unnamed_share.asm": 2 * (10 - 0.1 - 3 - 3.5 - 1.5)}
    for name, s in want.items():
        assert spec.reader(name)(w) == pytest.approx(100 * s / 40.0), name
    monkeypatch.setattr(profiling, "jobs", lambda: [])
    for name in want:
        assert spec.reader(name)(w) is None
    empty = Window(10.0, 2, [], SIZES)
    assert spec.reader("overlap_roofline.asm")(empty) is None
    assert spec.reader("idle_share.asm")(empty) is None
