"""The port's span-and-counter recorder (``modimizer_tpu_torch/utils/
profiling.py``) on whole jobs with ``device="cpu"``: ``modutils -a``
through the builder (the benchmark's build) and ``modmap -f -q``.  One
root span a job, every span inside its parent and tagged with its job id;
the counters equal the job's sizes; nothing is recorded with recording
off; the benchmark's stand-in for ``profiling.stage`` still sees every
span; under a CPU ``torch.profiler`` each span, put on the profiler's
clock through its job's anchor, lies within its ``stage:`` mark to 1 ms;
self times; and the ``MODIMIZER_STAGES`` report."""

import contextlib
import gzip
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from modimizer_tpu_torch.cli import modmap, modutils
from modimizer_tpu_torch.core.seqhash import Seqhash
from modimizer_tpu_torch.io import seqio
from modimizer_tpu_torch.ops.seqhash import ModimizerScanner
from modimizer_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
N_READS, READ_LEN, GENOME_LEN = 40, 1500, 30_000
# the names the benchmark's recorder read before the program recorded
BUILD_STAGES = {"read", "count.pack", "count.scan", "count.check",
                "count.compact", "count.download", "count.replay"}
MAP_STAGES = {"ref.parse", "ref.scan", "map.parse", "map.scan",
              "map.lookup", "map.chain"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """ref.fa (one record) and reads.fa (reads cut from it, every third
    reverse-complemented)."""
    d = tmp_path_factory.mktemp("profiling")
    rng = np.random.default_rng(20)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, GENOME_LEN)
    with open(d / "ref.fa", "wb") as f:
        f.write(b">chr\n" + acgt[genome].tobytes() + b"\n")
    with open(d / "reads.fa", "wb") as f:
        for i, s in enumerate(rng.integers(0, GENOME_LEN - READ_LEN,
                                           N_READS)):
            r = genome[s:s + READ_LEN]
            if i % 3 == 0:
                r = 3 - r[::-1]
            f.write(b">r%d\n" % i + acgt[r].tobytes() + b"\n")
    return d


@pytest.fixture
def recorder(monkeypatch):
    """An empty record list, recording on (MODIMIZER_STAGES=1), and the
    builder's path for inputs of 2^12 bases or more."""
    monkeypatch.setattr(profiling, "_jobs", [])
    monkeypatch.setenv("MODIMIZER_STAGES", "1")
    monkeypatch.delenv("MODIMIZER_TRACE", raising=False)
    monkeypatch.setattr(modutils, "DEVICE_COUNT_THRESHOLD", 1 << 12)


def build_argv(d):
    return ["-c", "20", "19", "31", "17", "-a", str(d / "reads.fa"),
            "-s", "10", "45", "75"]


def map_argv(d):
    return ["-K", "24", "-W", "31", "-S", "17", "-B", "20",
            "-f", str(d / "ref.fa"), "-q", str(d / "reads.fa")]


def run(main, argv):
    """stdout of ``main(argv, device="cpu")``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        main(argv, device="cpu")
    return out.getvalue()


def host_rows(path, k, w):
    """The k-mers the native host scan emits from a FASTA file."""
    batch, _t = seqio.read_seq_file(str(path), seqio.dna2index_n0(),
                                    is_qual=False, want_ids=False)
    scanner = ModimizerScanner(Seqhash.create(k, w, 17), host=True)
    return scanner.scan_stream(batch.codes, batch.offsets)[0]


def check_tree(rec, root):
    spans = rec.spans
    assert spans[0].name == root and spans[0].parent is None
    assert [s.parent is None for s in spans].count(True) == 1
    for i, s in enumerate(spans):
        assert s.job == rec.id
        assert s.start_ns <= s.end_ns
        if i:
            p = spans[s.parent]
            assert s.parent < i
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_a_build_job_is_one_tree_and_counts_its_work(data, recorder):
    text = run(modutils.main, build_argv(data))
    (rec,) = profiling.jobs()
    check_tree(rec, "modutils")
    names = {s.name for s in rec.spans}
    assert BUILD_STAGES | {"count.validity", "mod.copy", "mod.summary"} \
        <= names
    rows = host_rows(data / "reads.fa", 19, 31)
    assert rec.counters["parse.bases"] == N_READS * READ_LEN
    assert rec.counters["scan.rows"] == len(rows)
    assert "total hashes %d," % len(rows) in text
    assert rec.counters["parse.mapped"] == 1
    assert rec.counters["parse.threads"] == 1       # under 8 MiB: one
    assert set(rec.counters) == {"parse.bases", "scan.rows", "parse.mapped",
                                 "parse.threads"}


def test_a_map_job_is_one_tree_and_counts_its_work(data, recorder):
    run(modmap.main, map_argv(data))
    (rec,) = profiling.jobs()
    check_tree(rec, "modmap")
    spans = rec.spans
    names = [s.name for s in spans]
    assert MAP_STAGES | {"ref.index", "map.table", "map.emit",
                         "scan.pack", "scan.dispatch", "scan.download",
                         "scan.validity", "scan.rid_rpos"} <= set(names)
    chain = spans[names.index("map.chain")]
    assert spans[chain.parent].name == "map.emit"
    table = spans[names.index("map.table")]
    assert spans[table.parent].name == "map.lookup"
    ref = host_rows(data / "ref.fa", 24, 31)
    query = host_rows(data / "reads.fa", 24, 31)
    c = rec.counters
    assert c["parse.bases"] == GENOME_LEN + N_READS * READ_LEN
    assert c["parse.mapped"] == 2                  # the reference, the reads
    assert c["parse.threads"] == 2
    assert c["scan.rows"] == len(ref) + len(query)
    assert c["lookup.queries"] == len(query)
    assert c["lookup.hits"] == np.isin(query, ref).sum() > 0


def test_a_plain_fasta_is_parsed_from_a_map(data, recorder, tmp_path):
    gz = tmp_path / "reads.fa.gz"
    gz.write_bytes(gzip.compress((data / "reads.fa").read_bytes()))
    for name, mapped in [(data / "reads.fa", 1), (gz, None)]:
        with profiling.job("parse"):
            batch, ftype = seqio.read_seq_file(str(name))
        rec = profiling.jobs()[-1]
        assert ftype == seqio.FASTA and batch.n == N_READS
        assert rec.counters.get("parse.mapped") == mapped
        assert rec.counters["parse.threads"] >= 1


def test_the_host_lookup_counts_too(data, recorder, monkeypatch):
    monkeypatch.setenv("MODIMIZER_SCAN", "host")
    run(modmap.main, map_argv(data))
    (rec,) = profiling.jobs()
    ref = host_rows(data / "ref.fa", 24, 31)
    query = host_rows(data / "reads.fa", 24, 31)
    assert rec.counters["lookup.queries"] == len(query)
    assert rec.counters["lookup.hits"] == np.isin(query, ref).sum()


@pytest.mark.parametrize("tool", ["modutils", "modmap"])
def test_nothing_is_recorded_with_recording_off(data, recorder,
                                                monkeypatch, tool):
    monkeypatch.delenv("MODIMIZER_STAGES")
    main, argv = ((modutils.main, build_argv(data)) if tool == "modutils"
                  else (modmap.main, map_argv(data)))
    run(main, argv)
    assert profiling.jobs() == []
    assert not profiling.recording()


def test_the_benchmarks_stage_recorder_still_sees_every_span(data,
                                                             recorder):
    spec = importlib.util.spec_from_file_location(
        "bench_trace_for_test", REPO / "portbench" / "bench_trace.py")
    bench_trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_trace)
    with bench_trace.StageRecorder(
            profiling, torch.profiler.record_function) as stand_in:
        run(modutils.main, build_argv(data))
        run(modmap.main, map_argv(data))
    assert profiling.stage is not stand_in.stage
    seen = [n for n, _s, _e in stand_in.spans]
    jobs = profiling.jobs()
    assert [rec.name for rec in jobs] == ["modutils", "modmap"]
    assert sorted(seen) == sorted(s.name for rec in jobs
                                  for s in rec.spans)
    assert BUILD_STAGES | MAP_STAGES <= set(seen)


def test_spans_lie_on_the_profilers_clock(data, recorder, monkeypatch):
    """Through the job's anchor, each span lies within its stage: mark
    (``trace_start_ns() + time_range``) to 1 ms at either end, and each
    span is marked once.  The recorder reads a span's bounds inside its
    mark, so on a right anchor the span starts no earlier than the mark
    and ends no later, however long the interpreter takes between a mark's
    stamp and the recorder's read (a collection, a preemption); an anchor
    off by more than 1 ms either way puts some span's tight start or end
    outside its mark.  The median gap between a bound and its mark's is
    under 1 ms."""
    monkeypatch.delenv("MODIMIZER_STAGES")     # the profiler turns it on
    for _ in range(2):           # the first marks of a process start late
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            run(modmap.main, map_argv(data))
    _first, rec = profiling.jobs()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    marks = {}
    for e in prof.events():
        if e.name.startswith("stage:"):
            marks.setdefault(e.name[6:], []).append(
                (t0 + int(e.time_range.start * 1e3),
                 t0 + int(e.time_range.end * 1e3)))
    by_name = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s)
    assert sorted(marks) == sorted(by_name)
    gaps = []
    for name, spans in by_name.items():
        assert len(marks[name]) == len(spans)
        for s, (m0, m1) in zip(spans, sorted(marks[name])):
            assert m0 - 1_000_000 <= rec.clock_ns(s.start_ns), name
            assert rec.clock_ns(s.end_ns) <= m1 + 1_000_000, name
            gaps += [rec.clock_ns(s.start_ns) - m0,
                     m1 - rec.clock_ns(s.end_ns)]
    # bounds read late or early as a rule show in the median gap; one
    # stretched by a collection or a preemption does not
    assert np.median(gaps) <= 1_000_000


def test_self_time_is_the_span_less_its_childrens_union():
    rec = profiling.Job("t")
    for name, parent, s, e in [("root", None, 0, 100), ("a", 0, 10, 40),
                               ("b", 0, 30, 60), ("a.x", 1, 12, 20),
                               ("c", 0, 90, 120)]:
        span = profiling.Span(name, parent, rec.id, 0, s)
        span.end_ns = e
        rec.spans.append(span)
    assert rec.self_ns() == [100 - 50 - 10, 30 - 8, 30, 8, 30]
    by_name, counters = profiling.totals([rec, rec])
    assert by_name["a"] == [2, pytest.approx(60e-9), pytest.approx(44e-9)]
    assert counters == {}


def test_counts_and_nested_jobs(recorder):
    with profiling.job("outer"):
        profiling.count("x", 2)
        with profiling.job("inner"):
            profiling.count("x", 3)
            with profiling.span("s"):
                pass
    profiling.count("x", 100)                  # outside any job: dropped
    (rec,) = profiling.jobs()
    assert [(s.name, s.parent) for s in rec.spans] == \
        [("outer", None), ("inner", 0), ("s", 1)]
    assert rec.counters == {"x": 5}


def test_the_stages_report_has_self_time_and_counters(data, recorder):
    run(modutils.main, build_argv(data))
    f = io.StringIO()
    profiling.report(f)
    lines = f.getvalue().splitlines()
    assert lines[0] == "── stage timers (MODIMIZER_STAGES) ──"
    (read,) = [ln for ln in lines if ln.split()[0] == "read"]
    assert read.split()[2:] == ["s", "x1", "self"] + read.split()[5:]
    (bases,) = [ln for ln in lines if ln.split()[0] == "parse.bases"]
    assert bases.split() == ["parse.bases", str(N_READS * READ_LEN)]
