"""The readers of the port's own job records (``bench_spans`` and the five
metrics that use it) on hand-made records, and on a tiny traced cell run
on the CPU."""

from types import SimpleNamespace as NS

import pytest

import bench_spans
from bench_trace import Window

SIZES = {"scan_bases": 4e9, "scan_rows": 1e8, "keys": 2e6,
         "queries": 6e6, "hits": 5e6}
S = 1_000_000_000            # ns a second


def span(name, parent, start, end):
    return NS(name=name, parent=parent, start_ns=start, end_ns=end)


def job(root, children, counters):
    """A record: the root over [0, 10 s], then ``children`` (name, parent,
    start s, end s)."""
    return NS(name=root, counters=counters,
              spans=[span(root, None, 0, 10 * S)]
              + [span(n, p, int(a * S), int(b * S))
                 for n, p, a, b in children])


def build_job():
    return job("modutils", [("read", 0, 0, 6), ("count.pack", 0, 6, 7),
                            ("count.scan", 0, 6.5, 8),
                            ("count.replay", 0, 9, 9.5),
                            ("mod.summary", 3, 7.5, 7.8)],
               {"parse.bases": 120_000_000, "scan.rows": 9})


def map_job():
    return job("modmap", [("ref.index", 0, 0, 0.5),
                          ("ref.parse", 0, 0.5, 1.5), ("map.parse", 0, 2, 5),
                          ("map.emit", 0, 6, 9.5), ("map.chain", 4, 6, 9.4),
                          ("ref.index", 0, 9.5, 10)],
               {"parse.bases": 300_000_000})


@pytest.fixture
def records(monkeypatch):
    """Makes the port's ``profiling.jobs()`` return the list it yields."""
    from modimizer_tpu_torch.utils import profiling
    got = []
    monkeypatch.setattr(profiling, "jobs", lambda: list(got))
    return got


def window(jobs=2):
    return Window(20.0, jobs, [], SIZES)


@pytest.mark.parametrize("name,make,want", [
    # build: the children cover [0, 8] and [9, 9.5]; 1.5 s of 10 unnamed
    ("unnamed_share.build", build_job, 100 * 2 * 1.5 / 20),
    # map: [0, 1.5], [2, 5], [6, 10] (map.chain is map.emit's child)
    ("unnamed_share.map", map_job, 100 * 2 * 1.5 / 20),
    ("index_share.map", map_job, 100 * 2 * 1.0 / 20),
    ("parse_rate.build", build_job, 2 * 120 / (2 * 6)),
    ("parse_rate.map", map_job, 2 * 300 / (2 * 4))])
def test_readers(spec, records, name, make, want):
    records += [make(), make()]
    assert spec.reader(name)(window()) == pytest.approx(want)


def test_only_the_windows_jobs_are_read(spec, records):
    warm = job("modutils", [("read", 0, 0, 1)], {"parse.bases": 1})
    records += [warm, build_job(), build_job()]
    assert bench_spans.window_jobs(window())[0] is records[1]
    assert spec.reader("parse_rate.build")(window()) == pytest.approx(20)


NAMES = ["unnamed_share.build", "unnamed_share.map", "index_share.map",
         "parse_rate.build", "parse_rate.map"]


@pytest.mark.parametrize("name", NAMES)
def test_fewer_records_than_jobs_read_nothing(spec, records, name):
    records += [build_job(), map_job()]
    assert spec.reader(name)(window(jobs=3)) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_port_without_the_recorder_reads_nothing(spec, monkeypatch, name):
    from modimizer_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "jobs")
    assert spec.reader(name)(window()) is None


def test_a_job_without_the_spans_reads_nothing(spec, records):
    records += [job("modmap", [], {}), job("modmap", [], {})]
    assert spec.reader("index_share.map")(window()) is None
    assert spec.reader("parse_rate.map")(window()) is None
    assert spec.reader("unnamed_share.map")(window()) == pytest.approx(100)


@pytest.mark.parametrize("cell", ["ecoli_hifi30x.build", "grch38_chr20.map"])
def test_a_traced_cpu_run_reports_the_new_metrics(spec, monkeypatch, cell):
    from bench_harness import run_cell
    from conftest import tiny
    from modimizer_tpu_torch.cli import modutils
    # the card's path for a tiny read set: counted whole, parsed whole
    monkeypatch.setattr(modutils, "DEVICE_COUNT_THRESHOLD", 1 << 12)
    r = run_cell(spec, cell, 2 ** 31 + 5, 0.01, True, "cpu", 0.0,
                 cfg=tiny(spec.config(spec.cell(cell))), say=lambda _: None)
    kind = cell.split(".")[1]
    got = r["metrics"]
    names = ["unnamed_share." + kind, "parse_rate." + kind] + (
        ["index_share.map"] if kind == "map" else [])
    assert set(names) <= set(got)
    assert 0 <= got["unnamed_share." + kind]["value"] < 100
    assert got["parse_rate." + kind]["value"] > 0
