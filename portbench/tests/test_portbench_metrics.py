"""Each per-layer metric's reader on a canned window: stage spans, device
events and one job's sizes."""

import pytest

from bench_roofline import HBM_BYTES_S
from bench_trace import Window, breakdown

SIZES = {"scan_bases": 4e9, "scan_rows": 1e8, "keys": 2e6,
         "queries": 6e6, "hits": 5e6}


def window():
    spans = [("read", 0.0, 1.0), ("read", 2.0, 2.5), ("ref.parse", 3, 3.2),
             ("map.parse", 4, 4.3), ("count.replay", 5, 5.1),
             ("map.chain", 6, 6.4)]
    dev = [("scan_compact_kernel(unsigned long const*)", 0, 1_000),
           ("void densify_rows_kernel<12>(int)", 500, 1_500),
           ("find_sorted_kernel(long const*)", 2_000, 2_500),
           ("Memcpy DtoH (Device -> Pinned)", 3_000, 3_100)]
    return Window(10.0, 2, spans, SIZES, (0, 10_000_000), dev)


@pytest.mark.parametrize("name,want", [
    ("parse_share.build", 15.0), ("parse_share.map", 5.0),
    ("replay_share.build", 1.0), ("chain_share.map", 4.0),
    ("idle_share.build", 100 * (1 - 2_100 / 10_000_000)),
    ("idle_share.map", 100 * (1 - 2_100 / 10_000_000))])
def test_shares(spec, name, want):
    assert spec.reader(name)(window()) == pytest.approx(want)


@pytest.mark.parametrize("cell", ["build", "map"])
def test_scan_roofline(spec, cell):
    got = spec.reader("scan_roofline." + cell)(window())
    n = 2 * (4e9 / 4 + 1e8 * 12)
    assert got == pytest.approx(100 * n / HBM_BYTES_S / 2e-3)


def test_lookup_roofline(spec):
    got = spec.reader("lookup_roofline.map")(window())
    n = 2 * (2e6 * 8 + 6e6 * 12 + 5e6 * 4)
    assert got == pytest.approx(100 * n / HBM_BYTES_S / 0.5e-3)


@pytest.mark.parametrize("name", ["parse_share.build", "parse_share.map",
                                  "replay_share.build", "chain_share.map",
                                  "scan_roofline.build", "scan_roofline.map",
                                  "lookup_roofline.map", "idle_share.build",
                                  "idle_share.map"])
def test_a_reader_with_nothing_to_read_returns_nothing(spec, name):
    empty = Window(10.0, 2, [], SIZES)
    assert spec.reader(name)(empty) is None


def test_breakdown_names_gaps_by_the_innermost_stage():
    dev = [("k1(int)", 0, 10), ("k2(int)", 50, 60), ("k1(int)", 100, 130)]
    marks = [("outside stages, in modmap", 0, 200), ("map.parse", 10, 45),
             ("map.scan", 60, 90), ("map.scan.inner", 65, 95)]
    b = breakdown((0, 200), dev, marks)
    assert b["device_ops"] == [["k1", 40e-6], ["k2", 10e-6]]
    assert b["idle_gaps"] == [["outside stages, in modmap", 70e-6],
                              ["map.parse", 40e-6],
                              ["map.scan.inner", 40e-6]]


def test_read_trace_keeps_the_cards_work_and_drops_the_marks():
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType
    from bench_trace import read_trace

    def ev(name, s, e, dev):
        return NS(name=name, time_range=NS(start=s, end=e),
                  device_type=DeviceType.CUDA if dev else DeviceType.CPU)

    prof = NS(events=lambda: [
        ev("window", 100, 900, False), ev("stage:read", 150, 400, False),
        ev("stage:read", 150, 400, True), ev("job:modutils", 120, 800, True),
        ev("scan_compact_kernel(int)", 50, 200, True),
        ev("Memcpy HtoD ", 850, 950, True), ev("k(int)", 950, 990, True)])
    window, device, marks = read_trace(prof)
    assert window == (100, 900)
    assert device == [("scan_compact_kernel(int)", 100, 200),
                      ("Memcpy HtoD ", 850, 900)]
    assert marks == [("read", 150, 400)]


def test_kernel_names_lose_their_return_type_namespace_and_arguments():
    from bench_trace import short_name
    assert short_name("void (anonymous namespace)::scan_compact_kernel<false,"
                      " 256>(unsigned long const*, int)") == \
        "scan_compact_kernel<false, 256>"
    assert short_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD "
