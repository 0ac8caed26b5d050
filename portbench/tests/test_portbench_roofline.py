"""The byte counts of the rooflines and the shares they give."""

import pytest

from bench_roofline import HBM_BYTES_S, lookup_bytes, scan_bytes, share_pct


def test_scan_bytes_are_the_bases_in_and_the_rows_out():
    assert scan_bytes(4_000, 0) == 1_000
    assert scan_bytes(0, 10) == 120
    assert scan_bytes(139_245_000, 4_500_000) == 139_245_000 / 4 + 54e6


def test_lookup_bytes_are_the_keys_the_queries_and_the_hits():
    # the port's probe counted 2,083,453 keys and 967,742 queries alike
    assert lookup_bytes(10, 100, 40) == 80 + 1200 + 160


def test_share_is_the_bound_over_the_device_time():
    assert share_pct(HBM_BYTES_S, 2.0) == pytest.approx(50.0)
    assert share_pct(1e9, None) is None
    assert share_pct(1e9, 0.0) is None
