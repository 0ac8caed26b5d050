"""The port's ModimizerScanner on explicit CPU tensors (the plain versions
of the kernels) vs the JAX scanner's device path on CPU-jax and vs the
native host path: scan_kmers, scan_kmers_batches and scan_stream, with the
cases and overflow-tier asserts of tests/test_scan_kmers.py."""

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

from modimizer_tpu.core.seqhash import Seqhash  # noqa: E402
from modimizer_tpu.ops.seqhash import ModimizerScanner as JaxScanner  # noqa: E402
from modimizer_tpu_torch.ops.seqhash import ModimizerScanner  # noqa: E402

CPU = torch.device("cpu")


def _mk(rng, n_reads, lo, hi):
    lens = rng.integers(lo, hi, n_reads)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    codes = rng.integers(0, 4, offsets[-1]).astype(np.uint8)
    return codes, offsets


def _port(sh, chunk=1 << 14):
    return ModimizerScanner(sh, chunk=chunk, device=CPU, host_threshold=0)


def _batches(codes, offsets, n_parts):
    """Whole-read batches of a stream, re-based to offset 0."""
    cut = np.linspace(0, len(offsets) - 1, n_parts + 1).astype(int)
    for a, b in zip(cut[:-1], cut[1:]):
        o = offsets[a:b + 1]
        yield codes[o[0]:o[-1]], o - o[0]


@pytest.mark.parametrize("k,w", [(16, 16), (19, 31), (11, 10)])
def test_scan_kmers_matches_jax_device_and_host(k, w):
    sh = Seqhash.create(k, w, 17)
    codes, offsets = _mk(np.random.default_rng(5), 300, 50, 900)
    want = JaxScanner(sh, host_threshold=1 << 62).scan_kmers(codes, offsets)
    jdev = JaxScanner(sh, chunk=1 << 14, host_threshold=0)
    assert np.array_equal(jdev.scan_kmers(codes, offsets), want)
    dev = _port(sh)
    got = dev.scan_kmers(codes, offsets)
    assert dev.used_device
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    parts = []
    assert dev.scan_kmers(codes, offsets, consumer=parts.append) == len(want)
    assert np.array_equal(np.concatenate(parts), want)
    # streaming path: identical chunking and rows from any batch split
    for n_parts in (1, 7):
        got_b = _port(sh).scan_kmers_batches(_batches(codes, offsets,
                                                      n_parts))
        assert np.array_equal(got_b, want), n_parts
    assert np.array_equal(
        jdev.scan_kmers_batches(_batches(codes, offsets, 3)), want)


@pytest.mark.parametrize("k,w", [(16, 16), (19, 31)])
def test_scan_stream_matches_jax_device_and_host(k, w):
    sh = Seqhash.create(k, w, 17)
    codes, offsets = _mk(np.random.default_rng(6), 200, 20, 700)
    want = JaxScanner(sh, host_threshold=1 << 62).scan_stream(codes, offsets)
    jdev = JaxScanner(sh, chunk=1 << 13, host_threshold=0).scan_stream(
        codes, offsets)
    got = _port(sh, 1 << 13).scan_stream(codes, offsets)
    for g, h, j in zip(got, want, jdev):
        assert np.array_equal(g, h) and np.array_equal(g, j)


def test_scan_kmers_overflow_rescan():
    """An all-A stream overflows even the wide retry: the exact native
    rescan takes the chunk."""
    sh = Seqhash.create(16, 16, 17)
    codes = np.zeros(1 << 15, np.uint8)
    offsets = np.array([0, len(codes)], np.int64)
    want = JaxScanner(sh, host_threshold=1 << 62).scan_kmers(codes, offsets)
    dev = _port(sh)
    assert np.array_equal(dev.scan_kmers(codes, offsets), want)
    assert dev.n_wide > 0 and dev.n_fallback > 0
    dev_b = _port(sh)
    assert np.array_equal(dev_b.scan_kmers_batches([(codes, offsets)]), want)
    assert dev_b.n_fallback > 0


def test_scan_kmers_overflow_wide_retry():
    """A ~220 bp poly-A run overflows one block's bo; the 4x-wide device
    retry absorbs it without the host rescan, on every scan entry point."""
    sh = Seqhash.create(16, 16, 17)
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 1 << 15).astype(np.uint8)
    codes[5000:5000 + 220] = 0
    offsets = np.array([0, len(codes)], np.int64)
    host = JaxScanner(sh, host_threshold=1 << 62)
    want = host.scan_kmers(codes, offsets)
    dev = _port(sh)
    assert np.array_equal(dev.scan_kmers(codes, offsets), want)
    assert dev.n_wide > 0 and dev.n_fallback == 0
    dev_b = _port(sh)
    assert np.array_equal(dev_b.scan_kmers_batches([(codes, offsets)]), want)
    assert dev_b.n_wide > 0 and dev_b.n_fallback == 0
    dev2 = _port(sh)
    kk, pp, ff = dev2.scan_stream(codes, offsets)
    hk, hp, hf = host.scan_stream(codes, offsets)
    assert np.array_equal(kk, hk) and np.array_equal(pp, hp)
    assert np.array_equal(ff, hf)
    assert dev2.n_wide > 0 and dev2.n_fallback == 0


def test_scan_batch_matches_jax():
    from modimizer_tpu.io.seqio import SeqBatch
    sh = Seqhash.create(16, 16, 17)
    codes, offsets = _mk(np.random.default_rng(11), 60, 40, 500)
    batch = SeqBatch(codes=codes.astype(np.int8), offsets=offsets)
    want = JaxScanner(sh, host_threshold=1 << 62).scan_batch(batch)
    got = _port(sh, 1 << 13).scan_batch(batch)
    for g, h in zip(got, want):
        assert np.array_equal(g, h)


def test_device_policy_without_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the policy of a machine without CUDA")
    sh = Seqhash.create(16, 16, 17)
    monkeypatch.delenv("MODIMIZER_SCAN", raising=False)
    auto = ModimizerScanner(sh)
    assert auto.device is None and auto.host_threshold >= 1 << 62
    codes, offsets = _mk(np.random.default_rng(2), 20, 50, 300)
    want = JaxScanner(sh, host_threshold=1 << 62).scan_kmers(codes, offsets)
    assert np.array_equal(auto.scan_kmers(codes, offsets), want)
    assert not auto.used_device
    with pytest.raises(RuntimeError):
        auto.scan_kmers_batches([(codes, offsets)])
    with pytest.raises(RuntimeError):
        ModimizerScanner(sh, host_threshold=0)
    explicit = ModimizerScanner(sh, device="cpu")
    assert explicit.host_threshold == 0
    monkeypatch.setenv("MODIMIZER_SCAN", "device")
    with pytest.raises(RuntimeError, match="CUDA"):
        ModimizerScanner(sh)
    monkeypatch.setenv("MODIMIZER_SCAN", "host")
    assert ModimizerScanner(sh, device="cpu").host_threshold >= 1 << 62
