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
    return ModimizerScanner(sh, chunk=chunk, device=CPU, host=False)


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
    """No hidden fallback: device=None without CUDA raises; the host scan
    runs only when asked for (MODIMIZER_SCAN=host or host=True), whatever
    the stream's length; device="cpu" runs the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("checks the policy of a machine without CUDA")
    sh = Seqhash.create(16, 16, 17)
    codes, offsets = _mk(np.random.default_rng(2), 20, 50, 300)
    want = JaxScanner(sh, host_threshold=1 << 62).scan_kmers(codes, offsets)
    monkeypatch.delenv("MODIMIZER_SCAN", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModimizerScanner(sh)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModimizerScanner(sh, host=False)
    asked = ModimizerScanner(sh, host=True)
    assert asked.device is None and asked.host
    assert np.array_equal(asked.scan_kmers(codes, offsets), want)
    assert not asked.used_device
    with pytest.raises(RuntimeError, match="host scan alone"):
        asked.scan_kmers_batches([(codes, offsets)])
    explicit = ModimizerScanner(sh, device="cpu")
    assert not explicit.host
    assert np.array_equal(explicit.scan_kmers(codes, offsets), want)
    assert explicit.used_device
    monkeypatch.setenv("MODIMIZER_SCAN", "host")
    host = ModimizerScanner(sh)
    assert host.device is None and host.host
    assert np.array_equal(host.scan_kmers(codes, offsets), want)
    assert not host.used_device
    assert ModimizerScanner(sh, device="cpu").host
    assert not ModimizerScanner(sh, device="cpu", host=False).host
    monkeypatch.setenv("MODIMIZER_SCAN", "device")
    with pytest.raises(RuntimeError, match="CUDA"):
        ModimizerScanner(sh)


def _layout(name, k, C, rng, wide_run):
    """(codes, offsets) of one read-boundary layout over a few chunks of C
    positions (see test_chunk_pipeline_at_read_boundaries)."""
    if name == "short_and_empty":
        # reads shorter than k and empty reads among ordinary ones
        pool = [0, 1, k - 2, k - 1, k, k + 1]
        lens = []
        while sum(lens) < 2 * C + C // 2:
            lens.append(int(rng.choice(pool)) if rng.random() < 0.5
                        else int(rng.integers(30, 300)))
        cuts = np.cumsum(lens)
    elif name == "ends_on_chunk_end":
        # reads ending on a chunk's last position, the last chunk full
        cuts = np.unique(np.concatenate(
            [rng.integers(1, 3 * C, 3 * C // 200), [C, 2 * C, 3 * C]]))
    elif name == "straddle":
        # one read over a chunk boundary, the stream ending mid-chunk
        n = 2 * C + 777
        cuts = np.unique(np.concatenate(
            [rng.integers(1, n, n // 300), [n]]))
        cuts = np.concatenate([cuts[cuts < C - 1000], [C - 1000, C + 1000],
                               cuts[cuts > C + 1000]])
    else:                       # "poly_a"
        n = 2 * C + C // 2
        cuts = np.unique(np.concatenate(
            [rng.integers(1, n, n // 250), [C // 4, C // 2, C - 50,
                                            2 * C + 50, n]]))
        cuts = cuts[(cuts <= C - 50) | (cuts >= 2 * C + 50)]
    offsets = np.concatenate([[0], cuts]).astype(np.int64)
    codes = rng.integers(0, 4, offsets[-1]).astype(np.uint8)
    if name == "poly_a":
        # a run that overflows one block's bo but not the wide retry's,
        # and a read of As over all of chunk 1: the host rescan
        codes[C // 4 + 100:C // 4 + 100 + wide_run] = 0
        codes[C - 50:2 * C + 50] = 0
    return codes, offsets


@pytest.mark.parametrize("layout", ["short_and_empty", "ends_on_chunk_end",
                                    "straddle", "poly_a"])
@pytest.mark.parametrize("k,w,C", [(16, 16, 1 << 13), (19, 31, 1 << 14)])
def test_chunk_pipeline_at_read_boundaries(k, w, C, layout):
    """Every chunk carries its read-validity words to the kernel: no row
    that crosses a read boundary leaves the card, so scan_stream and
    scan_batch give the JAX scanner's device path's rows and the native
    host scan's, on reads shorter than k, empty reads, reads ending on a
    chunk's last position, a read over a chunk boundary with the stream
    ending mid-chunk, and poly-A reads that take the wide retry and the
    host rescan."""
    from modimizer_tpu.io.seqio import SeqBatch
    sh = Seqhash.create(k, w, 17)
    dev = _port(sh, C)
    wide_bo = dev._wide()[0]
    codes, offsets = _layout(layout, k, C, np.random.default_rng(k + w),
                             (dev.bo + wide_bo) // 2 + k - 1)
    host = ModimizerScanner(sh, host=True)
    jdev = JaxScanner(sh, chunk=C, host_threshold=0)
    want = host.scan_stream(codes, offsets)
    assert len(want[0]) > 0
    for got in (dev.scan_stream(codes, offsets),
                jdev.scan_stream(codes, offsets)):
        for g, h in zip(got, want):
            assert np.array_equal(g, h)
    batch = SeqBatch(codes=codes.astype(np.int8), offsets=offsets)
    want_b = host.scan_batch(batch)
    for got in (dev.scan_batch(batch), jdev.scan_batch(batch)):
        for g, h in zip(got, want_b):
            assert np.array_equal(g, h)
    kb = _port(sh, C)
    assert np.array_equal(kb.scan_kmers(codes, offsets), want[0])
    assert np.array_equal(kb.scan_kmers_batches(_batches(codes, offsets, 3)),
                          want[0])
    if layout == "poly_a":
        assert dev.n_wide > dev.n_fallback > 0
        assert kb.n_wide > kb.n_fallback > 0
    else:
        assert dev.n_wide == dev.n_fallback == 0
