"""modimizer_tpu_torch.ops.packed (u64 carried in int64) vs the JAX
package's ops/packed.py, bit for bit on numpy-seeded inputs."""

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

import jax.numpy as jnp  # noqa: E402

from modimizer_tpu.core.seqhash import Seqhash  # noqa: E402
from modimizer_tpu.ops import packed as JP  # noqa: E402
from modimizer_tpu_torch.ops import packed as TP  # noqa: E402
from modimizer_tpu_torch.ops.scan_kernel import kernel_params  # noqa: E402

KS = [1, 11, 16, 19, 31]
# the w list of tests/test_scan_kernel.py::test_mod_is_zero_lemire_exact
WS = [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 17, 24, 31, 32, 48, 63, 100,
      255, 1000, 65537, (1 << 20) + 7]


def t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def u64(t):
    return t.numpy().view(np.uint64)


def full_range_u64(rng, n):
    return ((rng.integers(0, 1 << 32, n).astype(np.uint64) << np.uint64(32))
            | rng.integers(0, 1 << 32, n).astype(np.uint64))


def test_grev64_and_derive_tw():
    x = full_range_u64(np.random.default_rng(1), 4096)
    x[:4] = [0, 0xFFFFFFFFFFFFFFFF, 1 << 63, 0x0123456789ABCDEF]
    assert np.array_equal(u64(TP.grev64(t64(x))),
                          np.asarray(JP.grev64(jnp.asarray(x))))
    assert np.array_equal(u64(TP.derive_tw(t64(x))),
                          np.asarray(JP.derive_tw(jnp.asarray(x))))


@pytest.mark.parametrize("C", [64, 1000, 4096])
def test_expand_bits(C):
    words = full_range_u64(np.random.default_rng(C), (C + 63) // 64)
    got = TP.expand_bits(t64(words), C).numpy()
    want = np.asarray(JP.expand_bits(jnp.asarray(words), C))
    assert got.dtype == np.bool_ and np.array_equal(got, want)


def _stream(k, C, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, C + 64).astype(np.uint8)
    return JP.pack_sw(codes, C // 32 + 2)


@pytest.mark.parametrize("k", KS)
def test_extract_kmers_and_canonical_hashes(k):
    C = 1 << 12
    sh = Seqhash.create(k, 31, 17)
    sw = _stream(k, C, k)
    jsw = jnp.asarray(sw)
    jh, jr = JP.extract_kmers(jsw, JP.derive_tw(jsw), k, C)
    th, tr = TP.extract_kmers(t64(sw), TP.derive_tw(t64(sw)), k, C)
    assert np.array_equal(u64(th), np.asarray(jh))
    assert np.array_equal(u64(tr), np.asarray(jr))
    jhash, jkm, jisf = JP.canonical_hashes(jh, jr, k, sh.factor1)
    thash, tkm, tisf = TP.canonical_hashes(th, tr, k, sh.factor1)
    assert np.array_equal(u64(thash), np.asarray(jhash))
    assert np.array_equal(u64(tkm), np.asarray(jkm))
    assert np.array_equal(tisf.numpy(), np.asarray(jisf))


@pytest.mark.parametrize("w", WS)
def test_mod_is_zero(w):
    """The inputs of test_mod_is_zero_lemire_exact: full-range u64 hashes
    plus multiples of w, and their u32 truncations."""
    rng = np.random.default_rng(9)
    h64 = rng.integers(0, 1 << 63, 4096, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, 4096, dtype=np.uint64)
    mult = rng.integers(0, 1 << 32, 256, dtype=np.uint64)
    hs = np.concatenate([h64, mult * np.uint64(w)])
    got = TP.mod_is_zero(t64(hs), w).numpy()
    assert np.array_equal(got, np.asarray(JP.mod_is_zero(jnp.asarray(hs), w)))
    assert np.array_equal(got, hs % np.uint64(w) == 0)
    h32 = hs.astype(np.uint32)
    got32 = TP.mod_is_zero(t64(h32.astype(np.uint64)), w).numpy()
    assert np.array_equal(got32,
                          np.asarray(JP.mod_is_zero(jnp.asarray(h32), w)))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("seed", [17, 3])
def test_kernel_params_against_seqhash(k, seed):
    sh = Seqhash.create(k, 31, seed)
    kp = kernel_params(sh)
    assert (kp.k, kp.w, kp.factor1) == (k, 31, sh.factor1)
    assert (kp.shift, kp.mask) == (sh.shift1, sh.mask)
    assert kp.factor1_i64 == TP.as_i64(sh.factor1)
    assert np.int64(kp.factor1_i64).view(np.uint64) == np.uint64(sh.factor1)
    kmers = (full_range_u64(np.random.default_rng(k), 2048)
             & np.uint64(kp.mask))
    got = TP.lsr(t64(kmers) * kp.factor1_i64, kp.shift)
    assert np.array_equal(u64(got), sh.hash_kmers(kmers))


def test_ule_and_lsr_full_range():
    x = full_range_u64(np.random.default_rng(4), 2048)
    for s in (0, 1, 17, 32, 63):
        assert np.array_equal(u64(TP.lsr(t64(x), s)), x >> np.uint64(s))
    for c in (0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, 0x9E3779B97F4A7C15):
        assert np.array_equal(TP.ule(t64(x), c).numpy(), x <= np.uint64(c))
