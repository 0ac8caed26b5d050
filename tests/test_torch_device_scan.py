"""Per-chunk programs of the port (densify_ref, scan_kmers_body, scan_chunk)
vs the JAX package's _densify_cols_search, _scan_chunk_kmers and
_scan_chunk, bit for bit, overflow (total == -1) included."""

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

import jax.numpy as jnp  # noqa: E402

from modimizer_tpu.core.seqhash import Seqhash  # noqa: E402
from modimizer_tpu.native import lib as native_lib  # noqa: E402
from modimizer_tpu.ops.device_scan import (_densify_cols_search,  # noqa: E402
                                           _scan_chunk, _scan_chunk_kmers)
from modimizer_tpu.ops.packed import pack_sw  # noqa: E402
from modimizer_tpu.ops.seqhash import BLK_COMPACT, scan_bo  # noqa: E402
from modimizer_tpu_torch.ops.device_scan import (densify,  # noqa: E402
                                                 densify_ref,
                                                 prefix_valid_words,
                                                 scan_chunk,
                                                 scan_kmers_body)
from modimizer_tpu_torch.ops.scan_kernel import scan_compact_ref  # noqa: E402

U32_SENT = np.uint32(0xFFFFFFFF)


def t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def widen(kmers):
    """JAX returns u32 k-mers (0xFFFFFFFF sentinel) for k <= 16: as u64
    with the all-ones u64 sentinel the port uses for every k."""
    kmers = np.asarray(kmers)
    if kmers.dtype == np.uint32:
        out = kmers.astype(np.uint64)
        out[kmers == U32_SENT] = np.uint64(0xFFFFFFFFFFFFFFFF)
        return out
    return kmers


def chunk(k, C, seed, poly_a=False, n_reads=None):
    """(codes, sw, validity words) for one chunk of reads of random
    length (read ends make the validity words ragged)."""
    rng = np.random.default_rng(seed)
    n = C + k - 1
    codes = (np.zeros(n, np.uint8) if poly_a
             else rng.integers(0, 4, n).astype(np.uint8))
    lens = rng.integers(30, 700, n // 30 + 2)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    offs = np.append(offs[offs < n], n)
    vw = np.zeros(C // 64, np.uint64)
    native_lib().pk_valid_words(offs, len(offs) - 1, n, k, vw, len(vw))
    return codes, pack_sw(codes, C // 32 + 2), vw


def cap_for(C, w):
    """The scanner's dense-row cap (ops/seqhash.py ModimizerScanner)."""
    bo = scan_bo(w)
    return int(min((C // BLK_COMPACT) * bo,
                   max(4096, C // w + max(C // (8 * w), 65536))))


@pytest.mark.parametrize("with_meta", [False, True])
@pytest.mark.parametrize("cap", [300, 4096])
def test_densify_ref_equals_jax_search(with_meta, cap):
    k, w, C = 16, 10, 1 << 14
    sh = Seqhash.create(k, w, 17)
    _codes, sw, vw = chunk(k, C, 5)
    bo = scan_bo(w)
    out_k, out_meta, cnt, n_emit, _ovf = scan_compact_ref(
        t64(sw), t64(vw), k=k, w=w, factor1=sh.factor1, C=C, bo=bo,
        meta_isf=True)
    assert int(n_emit) > 300       # cap=300 cuts the dense prefix
    meta = out_meta if with_meta else None
    dk, dm = densify_ref(out_k, meta, cnt, bo=bo, cap=cap)
    jk = jnp.asarray(out_k.numpy().view(np.uint64))
    jm = jnp.asarray(out_meta.numpy().view(np.uint32))
    want = _densify_cols_search((jk, jm), jm != U32_SENT, bo, cap,
                                (jnp.uint64(0xFFFFFFFFFFFFFFFF), U32_SENT))
    assert np.array_equal(dk.numpy().view(np.uint64), np.asarray(want[0]))
    if with_meta:
        assert np.array_equal(dm.numpy().view(np.uint32), np.asarray(want[1]))
    else:
        assert dm is None
    # on CPU tensors the wrapper is the plain version
    gk, gm = densify(out_k, meta, cnt, bo=bo, cap=cap)
    assert torch.equal(gk, dk) and (gm is None or torch.equal(gm, dm))


@pytest.mark.parametrize("k,w", [(16, 16), (19, 31), (11, 10)])
def test_scan_kmers_body_equals_jax(k, w):
    C = 1 << 14
    sh = Seqhash.create(k, w, 17)
    bo, cap = scan_bo(w), cap_for(C, w)
    for seed, poly_a, cap_ in ((k, False, cap), (k + 1, True, cap),
                               (k + 2, False, 128)):
        _codes, sw, vw = chunk(k, C, seed, poly_a)
        dk, tot = scan_kmers_body(t64(sw), t64(vw), k=k, w=w,
                                  factor1=sh.factor1, bo=bo, cap=cap_)
        jk, jtot = _scan_chunk_kmers(jnp.asarray(sw), jnp.asarray(vw), k=k,
                                     w=w, factor1=sh.factor1, bo=bo,
                                     cap=cap_)
        assert int(tot) == int(jtot), (seed, poly_a, cap_)
        assert np.array_equal(dk.numpy().view(np.uint64), widen(jk))
        if poly_a or cap_ == 128:
            assert int(tot) == -1
        else:
            assert int(tot) > 0


@pytest.mark.parametrize("k,w", [(16, 16), (19, 31)])
@pytest.mark.parametrize("m_cut", [0, 777])
def test_scan_chunk_equals_jax(k, w, m_cut):
    C = 1 << 14
    m = C - m_cut
    sh = Seqhash.create(k, w, 17)
    bo, cap = scan_bo(w), cap_for(C, w)
    for poly_a in (False, True):
        codes, _sw, _vw = chunk(k, C, k + m_cut, poly_a)
        sw = pack_sw(codes, C // 32 + 2)
        dk, dm, tot = scan_chunk(t64(sw), m, k=k, w=w, factor1=sh.factor1,
                                 bo=bo, cap=cap)
        jk, jm, jtot = _scan_chunk(jnp.asarray(sw), jnp.int32(m), k=k, w=w,
                                   factor1=sh.factor1, bo=bo, cap=cap)
        assert int(tot) == int(jtot)
        assert np.array_equal(dk.numpy().view(np.uint64), widen(jk))
        assert np.array_equal(dm.numpy().view(np.uint32), np.asarray(jm))
        assert (int(tot) == -1) == poly_a


@pytest.mark.parametrize("m", [0, 1, 63, 64, 65, 1000, 4096])
def test_prefix_valid_words(m):
    C = 4096
    bits = np.unpackbits(
        prefix_valid_words(m, C, torch.device("cpu")).numpy().view(np.uint8),
        bitorder="little").astype(bool)
    assert np.array_equal(bits, np.arange(C) < m)
