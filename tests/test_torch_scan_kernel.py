"""scan_compact_ref (the plain PyTorch version of csrc/scan_compact.cu) vs
the JAX package: bit for bit against _scan_compact_core(posmajor=True), the
XLA program of the JAX main path, and as a row multiset against both Pallas
kernels in interpret mode.  The CUDA kernel itself is held against
scan_compact_ref on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

import jax.numpy as jnp  # noqa: E402

from modimizer_tpu.core.seqhash import Seqhash  # noqa: E402
from modimizer_tpu.ops import scan_kernel as SK  # noqa: E402
from modimizer_tpu.ops import scan_kernel_mxu as SKM  # noqa: E402
from modimizer_tpu.ops.packed import pack_bits, pack_sw  # noqa: E402
from modimizer_tpu.ops.seqhash import BLK_COMPACT, scan_bo  # noqa: E402
from modimizer_tpu.parallel.sharded import (_expand_valid,  # noqa: E402
                                            _scan_compact_core)
from modimizer_tpu_torch.ops.packed import mod_is_zero  # noqa: E402
from modimizer_tpu_torch.ops.scan_kernel import (_divisible,  # noqa: E402
                                                 kernel_params, scan_compact,
                                                 scan_compact_ref)

KW = [(16, 16), (11, 10), (13, 31), (19, 31), (24, 16), (31, 31)]


def t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def jax_core(sw, vb, *, k, w, factor1, C, bo, meta_isf):
    out = _scan_compact_core(
        jnp.asarray(sw), _expand_valid(jnp.asarray(vb), C), k=k, w=w,
        factor1=factor1, C=C, bo=bo, meta_isf=meta_isf, posmajor=True,
        vbits=jnp.asarray(vb))
    return tuple(np.asarray(x) for x in out)


def assert_same_as_jax(got, want, bo):
    out_k, out_meta, cnt, n_emit, overflow = got
    assert np.array_equal(out_k.numpy().view(np.uint64), want[0])
    assert np.array_equal(out_meta.numpy().view(np.uint32), want[1])
    assert int(n_emit) == int(want[2])
    assert bool(overflow) == bool(want[3])
    assert int(cnt.sum()) == int(want[2])
    assert bool((cnt > bo).any()) == bool(want[3])


@pytest.mark.parametrize("C", [1 << 14, 1 << 15])
@pytest.mark.parametrize("k,w", KW)
def test_ref_bit_identical_to_jax_core(k, w, C):
    sh = Seqhash.create(k, w, 17)
    rng = np.random.default_rng(k * 1000 + w + C)
    codes = rng.integers(0, 4, C + k - 1).astype(np.uint8)
    sw = pack_sw(codes, C // 32 + 2)
    vb = pack_bits(rng.random(C) < 0.95, C // 64)   # ragged validity
    bo = scan_bo(w)
    kp = kernel_params(sh)
    for meta_isf in (False, True):
        args = dict(k=k, w=w, factor1=kp.factor1, C=C, bo=bo,
                    meta_isf=meta_isf)
        got = scan_compact_ref(t64(sw), t64(vb), **args)
        assert_same_as_jax(got, jax_core(sw, vb, **args), bo)


def test_ref_poly_a_overflows_like_jax():
    """k-mer 0 hashes to 0: an all-A chunk emits at every position and
    overflows every block's bo."""
    k, w, C = 16, 16, 1 << 14
    sh = Seqhash.create(k, w, 17)
    sw = pack_sw(np.zeros(C + k - 1, np.uint8), C // 32 + 2)
    vb = pack_bits(np.ones(C, bool), C // 64)
    bo = scan_bo(w)
    args = dict(k=k, w=w, factor1=sh.factor1, C=C, bo=bo, meta_isf=True)
    got = scan_compact_ref(t64(sw), t64(vb), **args)
    assert_same_as_jax(got, jax_core(sw, vb, **args), bo)
    assert bool(got[4]) and int(got[3]) == C
    assert bool((got[2] == BLK_COMPACT).all())


@pytest.mark.parametrize("k,w", KW)
def test_ref_kmers_only_drops_only_the_meta(k, w):
    """with_meta=False (the scanner's modutils -a call) returns no meta and
    the same k-mers, counts, total and overflow flag."""
    C = 1 << 14
    sh = Seqhash.create(k, w, 17)
    rng = np.random.default_rng(k * 7 + w)
    sw = t64(pack_sw(rng.integers(0, 4, C + k - 1).astype(np.uint8),
                     C // 32 + 2))
    vb = t64(pack_bits(rng.random(C) < 0.95, C // 64))
    args = dict(k=k, w=w, factor1=sh.factor1, C=C, bo=scan_bo(w),
                meta_isf=False)
    full = scan_compact_ref(sw, vb, **args)
    for fn in (scan_compact_ref, scan_compact):
        got = fn(sw, vb, with_meta=False, **args)
        assert got[1] is None
        for i in (0, 2, 3, 4):
            assert torch.equal(got[i], full[i]), i


@pytest.mark.parametrize("w", [1, 2, 3, 10, 16, 31, (1 << 31) - 1, 1 << 32,
                               (1 << 32) + 1, 1 << 62, (1 << 63) + 5,
                               (1 << 64) - 1])
def test_ref_emit_test_divides(w):
    """The plain version's emit test (int64 %, canonical hashes below 2^62)
    against the division-free mod_is_zero and Python's %."""
    rng = np.random.default_rng(w % (1 << 32))
    hs = np.concatenate([
        rng.integers(0, 1 << 62, 256, dtype=np.int64),
        np.array([0, 1, (1 << 32) - 1, (1 << 62) - 1], np.int64),
        np.array([w * q for q in range(1, 5) if w * q < 1 << 62], np.int64),
    ])
    got = _divisible(torch.from_numpy(hs), w).numpy()
    assert np.array_equal(got, [int(h) % w == 0 for h in hs])
    assert np.array_equal(got, mod_is_zero(torch.from_numpy(hs), w).numpy())


def _live_rows(out):
    out_k, out_meta = out[0].numpy(), out[1].numpy()
    live = out_meta != -1
    return out_k[live].tolist(), out_meta[live].tolist()


@pytest.mark.parametrize("blk", [128, 4096])
@pytest.mark.parametrize("k,w", [(16, 16), (19, 31)])
def test_ref_blk_partitions_the_same_stream(k, w, blk):
    """Other compaction block sizes (the kernel takes blk up to 2^15):
    with bo = blk nothing overflows, and the live rows in block order are
    the stream-order rows of the JAX core at BLK_COMPACT; the per-block
    counts sum to the coarser blocks' counts."""
    C = 1 << 14
    sh = Seqhash.create(k, w, 17)
    rng = np.random.default_rng(blk + k)
    sw = pack_sw(rng.integers(0, 4, C + k - 1).astype(np.uint8),
                 C // 32 + 2)
    vb = pack_bits(rng.random(C) < 0.9, C // 64)
    args = dict(k=k, w=w, factor1=sh.factor1, C=C, meta_isf=True)
    got = scan_compact_ref(t64(sw), t64(vb), bo=blk, blk=blk, **args)
    want = jax_core(sw, vb, bo=BLK_COMPACT, **args)
    assert not bool(got[4]) and int(got[3]) == int(want[2])
    live = want[1] != 0xFFFFFFFF
    assert _live_rows(got) == (want[0][live].view(np.int64).tolist(),
                               want[1][live].view(np.int32).tolist())
    fine, coarse = sorted([blk, BLK_COMPACT])
    base = scan_compact_ref(t64(sw), t64(vb), bo=BLK_COMPACT, **args)[2]
    cnts = {blk: got[2], BLK_COMPACT: base}
    summed = cnts[fine].view(-1, coarse // fine).sum(1, dtype=torch.int32)
    assert torch.equal(summed, cnts[coarse])


def _ref_rows(codes, C, m, k, w, factor1):
    """(gpos, kmer, isF) multiset of scan_compact_ref with no overflow
    possible (bo = BLK) and positions >= m invalid."""
    sw = pack_sw(codes, C // 32 + 2)
    vb = pack_bits(np.arange(C) < m, C // 64)
    out_k, out_meta, _c, n_emit, overflow = scan_compact_ref(
        t64(sw), t64(vb), k=k, w=w, factor1=factor1, C=C, bo=BLK_COMPACT,
        meta_isf=True)
    assert not bool(overflow)
    live = out_meta.numpy() != -1
    meta = out_meta.numpy().view(np.uint32)[live]
    rows = sorted(zip((meta >> 1).astype(np.int64).tolist(),
                      out_k.numpy().view(np.uint64)[live].tolist(),
                      ((meta & 1) == 1).tolist()))
    assert len(rows) == int(n_emit)
    return rows


def _pack32(codes, n_words):
    ext = np.zeros(n_words * 16, np.uint32)
    ext[:len(codes)] = codes[:n_words * 16]
    qq = ext.reshape(-1, 16)
    w = np.zeros(n_words, np.uint32)
    for b in range(16):
        w |= qq[:, b] << np.uint32(30 - 2 * b)
    return w


def _valid16(n_words, m, dtype):
    base = np.arange(n_words, dtype=np.int64) * 16
    v16 = np.zeros(n_words, dtype)
    for r in range(16):
        v16 |= ((base + r) < m).astype(dtype) << dtype(r)
    return v16


@pytest.mark.parametrize("k,w", [(16, 16), (13, 31), (16, 31), (11, 10)])
def test_ref_multiset_equals_pallas_tiles(k, w):
    """The shapes of tests/test_scan_kernel.py::test_kernel_matches_oracle:
    one 2^17-position tile, blkp 64, the last 777 positions invalid."""
    sh = Seqhash.create(k, w, 17)
    rng = np.random.default_rng(42)
    blkp, T = 64, 1
    tile_w = blkp * SK.LANES
    C = 16 * tile_w * T
    codes = rng.integers(0, 4, C + 16).astype(np.uint8)
    w32 = _pack32(codes, (C + 16 + 15) // 16 + 1)
    m = C - 777
    w0, w1, vm = SK.host_layout(w32, _valid16(len(w32), m, np.uint16), T,
                                blkp)
    ok_, om_, _cnt = SK.scan_compact_tiles(
        jnp.asarray(w0), jnp.asarray(w1), jnp.asarray(vm), k=k, w=w,
        factor1=sh.factor1, bo=min(blkp, 112), interpret=True,
        use_pltpu_roll=False)
    ok_, om_ = np.asarray(ok_), np.asarray(om_)
    live = om_ != 0xFFFFFFFF
    t_i, r_i, _s, l_i = np.nonzero(live)
    p = (om_[live] >> 1).astype(np.int64)
    gpos = 16 * (t_i * tile_w + p * SK.LANES + l_i) + r_i
    pallas = sorted(zip(gpos.tolist(), ok_[live].astype(np.uint64).tolist(),
                        ((om_[live] & 1) == 1).tolist()))
    assert _ref_rows(codes, C, m, k, w, sh.factor1) == pallas


@pytest.mark.parametrize("k,w,R", [(16, 16, 256), (13, 31, 256),
                                   (11, 10, 128)])
def test_ref_multiset_equals_pallas_mxu(k, w, R):
    """The shapes of tests/test_scan_kernel_mxu.py::
    test_mxu_kernel_matches_oracle (T = 1, the last 777 positions
    invalid)."""
    sh = Seqhash.create(k, w, 17)
    rng = np.random.default_rng(42)
    nW = 128 * R
    C = 16 * nW
    codes = rng.integers(0, 4, C + 16).astype(np.uint8)
    w32 = _pack32(codes, nW + 1)
    m = C - 777
    ok_, om_, _tot, _ovf = SKM.scan_compact_mxu(
        jnp.asarray(w32), jnp.asarray(_valid16(nW + 1, m, np.uint32)), k=k,
        w=w, factor1=sh.factor1, bo=64, R=R, SUB=32, interpret=True)
    ok_, om_ = np.asarray(ok_), np.asarray(om_)
    live = om_ != 0xFFFFFFFF
    gpos, isf = SKM.host_gpos(om_, R)
    pallas = sorted(zip(gpos[live].tolist(),
                        ok_[live].astype(np.uint64).tolist(),
                        isf[live].tolist()))
    assert _ref_rows(codes, C, m, k, w, sh.factor1) == pallas


def test_wrapper_on_cpu_runs_the_plain_version():
    C, k, w = 1 << 13, 16, 16
    rng = np.random.default_rng(3)
    sw = t64(pack_sw(rng.integers(0, 4, C + k - 1).astype(np.uint8),
                     C // 32 + 2))
    vb = t64(pack_bits(np.ones(C, bool), C // 64))
    args = dict(k=k, w=w, factor1=Seqhash.create(k, w, 17).factor1, C=C,
                bo=scan_bo(w), meta_isf=False)
    for a, b in zip(scan_compact(sw, vb, **args),
                    scan_compact_ref(sw, vb, **args)):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_inputs():
    C, k, w = 1 << 13, 16, 16
    sw = torch.zeros(C // 32 + 2, dtype=torch.int64)
    vb = torch.zeros(C // 64, dtype=torch.int64)
    args = dict(k=k, w=w, factor1=3, C=C, bo=scan_bo(w), meta_isf=False)
    with pytest.raises(ValueError):
        scan_compact(sw.to(torch.int32), vb, **args)
    with pytest.raises(ValueError):
        scan_compact(sw[:-1], vb, **args)
    with pytest.raises(ValueError):
        scan_compact(sw, vb, **dict(args, C=C + 64))
    with pytest.raises(ValueError):
        scan_compact(sw, vb, **dict(args, k=32))
    with pytest.raises(ValueError):
        scan_compact(sw, vb, **dict(args, bo=BLK_COMPACT + 1))
    with pytest.raises(ValueError):
        scan_compact(sw, vb, **dict(args, factor1=1 << 64))
    for blk in (64, 384, 1 << 16):      # a power of two in [128, 2^15]
        with pytest.raises(ValueError):
            scan_compact(sw, vb, **dict(args, blk=blk))
