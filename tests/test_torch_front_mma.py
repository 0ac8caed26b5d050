"""front_mma_ref (the plain PyTorch version of csrc/front_mma.cu) vs the JAX
package: limb_weights against ``make_W``, the carry chain against
``carries``, the planes bit for bit against ``kern_mxu`` run in interpret
mode with the script's own BlockSpecs, and against ``_scan_front_u32``.

The kernel's fragment map is rehearsed here: ``mma.sync.m16n8k16``
emulated by the PTX fragment layouts (A, B and D spread over the 32 lanes),
fed by the kernel's loads, shuffles and B registers (``b_fragments``), its
partials read by ``d_slot`` into the carry chain, its km stores and its
ballot-packed em words, all as the kernel indexes them; the planes must
equal front_mma_ref's and kern_mxu's bit for bit.  The CUDA kernel itself
is held against front_mma_ref on the card by chip_smoke.py."""

import functools
import importlib.util
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from modimizer_tpu.core.seqhash import Seqhash  # noqa: E402
from modimizer_tpu.ops.packed import mod_is_zero, pack_sw  # noqa: E402
from modimizer_tpu.parallel.sharded import _scan_front_u32  # noqa: E402
from modimizer_tpu_torch.ops.front_kernel import (  # noqa: E402
    front_planes_ref, make_streams)
from modimizer_tpu_torch.ops.front_mma import (  # noqa: E402
    TILES, b_fragments, carries, d_slot, front_mma, front_mma_ref,
    limb_weights, tile_weights)

REPO = Path(__file__).resolve().parent.parent
C_LOG2, MJ = 14, 256
C = 1 << C_LOG2
NJ = C // 16
K = 16


@pytest.fixture(scope="module")
def mxu():
    """scripts/probe_front_mxu.py, imported under the argv it reads."""
    spec = importlib.util.spec_from_file_location(
        "_script_probe_front_mxu", REPO / "scripts" / "probe_front_mxu.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(sys, "argv", ["probe", str(C_LOG2), str(MJ)]):
        spec.loader.exec_module(mod)
    return mod


def seeded_sw(seed):
    rng = np.random.default_rng(seed)
    return pack_sw(rng.integers(0, 4, C + K - 1).astype(np.uint8),
                   C // 32 + 2)


def torch_streams(sw):
    return make_streams(torch.from_numpy(sw.view(np.int64)), NJ)


def pos_order(plane):
    return np.asarray(plane).T.reshape(-1)


@pytest.mark.parametrize("k,w,seed", [(16, 16, 17), (16, 2, 17),
                                      (19, 31, 17), (16, 16, 1),
                                      (21, 64, 12345)])
def test_limb_weights_equal_make_W(mxu, k, w, seed):
    f1 = Seqhash.create(k, w, seed).factor1
    want = mxu.make_W(f1)
    got = limb_weights(f1)
    assert got.dtype == torch.int32 and got.shape == (24, 8)
    assert np.array_equal(got.numpy().astype(np.float32), want)


def test_carries_equal_script(mxu):
    """The carry chain on random partials in the range the limb product
    gives (each at most 4 x 255^2)."""
    rng = np.random.default_rng(3)
    p = rng.integers(0, 4 * 255 * 255 + 1, (11, 4096)).astype(np.uint32)
    want = np.asarray(mxu.carries([jnp.asarray(r) for r in p]))
    got = carries([torch.from_numpy(r.astype(np.int64)) for r in p])
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def kern_mxu_planes(mxu, sw, factor1, w):
    """(km u32, em i8) in position order from kern_mxu in interpret mode
    with the script's BlockSpecs."""
    P, Z = mxu.make_streams(jnp.asarray(sw))
    pa, pb, za, zb = (x.reshape(1, NJ)
                      for x in (P[:NJ], P[1:NJ + 1], Z[:NJ], Z[1:NJ + 1]))
    row = pl.BlockSpec((1, MJ), lambda s, g: (g * 0, g),
                       memory_space=pltpu.VMEM)
    out = pl.BlockSpec((1, MJ), lambda s, g: (s, g), memory_space=pltpu.VMEM)
    km_w, em_w = pl.pallas_call(
        functools.partial(mxu.kern_mxu, w=w), grid=(16, NJ // MJ),
        in_specs=[row] * 4 + [pl.BlockSpec((24, 8), lambda s, g: (0, 0),
                                           memory_space=pltpu.VMEM)],
        out_specs=(out, out),
        out_shape=(jax.ShapeDtypeStruct((16, NJ), jnp.uint32),
                   jax.ShapeDtypeStruct((16, NJ), jnp.int8)),
        interpret=True)(pa, pb, za, zb,
                        jnp.asarray(mxu.make_W(factor1), jnp.bfloat16))
    return pos_order(km_w), pos_order(em_w)


@pytest.mark.parametrize("w", [16, 64])
def test_ref_equal_kern_mxu(mxu, w):
    sh = Seqhash.create(K, w, 17)
    sw = seeded_sw(w)
    km_w, em_w = kern_mxu_planes(mxu, sw, sh.factor1, w)
    km, em = front_mma_ref(*torch_streams(sw), factor1=sh.factor1, w=w)
    assert np.array_equal(km.numpy().view(np.uint32), km_w)
    assert np.array_equal(em.numpy(), em_w)


# ------------------------------------------- the kernel's fragment map

M32 = 0xFFFFFFFF
R = 2                   # csrc/front_mma.cu: words a lane a stream a step
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4


def a_matrix(a0, a1):
    """A [16, 16] limbs from the lanes' registers (u32 in int64, [32] each):
    a0 row g, a1 row g + 8, at columns 4t .. 4t + 3; byte i of a register
    is column + i."""
    A = np.zeros((16, 16), np.int64)
    for i in range(4):
        A[G, 4 * T + i] = (a0 >> (8 * i)) & 0xFF
        A[G + 8, 4 * T + i] = (a1 >> (8 * i)) & 0xFF
    return A


def b_matrix(b0):
    """B [16, 8] from the lanes' b0 [32]: column g at rows 4t .. 4t + 3."""
    B = np.zeros((16, 8), np.int64)
    for i in range(4):
        B[4 * T + i, G] = (b0 >> (8 * i)) & 0xFF
    return B


def mma(a0, a1, b0):
    """mma.sync.m16n8k16 u8 x u8 -> s32, C = 0: D [32, 4] by lane, rows g
    (d0, d1) and g + 8 (d2, d3) at columns 2t, 2t + 1."""
    D = a_matrix(a0, a1) @ b_matrix(b0)
    return np.stack([D[G, 2 * T], D[G, 2 * T + 1], D[G + 8, 2 * T],
                     D[G + 8, 2 * T + 1]], axis=1)


def funnel_l(lo, hi, s):
    return ((hi << s) & M32) | (lo >> (32 - s))


def funnel_r(lo, hi, s):
    return (lo >> s) | ((hi << (32 - s)) & M32)


def spread4(x):
    return ((x & 1) | ((x << 4) & 0x100) | ((x << 8) & 0x10000)
            | ((x << 12) & 0x1000000))


def emulate_kernel(streams, factor1, w):
    """The kernel's planes (km u32, em u8) and its largest partial, each
    warp iteration (base, 32 R words) as the kernel walks it."""
    pa, pb, za, zb = (x.numpy().astype(np.int64) & M32 for x in streams)
    NJ = len(pa)
    assert NJ % (32 * R) == 0
    bw = b_fragments(factor1).numpy()
    km = np.full(16 * NJ, -1, np.int64)
    em32 = np.full(4 * NJ, -1, np.int64)
    eh, et, eq = LANE >> 4, (LANE >> 2) & 3, LANE & 3
    eshift = 16 * (eq & 1) + et
    top = 0
    for base in range(0, NJ, 32 * R):
        # register r of lane L holds word base + 32 r + L of each stream
        cur = [[x[base + 32 * r + LANE] for r in range(R)]
               for x in (pa, pb, za, zb)]
        for r in range(R):
            for q2 in range(4):
                lo, hi = [], []
                for h in range(2):
                    src = 4 * (2 * q2 + h) + T
                    a, b, c, d = (cur[s][r][src] for s in range(4))
                    kf = (funnel_l(b, a, 2 * G), funnel_l(b, a, 2 * G + 16))
                    kr = (funnel_r(c, d, 2 * G), funnel_r(c, d, 2 * G + 16))
                    hs = []
                    for k2 in (kf, kr):         # one strand's six tiles
                        D = [mma(*k2, bw[:, i]) for i in range(TILES)]
                        top = max(top, max(int(x.max()) for x in D))
                        hs.append([carries([D[tl][:, reg] for tl, reg in
                                            (d_slot(p, half)
                                             for p in range(11))])
                                   for half in (0, 1)])
                    word = base + 32 * r + src
                    es = []
                    for half in (0, 1):
                        hf, hr = hs[0][half], hs[1][half]
                        isF = hf < hr
                        km[16 * word + G + 8 * half] = np.where(
                            isF, kf[half], kr[half])
                        es.append((np.where(isF, hf, hr) & (w - 1)) == 0)
                    lo.append(int((es[0].astype(np.int64) << LANE).sum()))
                    hi.append(int((es[1].astype(np.int64) << LANE).sum()))
                bits = np.where(eq < 2, np.where(eh, lo[1], lo[0]),
                                np.where(eh, hi[1], hi[0]))
                em32[4 * (base + 32 * r + 8 * q2) + LANE] = spread4(
                    bits >> eshift)
    assert (km >= 0).all() and (em32 >= 0).all(), "a position not stored"
    return (km.astype(np.uint32),
            em32.astype(np.uint32).astype("<u4").view(np.uint8), top)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("w", [2, 16, 64])
def test_fragment_map_equal_ref_and_kern_mxu(mxu, w, seed):
    """The kernel's fragment map, emulated lane by lane, gives front_mma_ref's
    planes and kern_mxu's (interpret mode) bit for bit."""
    f1 = Seqhash.create(K, w, seed).factor1
    sw = seeded_sw(1000 * seed + w)
    st = torch_streams(sw)
    km, em, top = emulate_kernel(st, f1, w)
    assert top < 1 << 18
    km_r, em_r = front_mma_ref(*st, factor1=f1, w=w)
    assert np.array_equal(km, km_r.numpy().view(np.uint32))
    assert np.array_equal(em, em_r.numpy().view(np.uint8))
    km_w, em_w = kern_mxu_planes(mxu, sw, f1, w)
    assert np.array_equal(km, km_w)
    assert np.array_equal(em, em_w.astype(np.uint8))


@pytest.mark.parametrize("k,w,seed", [(16, 16, 17), (16, 2, 1),
                                      (21, 64, 12345)])
def test_tile_weights_block_structure(k, w, seed):
    """B is block-diagonal over the 4 limb quads, W1[p] in its word's quad,
    column p = 11 zero, and the lanes' B registers (b_fragments, placed by
    the PTX B layout) are exactly its tiles."""
    f1 = Seqhash.create(k, w, seed).factor1
    B = tile_weights(f1).numpy().astype(np.int64)
    W1 = limb_weights(f1).numpy()[:11, :4]
    assert B.shape == (16, 8 * TILES)
    for i in range(TILES):
        for c in range(8):
            col = B[:, 8 * i + c]
            p, r0 = 2 * i + c % 2, 4 * (c // 2)
            rest = np.delete(col, range(r0, r0 + 4))
            assert not rest.any()
            want = W1[p] if p < 11 else np.zeros(4, np.int64)
            assert np.array_equal(col[r0:r0 + 4], want)
    bw = b_fragments(f1).numpy()
    for i in range(TILES):
        assert np.array_equal(b_matrix(bw[:, i]), B[:, 8 * i:8 * i + 8])


@pytest.mark.parametrize("w", [2, 16, 64])
def test_ref_equal_full_front_and_scan_front_u32(w):
    sh = Seqhash.create(K, w, 17)
    sw = seeded_sw(100 + w)
    st = torch_streams(sw)
    km, em = front_mma_ref(*st, factor1=sh.factor1, w=w)
    km_f, em_f = front_planes_ref(*st, factor1=sh.factor1, w=w,
                                  variant="full", mj=MJ)
    assert torch.equal(km, km_f) and torch.equal(em, em_f)
    hashes, kmers, _pos, _isF = _scan_front_u32(jnp.asarray(sw), k=K,
                                                factor1=sh.factor1, C=C)
    assert np.array_equal(km.numpy().view(np.uint32), pos_order(kmers))
    assert np.array_equal(em.numpy().astype(bool),
                          pos_order(mod_is_zero(hashes, w)))


def test_wrapper_on_cpu_is_the_plain_version():
    sh = Seqhash.create(K, 16, 17)
    st = torch_streams(seeded_sw(5))
    got = front_mma(*st, factor1=sh.factor1, w=16)
    want = front_mma_ref(*st, factor1=sh.factor1, w=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("bad", [dict(k=17), dict(w=48)])
def test_contract_refused(bad):
    st = torch_streams(seeded_sw(6))
    args = dict(factor1=Seqhash.create(K, 16, 17).factor1, w=16)
    args.update(bad)
    with pytest.raises(ValueError):
        front_mma(*st, **args)
