"""front_mma_ref (the plain PyTorch version of csrc/front_mma.cu) vs the JAX
package: limb_weights against ``make_W``, the carry chain against
``carries``, the planes bit for bit against ``kern_mxu`` run in interpret
mode with the script's own BlockSpecs, and against ``_scan_front_u32``.  The
CUDA kernel itself is held against front_mma_ref on the card by
chip_smoke.py."""

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
    carries, front_mma, front_mma_ref, limb_weights)

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


@pytest.mark.parametrize("w", [16, 64])
def test_ref_equal_kern_mxu(mxu, w):
    sh = Seqhash.create(K, w, 17)
    sw = seeded_sw(w)
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
                        jnp.asarray(mxu.make_W(sh.factor1), jnp.bfloat16))
    km, em = front_mma_ref(*torch_streams(sw), factor1=sh.factor1, w=w)
    assert np.array_equal(km.numpy().view(np.uint32), pos_order(km_w))
    assert np.array_equal(em.numpy(), pos_order(em_w))


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
