"""front_ops_ref (the plain PyTorch version of csrc/front_ops.cu) vs the
bodies of the JAX package's ``scripts/probe_front.py``, each called as the
Pallas grid leaves its output: at r = 15, on the script's own input.  The
CUDA kernel itself is held against front_ops_ref on the card by
chip_smoke.py."""

import importlib.util
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

import jax.numpy as jnp  # noqa: E402

from modimizer_tpu_torch.ops.front_ops import (OPS, R_LAST,  # noqa: E402
                                               front_ops, front_ops_ref)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def probe():
    """scripts/probe_front.py (it reads op names from sys.argv only under
    __main__, but is imported under a clean argv all the same)."""
    spec = importlib.util.spec_from_file_location(
        "_script_probe_front", REPO / "scripts" / "probe_front.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(sys, "argv", ["probe"]):
        spec.loader.exec_module(mod)
    return mod


def as_torch(u32):
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32))


@pytest.mark.parametrize("op", OPS)
def test_ref_equal_probe_body(probe, op):
    """On the script's [8, 128, 1024] input, tile by tile."""
    x = probe.w0h
    got = front_ops_ref(as_torch(x), op).numpy().view(np.uint32)
    body = probe.PROBES[op]
    for t in range(x.shape[0]):
        want = np.asarray(body(jnp.asarray(x[t]), jnp.int32(R_LAST)))
        assert np.array_equal(got[t], want), (op, t)


@pytest.mark.parametrize("r", range(R_LAST + 1))
def test_dyn_ref_equal_dynf_at_every_r(probe, r):
    """dyn at each pass of the grid, r = 0 (dynf's guard) included."""
    x = probe.w0h[0, :16]
    got = front_ops_ref(as_torch(x[None]), "dyn", r).numpy().view(np.uint32)
    want = np.asarray(probe.dynf(jnp.asarray(x), jnp.int32(r)))
    assert np.array_equal(got[0], want)


@pytest.mark.parametrize("r", range(R_LAST + 1))
@pytest.mark.parametrize("op", [op for op in OPS if op != "dyn"])
def test_ref_equal_probe_body_at_every_r(probe, op, r):
    """Every other body at each pass of the grid, on the script's first
    tile: the kernel builds one instance per last pass (r = 0 .. 15)."""
    x = probe.w0h[0]
    got = front_ops_ref(as_torch(x[None]), op, r).numpy().view(np.uint32)
    want = np.asarray(probe.PROBES[op](jnp.asarray(x), jnp.int32(r)))
    assert np.array_equal(got[0], want), (op, r)


def test_dyn_is_a_rotate_by_30():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2 ** 32, (2, 8, 64), dtype=np.uint64).astype(
        np.uint32)
    got = front_ops_ref(as_torch(x), "dyn").numpy().view(np.uint32)
    assert np.array_equal(got, (x << np.uint32(30)) | (x >> np.uint32(2)))


def test_iota_on_another_shape():
    """iota adds 16 (col * L + row) per tile for any [T, L, R]."""
    T, L, R = 3, 64, 256
    x = np.random.default_rng(2).integers(0, 2 ** 32, (T, L, R),
                                          dtype=np.uint64).astype(np.uint32)
    got = front_ops_ref(as_torch(x), "iota").numpy().view(np.uint32)
    row = np.arange(L, dtype=np.uint32)[:, None]
    col = np.arange(R, dtype=np.uint32)[None, :]
    assert np.array_equal(got, x + np.uint32(16) * (col * np.uint32(L) + row))


@pytest.mark.parametrize("op", OPS)
def test_wrapper_on_cpu_is_the_plain_version(op):
    x = as_torch(np.random.default_rng(4).integers(
        0, 2 ** 32, (2, 16, 32), dtype=np.uint64).astype(np.uint32))
    assert torch.equal(front_ops(x, op), front_ops_ref(x, op))


@pytest.mark.parametrize("x,op", [
    (torch.zeros((2, 4, 8), dtype=torch.int32), "rot"),
    (torch.zeros((2, 4, 6), dtype=torch.int32), "copy"),
    (torch.zeros((2, 4, 8), dtype=torch.int64), "copy"),
    (torch.zeros((4, 8), dtype=torch.int32), "copy")])
def test_contract_refused(x, op):
    with pytest.raises(ValueError):
        front_ops(x, op)


@pytest.mark.parametrize("r", [-1, R_LAST + 1])
def test_pass_out_of_the_grid_refused(r):
    with pytest.raises(ValueError):
        front_ops(torch.zeros((2, 4, 8), dtype=torch.int32), "dyn", r)
