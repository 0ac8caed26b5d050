"""The port's sorted-table lookup (modimizer_tpu_torch/parallel/lookup.py)
on the CPU: ``DeviceTable`` on ``device="cpu"`` and ``find_sorted_ref``
against the JAX ``DeviceTable(build_mesh(1))``, its ``_find_sorted_local``
and the native open-addressed ``find_batch``, on tests/test_lookup.py's
table with present, absent and all-ones queries, an empty query and an
empty table.  Exact: the u32 ids."""

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

import jax.numpy as jnp  # noqa: E402

from modimizer_tpu.core.modset import Modset as JaxModset  # noqa: E402
from modimizer_tpu.core.seqhash import Seqhash as JaxSeqhash  # noqa: E402
from modimizer_tpu.parallel.lookup import (  # noqa: E402
    DeviceTable as JaxDeviceTable, _find_sorted_local)
from modimizer_tpu.parallel.sharded import build_mesh  # noqa: E402
from modimizer_tpu_torch import _build  # noqa: E402
from modimizer_tpu_torch.core.modset import Modset  # noqa: E402
from modimizer_tpu_torch.core.seqhash import Seqhash  # noqa: E402
from modimizer_tpu_torch.parallel.lookup import (  # noqa: E402
    DeviceTable, find_sorted, find_sorted_ref)

ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(scope="module")
def table():
    """tests/test_lookup.py's table: 60,000 random 32-bit k-mers, shuffled,
    in a 2^20 native table (the JAX package's and the port's)."""
    rng = np.random.default_rng(9)
    kmers = np.unique(rng.integers(0, 1 << 32, 60000, dtype=np.uint64))
    rng.shuffle(kmers)
    jms = JaxModset(JaxSeqhash.create(16, 16, 17), 20)
    jms.add_batch(kmers)
    ms = Modset(Seqhash.create(16, 16, 17), 20)
    ms.add_batch(kmers)
    assert np.array_equal(ms.value, jms.value)
    return jms, ms, kmers


def queries(kmers, seed=10):
    rng = np.random.default_rng(seed)
    present = rng.choice(kmers, 5000)
    absent = rng.integers(1 << 33, 1 << 40, 5000).astype(np.uint64)
    q = np.concatenate([present, absent, np.array([ALL_ONES, 0], np.uint64),
                        kmers.min(keepdims=True), kmers.max(keepdims=True),
                        kmers.max(keepdims=True) + np.uint64(1)])
    rng.shuffle(q)
    return q


def tables(jms, ms):
    ids = np.arange(1, ms.max + 1, dtype=np.uint32)
    port = DeviceTable(ms.value[1:ms.max + 1], ids, ms.hasher, device="cpu")
    jax_t = JaxDeviceTable(jms.value[1:jms.max + 1], ids, jms.hasher,
                           build_mesh(1))
    return port, jax_t


def test_device_table_matches_jax_and_native(table):
    jms, ms, kmers = table
    port, jax_t = tables(jms, ms)
    assert port.keys.dtype == torch.int64 and port.keys.numel() == ms.max
    assert bool((port.keys[1:] > port.keys[:-1]).all())
    q = queries(kmers)
    got = port.find(q)
    assert got.dtype == np.uint32
    assert np.array_equal(got, jax_t.find(q))
    assert np.array_equal(got, ms.find_batch(q))
    assert np.array_equal(got, jms.find_batch(q))
    assert got[q == ALL_ONES].tolist() == [0]
    assert (got[np.isin(q, kmers)] > 0).all()


def test_find_sorted_ref_matches_find_sorted_local(table):
    """The plain version on the live rows against the JAX program on the
    same rows with its all-ones pad row."""
    jms, ms, kmers = table
    port, jax_t = tables(jms, ms)
    q = queries(kmers, seed=11)
    got = find_sorted_ref(port.keys, port.vals,
                          torch.from_numpy(q.view(np.int64)))
    want = _find_sorted_local(jax_t.keys, jax_t.vals, jnp.asarray(q),
                              factor1=jms.hasher.factor1,
                              shift1=jms.hasher.shift1, w=jms.hasher.w)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = dict(_build.LAUNCHES)
    assert torch.equal(find_sorted(port.keys, port.vals,
                                   torch.from_numpy(q.view(np.int64))), got)
    assert _build.LAUNCHES == before


def test_empty_query(table):
    jms, ms, _ = table
    port, jax_t = tables(jms, ms)
    got = port.find(np.zeros(0, np.uint64))
    assert got.dtype == np.uint32 and len(got) == 0
    assert len(jax_t.find(np.zeros(0, np.uint64))) == 0


def test_empty_table(table):
    _, ms, kmers = table
    empty = np.zeros(0, np.uint64)
    port = DeviceTable(empty, np.zeros(0, np.uint32), ms.hasher,
                       device="cpu")
    jax_t = JaxDeviceTable(empty, np.zeros(0, np.uint32), ms.hasher,
                           build_mesh(1))
    q = queries(kmers)
    got = port.find(q)
    assert not got.any()
    assert np.array_equal(got, jax_t.find(q))


def test_unsorted_keys_with_the_sign_bit():
    """Keys at and above 2^63 (negative in int64) are found like the rest:
    the column is sorted and searched in one int64 order."""
    sh = Seqhash.create(16, 16, 17)
    keys = np.array([5, 1 << 63, 3, ALL_ONES - np.uint64(1), 1 << 40],
                    np.uint64)
    vals = np.array([10, 20, 30, 40, 50], np.uint32)
    port = DeviceTable(keys, vals, sh, device=torch.device("cpu"))
    q = np.concatenate([keys, np.array([ALL_ONES, 4, 0], np.uint64)])
    assert port.find(q).tolist() == [10, 20, 30, 40, 50, 0, 0, 0]


def test_more_than_one_device_raises(table):
    _, ms, _ = table
    with pytest.raises(NotImplementedError, match="DeviceTable: 2 devices"):
        DeviceTable(ms.value[1:ms.max + 1],
                    np.arange(1, ms.max + 1, dtype=np.uint32), ms.hasher,
                    device=["cpu", "cpu"])


def test_no_device_without_cuda_raises(table):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    _, ms, _ = table
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceTable(ms.value[1:ms.max + 1],
                    np.arange(1, ms.max + 1, dtype=np.uint32), ms.hasher)
