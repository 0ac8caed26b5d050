"""The port's sorted-table lookup (modimizer_tpu_torch/parallel/lookup.py)
on the CPU: ``DeviceTable`` on ``device="cpu"`` and ``find_sorted_ref``
against the JAX ``DeviceTable(build_mesh(1))``, its ``_find_sorted_local``
and the native open-addressed ``find_batch``, on tests/test_lookup.py's
table with present, absent and all-ones queries, an empty query and an
empty table; and the kernel's index and search arithmetic (``namespace
lookup_index`` of csrc/lookup.cu) compiled by g++ and replayed against
``search_index`` and ``find_sorted_ref`` at the level boundaries, on
duplicate keys, keys with the sign bit and the all-ones query.  Exact: the
u32 ids."""

import shutil
import subprocess
from pathlib import Path

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
    FAN, TOP, DeviceTable, find_sorted, find_sorted_ref, index_levels,
    search_index)

CSRC = Path(__file__).resolve().parent.parent / "modimizer_tpu_torch" / "csrc"

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
    with pytest.raises(ValueError, match="2 devices in one process"):
        DeviceTable(ms.value[1:ms.max + 1],
                    np.arange(1, ms.max + 1, dtype=np.uint32), ms.hasher,
                    device=["cpu", "cpu"])


def test_device_table_on_a_mesh_without_a_group(table):
    """A Mesh with no group is the one-device table."""
    from modimizer_tpu_torch.parallel.mesh import build_mesh
    jms, ms, kmers = table
    port, jax_t = tables(jms, ms)
    mesh_t = DeviceTable(ms.value[1:ms.max + 1],
                         np.arange(1, ms.max + 1, dtype=np.uint32),
                         ms.hasher, build_mesh("cpu"))
    assert (mesh_t.n, mesh_t.mesh.distributed) == (1, False)
    assert torch.equal(mesh_t.keys, port.keys)
    q = queries(kmers, seed=5)
    assert np.array_equal(mesh_t.find(q), jax_t.find(q))


def test_no_device_without_cuda_raises(table):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    _, ms, _ = table
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceTable(ms.value[1:ms.max + 1],
                    np.arange(1, ms.max + 1, dtype=np.uint32), ms.hasher)


def test_device_table_builds_the_search_index(table):
    """The 60,000-key table has one level above its keys: every 16th key."""
    _, ms, _ = table
    port = DeviceTable(ms.value[1:ms.max + 1],
                       np.arange(1, ms.max + 1, dtype=np.uint32), ms.hasher,
                       device="cpu")
    assert index_levels(port.keys.numel()) == [-(-port.keys.numel() // FAN)]
    assert torch.equal(port.index, port.keys[::FAN])
    # two levels: the first padded to whole 16-key nodes
    keys = torch.arange(FAN * TOP + 17, dtype=torch.int64) * 3
    lens = index_levels(keys.numel())
    index = search_index(keys)
    assert len(lens) == 2 and lens[0] % FAN
    pad = -lens[0] % FAN
    assert torch.equal(index[:lens[0]], keys[::FAN])
    assert not index[lens[0]:lens[0] + pad].any()
    assert torch.equal(index[lens[0] + pad:], keys[::FAN * FAN])


# ---- csrc/lookup.cu's index and search, compiled by g++ ----

_HOST_REPLAY = r"""
// Replays lookup.cu on the host with its lookup_index helpers: builds the
// levels (index[off[k] + t] = keys[t * 16^k]), then searches each query as
// the kernel does: the top level, then every node below it, whose 4 lanes
// of four keys each are counted here one after the other.
#include "lookup.cu"
#include <cstdio>
#include <vector>
using namespace lookup_index;
int main(int argc, char** argv) {
    FILE* f = fopen(argv[1], "rb");
    int64_t n, nq;
    if (fread(&n, 8, 1, f) != 1 || fread(&nq, 8, 1, f) != 1) return 1;
    std::vector<int64_t> keys(n), q(nq);
    std::vector<int32_t> vals(n);
    if ((n && (fread(keys.data(), 8, n, f) != (size_t)n ||
               fread(vals.data(), 4, n, f) != (size_t)n)) ||
        (nq && fread(q.data(), 8, nq, f) != (size_t)nq)) return 1;
    fclose(f);
    const Levels L = levels(n);
    std::vector<int64_t> index(index_len(L));
    for (int k = 1; k <= L.K; ++k) {
        int64_t stride = 1;
        for (int i = 0; i < k; ++i) stride *= FAN;
        for (int64_t t = 0; t < L.len[k]; ++t)
            index[L.off[k] + t] = keys[t * stride];
    }
    const int64_t* top = L.K ? index.data() + L.off[L.K] : keys.data();
    const int64_t m = L.len[L.K];
    if (m > TOP) return 2;
    std::vector<int32_t> out(nq);
    for (int64_t i = 0; i < nq; ++i) {
        const int64_t x = q[i];
        int c = top_count(top, (int)m, x);
        bool hit = c < m && top[c] == x;
        for (int k = L.K - 1; k >= 0; --k) {
            const int64_t* lv = k ? index.data() + L.off[k] : keys.data();
            int u = 0;
            for (int l8 = 0; l8 < 8; ++l8)
                for (int e = 0; e < 2; ++e) {
                    const int64_t b = node_base(c) + 2 * l8 + e;
                    if (c > 0 && b < L.len[k]) {
                        u += lv[b] < x;
                        hit |= lv[b] == x;
                    }
                }
            c = refine(c, u);
        }
        out[i] = answer(vals.data(), n, c, hit);
    }
    f = fopen(argv[2], "wb");
    fwrite(&L.K, 4, 1, f);
    fwrite(index.data(), 8, index.size(), f);
    fwrite(out.data(), 4, nq, f);
    fclose(f);
    return 0;
}
"""


@pytest.fixture(scope="module")
def search_replay(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: lookup.cu's host helpers cannot "
                    "be compiled as host code")
    d = tmp_path_factory.mktemp("lookup_host")
    (d / "replay.cpp").write_text(_HOST_REPLAY)
    exe = d / "replay"
    r = subprocess.run([gxx, "-std=c++17", "-O2", "-Wall",
                        "-Wno-unknown-pragmas", "-x", "c++",
                        "-DMZ_LOOKUP_HOST", "-I", str(CSRC),
                        str(d / "replay.cpp"), "-o", str(exe)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return exe


def search_case(case, table):
    """(keys ascending int64, vals int32, queries int64) for one case."""
    rng = np.random.default_rng(12)
    if case == "seeded":
        _, ms, kmers = table
        keys = np.sort(ms.value[1:ms.max + 1].view(np.int64))
        return keys, rng.permutation(len(keys)).astype(np.int32) + 1, \
            queries(kmers).view(np.int64)
    n = {"n0": 0, "n1": 1, "top": TOP, "top+1": TOP + 1,
         "two_levels": FAN * TOP + 1, "dups": 50_000,
         "sign_bit": 20_000}[case]
    keys = np.sort(rng.integers(-(1 << 62), 1 << 62, n) if case == "sign_bit"
                   else rng.integers(0, 1 << 48, n))
    if case == "dups":
        keys = np.sort(np.repeat(keys[::5], 5)[:n])
    vals = rng.integers(1, 1 << 31, n).astype(np.int32)
    present = keys[rng.integers(0, n, 3000)] if n else keys
    near = np.concatenate([keys[::FAN], keys[::FAN] - 1, keys[::FAN] + 1,
                           keys[:3], keys[-3:] + 1])
    q = np.concatenate([present, near, rng.integers(-(1 << 63), 1 << 62,
                                                    2000),
                        np.array([-1, 0, (1 << 63) - 1, -(1 << 63)])])
    return keys.astype(np.int64), vals, q.astype(np.int64)


SEARCH_CASES = ("seeded", "n0", "n1", "top", "top+1", "two_levels", "dups",
                "sign_bit")


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_find_sorted_search_host(search_replay, tmp_path, table, case):
    """lookup.cu's levels and search, compiled by g++: the index equals
    search_index(keys) and every answer equals find_sorted_ref's, at the
    edges of the top level and of a node, on duplicates (the lower bound's
    value), keys with the sign bit and the all-ones query (-1)."""
    keys, vals, q = search_case(case, table)
    src = tmp_path / "in.bin"
    with open(src, "wb") as f:
        f.write(np.int64(len(keys)).tobytes())
        f.write(np.int64(len(q)).tobytes())
        for a in (keys, vals, q):
            f.write(a.tobytes())
    dst = tmp_path / "out.bin"
    r = subprocess.run([str(search_replay), str(src), str(dst)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.returncode, r.stderr)
    tk, tv, tq = (torch.from_numpy(a) for a in (keys, vals, q))
    index = search_index(tk)
    got = np.fromfile(dst, np.uint8)
    K = int(got[:4].view(np.int32)[0])
    assert K == len(index_levels(len(keys)))
    assert K == {"n0": 0, "n1": 0, "top": 0, "top+1": 1,
                 "two_levels": 2}.get(case, K)
    m = index.numel()
    assert np.array_equal(got[4:4 + 8 * m].view(np.int64), index.numpy())
    want = find_sorted_ref(tk, tv, tq)
    assert np.array_equal(got[4 + 8 * m:].view(np.int32), want.numpy())
    if case == "dups":
        assert (want != 0).any()
    assert int(want[tq == -1].sum()) == 0 or case == "sign_bit"
