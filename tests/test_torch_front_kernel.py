"""front_planes_ref (the plain PyTorch version of csrc/front_planes.cu and
csrc/front_reduce.cu) vs the JAX package's scan-front probes: bit for bit
against each Pallas probe kernel run in interpret mode with the script's own
BlockSpecs, and against the XLA front ``_scan_front_u32`` + ``mod_is_zero``.
front_reduce's schedule (``front_reduce_lanes``: its map of words to
threads, its u32 rows, its folds) is rehearsed against both, with its u32
headroom and two mutated maps; so is front_planes.cu's emonly kernel
(``front_emit_lanes``: a word a thread, its four loads, its 16 bytes packed
into one uint4), on tails, poly-A and poly-T chunks and four independent
streams, with two mutated maps.  The CUDA kernels themselves are held
against front_planes_ref on the card by chip_smoke.py."""

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
from modimizer_tpu_torch.ops import front_kernel  # noqa: E402
from modimizer_tpu_torch.ops.front_kernel import (  # noqa: E402
    EMIT_THREADS, EMIT_WORDS, REDUCE_MAX_NJ, REDUCE_MAX_WORDS,
    REDUCE_MIN_THREADS, REDUCE_THREADS, VARIANTS, emit_grid, front_emit_lanes, front_emit_map,
    front_planes, front_planes_ref, front_reduce_lanes, front_reduce_map,
    make_streams, reduce_grid)

REPO = Path(__file__).resolve().parent.parent
C_LOG2, MJ = 14, 256
C = 1 << C_LOG2
NJ = C // 16
K = 16


def load_script(name, argv):
    """Import scripts/<name>.py under a patched sys.argv (the scripts read
    their sizes from sys.argv at import)."""
    spec = importlib.util.spec_from_file_location(
        "_script_" + name, REPO / "scripts" / (name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(sys, "argv", argv):
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def parts():
    return load_script("probe_pallas_parts", ["probe", str(C_LOG2), str(MJ)])


@pytest.fixture(scope="module")
def pfront():
    return load_script("probe_pallas_front", ["probe", str(C_LOG2), str(MJ)])


@pytest.fixture(scope="module")
def mxu():
    return load_script("probe_front_mxu", ["probe", str(C_LOG2), str(MJ)])


@pytest.fixture(scope="module")
def chain():
    with mock.patch.dict("os.environ", {"MODIMIZER_PROBE_MJ": str(MJ)}):
        return load_script("probe_chain_time", ["probe", str(C_LOG2)])


def seeded_sw(seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, C + K - 1).astype(np.uint8)
    return pack_sw(codes, C // 32 + 2)


def torch_streams(sw):
    return make_streams(torch.from_numpy(sw.view(np.int64)), NJ)


def jax_streams(mod, sw):
    """The script's own make_streams, as (1, NJ) u32 blocks."""
    out = mod.make_streams(jnp.asarray(sw), NJ)
    return tuple(x.reshape(1, NJ) for x in out)


IN4 = [pl.BlockSpec((1, MJ), lambda g: (g * 0, g),
                    memory_space=pltpu.VMEM)] * 4
PLANE = pl.BlockSpec((16, MJ), lambda g: (g * 0, g), memory_space=pltpu.VMEM)
KM = jax.ShapeDtypeStruct((16, NJ), jnp.uint32)
EM = jax.ShapeDtypeStruct((16, NJ), jnp.int8)


def pallas(kern, args, *, in_specs=IN4, out_specs=(PLANE, PLANE),
           out_shape=(KM, EM)):
    return pl.pallas_call(kern, grid=(NJ // MJ,), in_specs=in_specs,
                          out_specs=out_specs, out_shape=out_shape,
                          interpret=True)(*args)


def pos_order(plane):
    """[16, NJ] TPU plane (element [s, j] = position 16 j + s) -> [C]."""
    return np.asarray(plane).T.reshape(-1)


def assert_planes(got, km_want, em_want):
    km, em = got
    assert np.array_equal(km.numpy().view(np.uint32), pos_order(km_want))
    assert np.array_equal(em.numpy(), pos_order(em_want))


def port(sw, sh, w, variant, **kw):
    return front_planes_ref(*torch_streams(sw), factor1=sh.factor1, w=w,
                            variant=variant, mj=MJ, **kw)


def test_make_streams_equal_script(parts):
    sw = seeded_sw(1)
    for got, want in zip(torch_streams(sw), jax_streams(parts, sw)):
        assert np.array_equal(got.numpy().view(np.uint32),
                              np.asarray(want).reshape(-1))


@pytest.mark.parametrize("w", [2, 16, 64])
def test_full_equal_kern_full(parts, w):
    sh = Seqhash.create(K, w, 17)
    sw = seeded_sw(w)
    kern = functools.partial(parts.kern_full, factor1=sh.factor1, w=w)
    assert_planes(port(sw, sh, w, "full"),
                  *pallas(kern, jax_streams(parts, sw)))


def test_kmonly_equal_kern_kmonly(parts):
    sh, w = Seqhash.create(K, 16, 17), 16
    sw = seeded_sw(3)
    kern = functools.partial(parts.kern_kmonly, factor1=sh.factor1, w=w)
    want = pallas(kern, jax_streams(parts, sw), out_specs=PLANE,
                  out_shape=KM)
    (km,) = port(sw, sh, w, "kmonly")
    assert np.array_equal(km.numpy().view(np.uint32), pos_order(want))


def test_emonly_equal_kern_emonly(parts):
    sh, w = Seqhash.create(K, 16, 17), 16
    sw = seeded_sw(4)
    kern = functools.partial(parts.kern_emonly, factor1=sh.factor1, w=w)
    want = pallas(kern, jax_streams(parts, sw), out_specs=PLANE,
                  out_shape=EM)
    (em,) = port(sw, sh, w, "emonly")
    assert np.array_equal(em.numpy(), pos_order(want))


@pytest.mark.parametrize("seed", [0, 5])
def test_noin_equal_kern_noin(parts, seed):
    sh, w = Seqhash.create(K, 16, 17), 16
    kern = functools.partial(parts.kern_noin, factor1=sh.factor1, w=w)
    smem = pl.BlockSpec((1, 1), lambda g: (g * 0, g * 0),
                        memory_space=pltpu.SMEM)
    want = pallas(kern, (jnp.full((1, 1), seed, jnp.int32),),
                  in_specs=[smem])
    assert_planes(port(seeded_sw(0), sh, w, "noin", seed=seed), *want)


def test_noout_equal_kern_noout(parts):
    """The TPU's f32 accumulator is exact at this size (all sums < 2^24)."""
    sh, w = Seqhash.create(K, 16, 17), 16
    sw = seeded_sw(6)
    kern = functools.partial(parts.kern_noout, factor1=sh.factor1, w=w)
    acc_spec = pl.BlockSpec((8, 128), lambda g: (g * 0, g * 0),
                            memory_space=pltpu.VMEM)
    want = np.asarray(pallas(kern, jax_streams(parts, sw),
                             out_specs=acc_spec,
                             out_shape=jax.ShapeDtypeStruct((8, 128),
                                                            jnp.float32)))
    (acc,) = port(sw, sh, w, "noout")
    assert acc.dtype == torch.int64 and acc.shape == (8, 128)
    assert float(want.max()) < 2 ** 24
    assert np.array_equal(acc.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("w", [16, 64])
def test_count_equal_timing_kernel(pfront, w):
    sh = Seqhash.create(K, w, 17)
    sw = seeded_sw(7 + w)
    kern = functools.partial(pfront.timing_kernel, factor1=sh.factor1, w=w)
    P, Z = pfront.make_streams(jnp.asarray(sw))
    args = tuple(x.reshape(1, NJ)
                 for x in (P[:NJ], P[1:NJ + 1], Z[:NJ], Z[1:NJ + 1]))
    smem = pl.BlockSpec((1, 1), lambda g: (g * 0, g * 0),
                        memory_space=pltpu.SMEM)
    want = pallas(kern, args, out_specs=smem,
                  out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32))
    (n,) = port(sw, sh, w, "count")
    assert int(n) == int(np.asarray(want)[0, 0])


def test_full_equal_plane_kernel(pfront):
    sh, w = Seqhash.create(K, 16, 17), 16
    sw = seeded_sw(8)
    kern = functools.partial(pfront.plane_kernel, factor1=sh.factor1, w=w)
    P, Z = pfront.make_streams(jnp.asarray(sw))
    args = tuple(x.reshape(1, NJ)
                 for x in (P[:NJ], P[1:NJ + 1], Z[:NJ], Z[1:NJ + 1]))
    assert_planes(port(sw, sh, w, "full"), *pallas(kern, args))


@pytest.mark.parametrize("hashed", [True, False])
def test_equal_kern_front(chain, parts, hashed):
    """probe_chain_time makes its streams inside main(); they are
    probe_pallas_parts.make_streams'."""
    sh, w = Seqhash.create(K, 16, 17), 16
    sw = seeded_sw(9)
    kern = functools.partial(chain.kern_front, factor1=sh.factor1, w=w,
                             hashed=hashed)
    assert_planes(port(sw, sh, w, "full" if hashed else "nohash"),
                  *pallas(kern, jax_streams(parts, sw)))


@pytest.mark.parametrize("name", ["kern_nohash", "kern_mul16"])
def test_equal_probe_front_mxu(mxu, name):
    sh, w = Seqhash.create(K, 16, 17), 16
    sw = seeded_sw(10)
    kern = getattr(mxu, name)
    if name == "kern_mul16":
        kern = functools.partial(kern, factor1=sh.factor1, w=w)
    P, Z = mxu.make_streams(jnp.asarray(sw))
    args = tuple(x.reshape(1, NJ)
                 for x in (P[:NJ], P[1:NJ + 1], Z[:NJ], Z[1:NJ + 1]))
    variant = "nohash" if name == "kern_nohash" else "full"
    assert_planes(port(sw, sh, w, variant), *pallas(kern, args))


@pytest.mark.parametrize("w", [2, 16, 64])
def test_full_equal_scan_front_u32(w):
    """The XLA front of the JAX package: same k-mer at every position, and
    emit = mod_is_zero(hash, w)."""
    sh = Seqhash.create(K, w, 17)
    sw = seeded_sw(20 + w)
    hashes, kmers, _pos, _isF = _scan_front_u32(jnp.asarray(sw), k=K,
                                                factor1=sh.factor1, C=C)
    emit = mod_is_zero(hashes, w)
    km, em = port(sw, sh, w, "full")
    assert np.array_equal(km.numpy().view(np.uint32), pos_order(kmers))
    assert np.array_equal(em.numpy().astype(bool), pos_order(emit))
    (n,) = port(sw, sh, w, "count")
    assert int(n) == int(np.asarray(emit).sum())


def test_ablations_derive_from_full():
    """kmonly, emonly, noout and count are functions of full's planes."""
    sh, w = Seqhash.create(K, 16, 17), 16
    sw = seeded_sw(30)
    km, em = port(sw, sh, w, "full")
    kmu = km.numpy().view(np.uint32)
    e = em.numpy().astype(bool)
    (kmo,) = port(sw, sh, w, "kmonly")
    assert np.array_equal(kmo.numpy().view(np.uint32), np.where(e, kmu, ~kmu))
    (emo,) = port(sw, sh, w, "emonly")
    assert np.array_equal(emo.numpy().astype(bool), e & (kmu != 0))
    (acc,) = port(sw, sh, w, "noout")
    v = (kmu & 0xFFFF).astype(np.int64) + 65536 * e
    assert int(acc.sum()) == int(v.sum())
    (n,) = port(sw, sh, w, "count")
    assert int(n) == int(e.sum())


def test_poly_a_emits_everywhere():
    """k-mer 0 hashes to 0: every position of an all-A stream emits."""
    sh, w = Seqhash.create(K, 64, 17), 64
    sw = pack_sw(np.zeros(C + K - 1, np.uint8), C // 32 + 2)
    km, em = port(sw, sh, w, "full")
    assert bool((em == 1).all()) and bool((km == 0).all())


@pytest.mark.parametrize("variant", VARIANTS)
def test_wrapper_on_cpu_is_the_plain_version(variant):
    sh, w = Seqhash.create(K, 16, 17), 16
    st = torch_streams(seeded_sw(40))
    args = dict(factor1=sh.factor1, w=w, variant=variant, mj=MJ, seed=3)
    for a, b in zip(front_planes(*st, **args), front_planes_ref(*st, **args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [dict(k=15), dict(w=31), dict(w=0),
                                 dict(variant="fusedc"), dict(mj=100),
                                 dict(mj=512 * 3)])
def test_contract_refused(bad):
    st = torch_streams(seeded_sw(41))
    args = dict(factor1=Seqhash.create(K, 16, 17).factor1, w=16,
                variant="full", mj=MJ)
    args.update(bad)
    with pytest.raises(ValueError):
        front_planes(*st, **args)


# ---- front_reduce's schedule (csrc/front_reduce.cu), rehearsed on the CPU

REDUCE_NJ = [128, 384, 4096, 1 << 16]
# (blocks, threads): one block, an odd grid of smaller blocks, the H100's
# SMs at one and two blocks each (grids larger than the work at small NJ)
REDUCE_GRIDS = [(1, 1024), (7, 512), (132, 1024), (264, 1024)]


def random_streams(NJ, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, 16 * NJ + K - 1).astype(np.uint8)
    sw = pack_sw(codes, NJ // 2 + 2)
    return make_streams(torch.from_numpy(sw.view(np.int64)), NJ)


@pytest.mark.parametrize("NJ", REDUCE_NJ)
@pytest.mark.parametrize("G,T", REDUCE_GRIDS)
def test_front_reduce_map_takes_each_word_once(NJ, G, T):
    j = front_reduce_map(NJ, G, T)
    took = j >= 0
    assert torch.equal(j[took].sort().values, torch.arange(NJ))
    t = torch.arange(T)[None, :, None].expand_as(j)
    assert torch.equal(j[took] % 128, t[took] % 128)


@pytest.mark.parametrize("NJ", REDUCE_NJ)
@pytest.mark.parametrize("G,T", REDUCE_GRIDS)
def test_front_reduce_lanes_equal_ref(NJ, G, T):
    st = random_streams(NJ, NJ + G)
    for w in (2, 16, 64):
        f1 = Seqhash.create(K, w, 17).factor1
        for v in ("noout", "count"):
            got = front_reduce_lanes(*st, factor1=f1, w=w, variant=v, G=G,
                                     T=T)
            want = front_planes_ref(*st, factor1=f1, w=w, variant=v, mj=128)
            assert got[0].dtype == torch.int64
            assert got[0].shape == want[0].shape
            assert torch.equal(got[0], want[0]), (w, v)


def script_reductions(parts, pfront, sw, sh, w):
    """kern_noout's [8, 128] and timing_kernel's count in interpret mode,
    as exact integers (their f32 sums are exact below 2^24)."""
    acc_spec = pl.BlockSpec((8, 128), lambda g: (g * 0, g * 0),
                            memory_space=pltpu.VMEM)
    kern = functools.partial(parts.kern_noout, factor1=sh.factor1, w=w)
    acc = np.asarray(pallas(kern, jax_streams(parts, sw), out_specs=acc_spec,
                            out_shape=jax.ShapeDtypeStruct((8, 128),
                                                           jnp.float32)))
    kern = functools.partial(pfront.timing_kernel, factor1=sh.factor1, w=w)
    P, Z = pfront.make_streams(jnp.asarray(sw))
    args = tuple(x.reshape(1, NJ)
                 for x in (P[:NJ], P[1:NJ + 1], Z[:NJ], Z[1:NJ + 1]))
    smem = pl.BlockSpec((1, 1), lambda g: (g * 0, g * 0),
                        memory_space=pltpu.SMEM)
    n = pallas(kern, args, out_specs=smem,
               out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32))
    assert float(acc.max()) < 2 ** 24
    return acc.astype(np.int64), int(np.asarray(n)[0, 0])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("w", [2, 16, 64])
def test_front_reduce_lanes_equal_scripts(parts, pfront, seed, w):
    sh = Seqhash.create(K, w, 17)
    sw = seeded_sw(50 + seed)
    acc_want, n_want = script_reductions(parts, pfront, sw, sh, w)
    st = torch_streams(sw)
    for G, T in REDUCE_GRIDS:
        args = dict(factor1=sh.factor1, w=w, G=G, T=T)
        (acc,) = front_reduce_lanes(*st, variant="noout", **args)
        (n,) = front_reduce_lanes(*st, variant="count", **args)
        assert np.array_equal(acc.numpy(), acc_want), (G, T)
        assert int(n) == n_want, (G, T)
    (acc,) = port(sw, sh, w, "noout")
    (n,) = port(sw, sh, w, "count")
    assert np.array_equal(acc.numpy(), acc_want) and int(n) == n_want


def test_front_reduce_u32_headroom():
    """A thread's u32 row sum gains at most 2 x 0xFFFF a word: MAX_WORDS
    words fit and one more could wrap; the grid's least thread count takes
    the wrapper's largest NJ within MAX_WORDS words a thread, and C = 2^30
    (the probes' widest input) is far inside it."""
    gain = 2 * 0xFFFF
    assert REDUCE_MAX_WORDS * gain <= 2 ** 32 - 1
    assert (REDUCE_MAX_WORDS + 1) * gain > 2 ** 32 - 1
    assert 16 * REDUCE_MAX_WORDS * REDUCE_THREADS < 2 ** 32  # count, a block
    assert REDUCE_MAX_NJ == REDUCE_MAX_WORDS * REDUCE_MIN_THREADS == 2 ** 31
    assert (1 << 30) // 16 * 32 == REDUCE_MAX_NJ
    for bps, sms in ((1, 1), (1, 132), (2, 132), (1, 16), (3, 7)):
        for nj in (128, 1 << 20, REDUCE_MAX_NJ - 128, REDUCE_MAX_NJ):
            G = reduce_grid(nj, bps, sms)
            assert 1 <= G <= -(-nj // REDUCE_THREADS)
            assert -(-nj // (G * REDUCE_THREADS)) <= REDUCE_MAX_WORDS
    assert reduce_grid(1 << 20, 1, 132) == 132
    assert reduce_grid(1 << 20, 2, 132) == 264
    assert reduce_grid(128, 2, 132) == 1


def meta_streams(NJ):
    return tuple(torch.empty(NJ, dtype=torch.int32, device="meta")
                 for _ in range(4))


@pytest.mark.parametrize("variant", ["noout", "count"])
def test_front_reduce_refused_above_headroom(variant):
    args = dict(factor1=Seqhash.create(K, 16, 17).factor1, w=16,
                variant=variant, mj=4096)
    over = meta_streams(REDUCE_MAX_NJ + 4096)
    for fn in (front_planes, front_planes_ref):
        with pytest.raises(ValueError, match="could wrap"):
            fn(*over, **args)
    # at the limit the wrapper gets past the check (and on to the device)
    with pytest.raises(ValueError, match="unsupported device"):
        front_planes(*meta_streams(REDUCE_MAX_NJ), **args)
    # a grid whose threads would take more than MAX_WORDS words
    del args["mj"]
    with pytest.raises(ValueError, match="words a thread"):
        front_reduce_lanes(*meta_streams(REDUCE_MAX_WORDS * 128 + 128),
                           G=1, T=128, **args)


def _map_stride_off_128(NJ, G, T):
    """Each block's first T - 64 threads take the words of a grid of
    G (T - 64): every word once, but the stride is not a multiple of 128."""
    j = front_reduce_map(NJ, G, T - 64)
    pad = torch.full((G, 64, j.shape[2]), -1, dtype=torch.int64)
    return torch.cat([j, pad], dim=1)


@pytest.mark.parametrize("mutant", ["stride", "row"])
def test_front_reduce_mutated_map_fails(monkeypatch, mutant):
    """noout's lanes and rows are where a wrong map shows (count's total
    does not depend on them)."""
    st = random_streams(4096, 60)
    f1 = Seqhash.create(K, 16, 17).factor1
    G, T = 7, 512
    if mutant == "stride":
        j = _map_stride_off_128(4096, G, T)
        assert torch.equal(j[j >= 0].sort().values, torch.arange(4096))
        monkeypatch.setattr(front_kernel, "front_reduce_map",
                            _map_stride_off_128)
    else:       # phase s + 8 folded into row s + 1
        monkeypatch.setattr(front_kernel, "front_reduce_row",
                            lambda s: (s + (s >> 3)) & 7)
    (got,) = front_reduce_lanes(*st, factor1=f1, w=16, variant="noout",
                                G=G, T=T)
    (want,) = front_planes_ref(*st, factor1=f1, w=16, variant="noout",
                               mj=128)
    assert not torch.equal(got, want)


# ---- front_planes.cu's emonly kernel (front_emit_kernel), on the CPU

# (kind of streams, NJ): whole blocks and the two tails
EMIT_CASES = [("random", 1024), ("random", 128), ("random", 384),
              ("independent", 1024), ("independent", 384),
              ("poly_a", 1024), ("poly_t", 1024)]
# (blocks, threads, words a batch): one block whose threads take a whole
# and a partial batch at NJ = 384, the kernel's 256 threads with one and two
# words a batch, the H100's 132 SMs, small blocks with four words a batch
EMIT_GRIDS = [(1, 128, 2), (7, 256, 2), (132, EMIT_THREADS, EMIT_WORDS),
              (1, 256, 1), (3, 64, 4)]


@pytest.fixture(scope="module")
def parts128():
    """probe_pallas_parts with MJ = 128: its kernels' blocks fit the tails."""
    return load_script("probe_pallas_parts", ["probe", str(C_LOG2), "128"])


def emit_inputs(kind, NJ, seed):
    """int32 [NJ] x 4: make_streams of random, all-A or all-T bases, or
    four independent random u32 streams (pb is not pa shifted)."""
    rng = np.random.default_rng(seed)
    if kind == "independent":
        return tuple(torch.from_numpy(rng.integers(0, 2 ** 32, NJ,
                                                   dtype=np.uint64)
                                      .astype(np.uint32).view(np.int32))
                     for _ in range(4))
    n = 16 * NJ + K - 1
    codes = {"random": lambda: rng.integers(0, 4, n),
             "poly_a": lambda: np.zeros(n),
             "poly_t": lambda: np.full(n, 3)}[kind]().astype(np.uint8)
    sw = pack_sw(codes, NJ // 2 + 2)
    return make_streams(torch.from_numpy(sw.view(np.int64)), NJ)


def kern_emonly_interpret(parts128, st, factor1, w):
    """kern_emonly in interpret mode on the four streams, in position
    order."""
    NJ = st[0].shape[0]
    kern = functools.partial(parts128.kern_emonly, factor1=factor1, w=w)
    spec = pl.BlockSpec((1, 128), lambda g: (g * 0, g),
                        memory_space=pltpu.VMEM)
    plane = pl.BlockSpec((16, 128), lambda g: (g * 0, g),
                         memory_space=pltpu.VMEM)
    args = tuple(jnp.asarray(t.numpy().view(np.uint32)).reshape(1, NJ)
                 for t in st)
    em = pl.pallas_call(kern, grid=(NJ // 128,), in_specs=[spec] * 4,
                        out_specs=plane,
                        out_shape=jax.ShapeDtypeStruct((16, NJ), jnp.int8),
                        interpret=True)(*args)
    return pos_order(em)


@pytest.mark.parametrize("w", [2, 16, 64])
@pytest.mark.parametrize("kind,NJ", EMIT_CASES)
def test_front_emit_lanes_equal_kern_emonly(parts128, kind, NJ, w):
    st = emit_inputs(kind, NJ, NJ + w)
    f1 = Seqhash.create(K, w, 17).factor1
    want = kern_emonly_interpret(parts128, st, f1, w)
    (ref,) = front_planes_ref(*st, factor1=f1, w=w, variant="emonly", mj=128)
    assert ref.dtype == torch.int8
    assert np.array_equal(ref.numpy(), want)
    for G, T, U in EMIT_GRIDS:
        (got,) = front_emit_lanes(*st, factor1=f1, w=w, G=G, T=T, U=U)
        assert np.array_equal(got.numpy(), want), (G, T, U)


@pytest.mark.parametrize("kind", ["poly_a", "poly_t"])
def test_poly_chunk_emits_everywhere_and_em_is_zero(kind):
    """On all-A (kf = 0) and all-T (kr = 0) chunks the canonical k-mer is 0
    and hashes to 0: every position emits, and em = emit & (km != 0) is all
    0 (a kernel that dropped the mask would store all 1)."""
    st = emit_inputs(kind, 1024, 0)
    f1 = Seqhash.create(K, 64, 17).factor1
    km, em = front_planes_ref(*st, factor1=f1, w=64, variant="full", mj=128)
    assert bool((em == 1).all()) and bool((km == 0).all())
    (e,) = front_planes_ref(*st, factor1=f1, w=64, variant="emonly", mj=128)
    assert not bool(e.any())


@pytest.mark.parametrize("NJ", [128, 384, 4096, 1 << 16])
@pytest.mark.parametrize("G,T,U", EMIT_GRIDS)
def test_front_emit_map_takes_each_word_once(NJ, G, T, U):
    """Every word once; a thread's guarded slots come after its words (the
    last, partial batch); a warp's 32 threads take 32 consecutive words in
    each slot (its loads of a stream are 128 contiguous bytes, its uint4
    stores 512)."""
    j = front_emit_map(NJ, G, T, U)
    assert j.shape[:2] == (G, T) and j.shape[3] == U
    took = j >= 0
    assert torch.equal(j[took].sort().values, torch.arange(NJ))
    flat = took.reshape(G, T, -1).to(torch.int8)
    assert bool((flat[..., 1:] <= flat[..., :-1]).all())
    lanes = j.reshape(G, T // 32, 32, -1)
    both = (lanes[:, :, 1:] >= 0) & (lanes[:, :, :-1] >= 0)
    assert bool(((lanes[:, :, 1:] - lanes[:, :, :-1])[both] == 1).all())


def test_emit_grid():
    """The blocks an SM holds on every SM, and no more than the words fill
    at a word a thread."""
    assert emit_grid(1 << 20, 5, 132) == 660
    assert emit_grid(1 << 21, 8, 132) == 1056
    assert emit_grid(128, 5, 132) == 1
    assert emit_grid(384, 5, 132) == 2
    for nj in (128, 384, 1 << 16, 1 << 20):
        for bps in (1, 4, 8):
            G = emit_grid(nj, bps, 132)
            assert 1 <= G <= max(1, -(-nj // EMIT_THREADS))


def _loads_pb_from_pa(pa, pb, za, zb, j):
    """pb[j] taken as pa[j + 1] and zb[j] as za[j + 1] (the last word from
    pb and zb): what make_streams' streams allow, and no more."""
    return (pa[j], torch.cat([pa, pb[-1:]])[j + 1], za[j],
            torch.cat([za, zb[-1:]])[j + 1])


def _pack_big_endian(em):
    b = em.to(torch.int64).reshape(*em.shape[:-1], 4, 4)
    return (b << (24 - 8 * torch.arange(4))).sum(dim=-1)


@pytest.mark.parametrize("mutant", ["pb_from_pa", "big_endian"])
def test_front_emit_mutated_map_fails(monkeypatch, mutant):
    """Four independent streams show a kernel that reads pa[j + 1] for
    pb[j] (make_streams' streams do not); any stream shows bytes packed
    big-endian."""
    f1 = Seqhash.create(K, 2, 17).factor1
    args = dict(factor1=f1, w=2, G=7, T=256, U=2)

    def ref(st):
        return front_planes_ref(*st, factor1=f1, w=2, variant="emonly",
                                mj=128)[0]

    shifted = emit_inputs("random", 1024, 70)
    independent = emit_inputs("independent", 1024, 71)
    if mutant == "pb_from_pa":
        monkeypatch.setattr(front_kernel, "front_emit_loads",
                            _loads_pb_from_pa)
        assert torch.equal(front_emit_lanes(*shifted, **args)[0],
                           ref(shifted))
    else:
        monkeypatch.setattr(front_kernel, "front_emit_pack", _pack_big_endian)
        assert not torch.equal(front_emit_lanes(*shifted, **args)[0],
                               ref(shifted))
    assert not torch.equal(front_emit_lanes(*independent, **args)[0],
                           ref(independent))
