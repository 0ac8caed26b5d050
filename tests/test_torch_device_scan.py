"""Per-chunk programs of the port (densify_ref, and scan_chunk without and
with meta) vs the JAX package's _densify_cols_search, _scan_chunk_kmers and
_scan_chunk, bit for bit, overflow (total == -1) included."""

import shutil
import subprocess
from pathlib import Path

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
from modimizer_tpu_torch.ops.device_scan import (DENSIFY_TILE,  # noqa: E402
                                                 densify, densify_ref,
                                                 scan_chunk)
from modimizer_tpu_torch.ops import consts as port_consts  # noqa: E402
from modimizer_tpu_torch.ops.scan_kernel import scan_compact_ref  # noqa: E402

U32_SENT = np.uint32(0xFFFFFFFF)
CSRC = Path(__file__).resolve().parent.parent / "modimizer_tpu_torch" / "csrc"


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


# the shapes the densify kernel must get right, k16 w16: (C, blk, poly-A,
# no valid position, bo = the port's scan_bo(16, blk) x this, cap: None =
# every block row, "wide" = the scanner's wide retry, else a row count)
DENSIFY_CASES = {
    "blk128": (1 << 16, 128, False, False, 1, None),     # 2 tiles
    "blk4096": (1 << 16, 4096, False, False, 1, None),
    "tiles": (1 << 18, BLK_COMPACT, False, False, 1, None),
    "wide": (1 << 18, BLK_COMPACT, False, False, 4, "wide"),
    "empty": (1 << 16, BLK_COMPACT, False, True, 1, None),
    "poly_a": (1 << 16, BLK_COMPACT, True, False, 1, 1 << 14),
    "cap_cut": (1 << 16, BLK_COMPACT, False, False, 1, 1500),
}


def densify_case(name):
    """(out_k, out_meta, cnt, bo, cap) of scan_compact_ref's rows for
    case ``name``, meta (p << 1) | isF as scan_chunk has it."""
    C, blk, poly_a, empty, widen_bo, cap = DENSIFY_CASES[name]
    k, w = 16, 16
    sh = Seqhash.create(k, w, 17)
    _codes, sw, vw = chunk(k, C, 11, poly_a)
    if empty:
        vw[:] = 0
    nb = C // blk
    bo = min(blk, port_consts.scan_bo(w, blk) * widen_bo)
    if cap is None:
        cap = nb * bo
    elif cap == "wide":       # ModimizerScanner._wide: 4x the scanner's cap
        cap = min(nb * bo, 4 * cap_for(C, w))
    out_k, out_meta, cnt, _n, _ovf = scan_compact_ref(
        t64(sw), t64(vw), k=k, w=w, factor1=sh.factor1, C=C, bo=bo,
        meta_isf=True, blk=blk)
    cap = min(cap, nb * bo)
    if poly_a:
        assert bool((cnt > bo).all())
    if empty:
        assert int(cnt.sum()) == 0
    if name == "cap_cut":
        assert int(cnt.clamp(max=bo).sum()) > cap
    return out_k, out_meta, cnt, bo, cap


@pytest.mark.parametrize("with_meta", [False, True])
@pytest.mark.parametrize("case", list(DENSIFY_CASES))
def test_densify_ref_equals_jax_on_kernel_shapes(case, with_meta):
    out_k, out_meta, cnt, bo, cap = densify_case(case)
    meta = out_meta if with_meta else None
    dk, dm = densify_ref(out_k, meta, cnt, bo=bo, cap=cap)
    jk = jnp.asarray(out_k.numpy().view(np.uint64))
    jm = jnp.asarray(out_meta.numpy().view(np.uint32))
    cols = (jk, jm) if with_meta else (jk,)
    sents = (jnp.uint64(0xFFFFFFFFFFFFFFFF), U32_SENT)[:len(cols)]
    want = _densify_cols_search(cols, jm != U32_SENT, bo, cap, sents)
    assert np.array_equal(dk.numpy().view(np.uint64), np.asarray(want[0]))
    if with_meta:
        assert np.array_equal(dm.numpy().view(np.uint32), np.asarray(want[1]))
    else:
        assert dm is None
    live = int(cnt.clamp(max=bo).sum())
    assert int((dk != -1).sum()) == min(live, cap)


# Replays densify.cu's two launches on the host with its own placement
# helpers (tile_count, live_rows, warp_block_of, place_row): per tile the
# aggregate, per warp the lanes' exclusive prefixes, each row q of a warp's
# range placed, then the sentinel tail.  Exits 3 if a slot is not written
# exactly once, 4 if a row is read past its block's live rows.
_HOST_REPLAY = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "densify.cu"
using namespace densify_place;

template <class T> static void rd(FILE* f, T* p, size_t n) {
    if (n && fread(p, sizeof(T), n, f) != n) exit(2);
}

int main(int argc, char** argv) {
    FILE* f = fopen(argv[1], "rb");
    int64_t hdr[4];                          // nb, bo, cap, with_meta
    rd(f, hdr, 4);
    const int64_t nb = hdr[0], cap = hdr[2];
    const int bo = (int)hdr[1];
    std::vector<int32_t> cnt(nb), src_m(hdr[3] ? nb * bo : 0);
    std::vector<int64_t> src_k(nb * bo);
    rd(f, cnt.data(), nb);
    rd(f, src_k.data(), src_k.size());
    rd(f, src_m.data(), src_m.size());
    fclose(f);
    const int64_t ntiles = tile_count(nb);
    std::vector<int64_t> agg(ntiles, 0);
    int64_t total = 0;
    for (int64_t t = 0; t < ntiles; ++t) {
        for (int j = 0; j < TPB; ++j) {
            const int64_t b = t * TPB + j;
            agg[t] += b < nb ? live_rows(cnt[b], bo) : 0;
        }
        total += agg[t];
    }
    std::vector<int64_t> dk(cap, 0);
    std::vector<int32_t> dm(cap, 0);
    std::vector<int> writes(cap, 0);
    int64_t before = 0;
    for (int64_t t = 0; t < ntiles; ++t) {
        int64_t wbase = 0;
        for (int w = 0; w < WARPS; ++w) {
            const int64_t b0 = t * TPB + w * 32;
            int excl[32], live[32], s = 0;
            for (int l = 0; l < 32; ++l) {
                live[l] = b0 + l < nb ? live_rows(cnt[b0 + l], bo) : 0;
                excl[l] = s;
                s += live[l];
            }
            const auto p = [&](int l) { return excl[l]; };
            for (int q = 0; q < s; ++q) {
                int pl;
                const int l = warp_block_of(p, q, &pl);
                if (pl != excl[l] || q - pl >= live[l]) return 4;
                const Place pc = place_row(b0, l, pl, q, bo, before + wbase);
                if (pc.dst >= cap) continue;
                dk[pc.dst] = src_k[pc.src];
                if (hdr[3]) dm[pc.dst] = src_m[pc.src];
                ++writes[pc.dst];
            }
            wbase += s;
        }
        before += agg[t];
    }
    for (int64_t i = total < cap ? total : cap; i < cap; ++i) {
        dk[i] = -1;
        dm[i] = -1;
        ++writes[i];
    }
    for (int64_t i = 0; i < cap; ++i)
        if (writes[i] != 1) return 3;
    f = fopen(argv[2], "wb");
    fwrite(dk.data(), 8, cap, f);
    fwrite(dm.data(), 4, hdr[3] ? cap : 0, f);
    fclose(f);
    printf("%d\n", TPB);
    return 0;
}
"""


@pytest.fixture(scope="module")
def placement_replay(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: densify.cu's placement helpers "
                    "cannot be compiled as host code")
    d = tmp_path_factory.mktemp("densify_host")
    (d / "replay.cpp").write_text(_HOST_REPLAY)
    exe = d / "replay"
    r = subprocess.run([gxx, "-std=c++17", "-O1", "-Wall",
                        "-Wno-unknown-pragmas", "-x", "c++",
                        "-DMZ_DENSIFY_HOST", "-I", str(CSRC),
                        str(d / "replay.cpp"), "-o", str(exe)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return exe


@pytest.mark.parametrize("with_meta", [False, True])
@pytest.mark.parametrize("case", list(DENSIFY_CASES))
def test_densify_placement_host(placement_replay, tmp_path, case,
                                with_meta):
    """densify.cu's placement arithmetic, compiled by g++, places every
    row where densify_ref does and writes each slot once."""
    out_k, out_meta, cnt, bo, cap = densify_case(case)
    nb = cnt.shape[0]
    src = tmp_path / "in.bin"
    with open(src, "wb") as f:
        f.write(np.array([nb, bo, cap, int(with_meta)], np.int64).tobytes())
        f.write(cnt.numpy().tobytes())
        f.write(out_k.numpy().tobytes())
        if with_meta:
            f.write(out_meta.numpy().tobytes())
    dst = tmp_path / "out.bin"
    r = subprocess.run([str(placement_replay), str(src), str(dst)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.returncode, r.stderr)
    assert int(r.stdout) == DENSIFY_TILE
    got = np.fromfile(dst, np.uint8)
    dk, dm = densify_ref(out_k, out_meta if with_meta else None, cnt, bo=bo,
                         cap=cap)
    assert np.array_equal(got[:8 * cap].view(np.int64), dk.numpy())
    if with_meta:
        assert np.array_equal(got[8 * cap:].view(np.int32), dm.numpy())
    else:
        assert got.size == 8 * cap


@pytest.mark.parametrize("k,w", [(16, 16), (19, 31), (11, 10)])
def test_scan_kmers_body_equals_jax(k, w):
    C = 1 << 14
    sh = Seqhash.create(k, w, 17)
    bo, cap = scan_bo(w), cap_for(C, w)
    for seed, poly_a, cap_ in ((k, False, cap), (k + 1, True, cap),
                               (k + 2, False, 128)):
        _codes, sw, vw = chunk(k, C, seed, poly_a)
        dk, dm, tot = scan_chunk(t64(sw), t64(vw), k=k, w=w,
                                 factor1=sh.factor1, bo=bo, cap=cap_,
                                 with_meta=False)
        assert dm is None
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
        # the prefix mask _scan_chunk builds from m, as bit-words
        vw = np.packbits(np.arange(C) < m, bitorder="little").view(np.uint64)
        dk, dm, tot = scan_chunk(t64(sw), t64(vw), k=k, w=w,
                                 factor1=sh.factor1, bo=bo, cap=cap,
                                 with_meta=True)
        jk, jm, jtot = _scan_chunk(jnp.asarray(sw), jnp.int32(m), k=k, w=w,
                                   factor1=sh.factor1, bo=bo, cap=cap)
        assert int(tot) == int(jtot)
        assert np.array_equal(dk.numpy().view(np.uint64), widen(jk))
        assert np.array_equal(dm.numpy().view(np.uint32), np.asarray(jm))
        assert (int(tot) == -1) == poly_a
