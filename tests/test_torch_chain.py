"""The port's chaining (modimizer_tpu_torch/parallel/chain.py) against the
JAX package's (modimizer_tpu/parallel/chain.py) and a literal oracle of
the reference automaton (queryProcess, modmap.c:216-280), exactly.

``chain_scan_ref`` against JAX's ``chain_scan`` on the same [R, S] planes
(records, counts, overflow; caps that overflow too); ``chain_records`` on
device="cpu" against JAX's and the oracle on ``make_case`` seeds 1-4 at
cap=2 (the widen path) and on a small case of the chaining benchmark's
generator.  Then ``csrc/chain.cu`` itself, compiled as host code (g++
-DMZ_CHAIN_HOST): its per-read loop in the slots form against
``chain_scan_ref``, and its count pass and emit pass to exact offsets
against ``chain_emit_ref``, with mutated sources that must fail.  The
generators are copies of tests/test_chain.py's and
scripts/bench_chain.py's.
"""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

import jax.numpy as jnp  # noqa: E402

from modimizer_tpu.parallel import chain as jchain  # noqa: E402
from modimizer_tpu_torch.parallel import chain as tchain  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "modimizer_tpu_torch" / "csrc" / "chain.cu"


class FakeRef:
    def __init__(self, rev, loc, rid, info):
        self.rev = rev
        self.loc = loc
        self.id = rid

        class MS:
            pass
        self.ms = MS()
        self.ms.info = info


def oracle(ref, sidx, spos, seed_off):
    """Literal transcription of modmap.c:216-280 (the loc0 == 0 "no block"
    quirk, the copy-2 retry, the final n2 > 2 gate)."""
    info = ref.ms.info
    out_all = []
    for rd in range(len(seed_off) - 1):
        out = []
        loc0 = locN = i0 = iN = 0
        p0 = pN = 0
        n1 = n2 = 0
        for t in range(seed_off[rd], seed_off[rd + 1]):
            idx = sidx[t]
            if idx == 0 or (info[idx] & 3) == 3:
                continue
            loc = int(ref.rev[ref.loc[idx]])
            is1 = (info[idx] & 3) == 1

            def end_block(loc):
                if ref.id[loc] != ref.id[loc0]:
                    return True
                if loc0 < locN:
                    if loc < locN:
                        return True
                    d = locN - loc0 - iN + i0
                    if d > 50 or d < -50:
                        return True
                elif loc0 > locN:
                    if loc > locN:
                        return True
                    d = loc0 - locN - iN + i0
                    if d > 50 or d < -50:
                        return True
                return False

            end = (loc0 == 0) or end_block(loc)
            if end and loc0 and not is1:
                loc = int(ref.rev[ref.loc[idx] + 1])
                end = end_block(loc)
            if end:
                if n1 > 2:
                    out.append((p0, pN, loc0, locN, n1, n2, 0))
                n1 = n2 = 0
                loc0 = loc
                i0 = t - seed_off[rd]
                p0 = int(spos[t])
            if is1:
                n1 += 1
            else:
                n2 += 1
            locN = loc
            iN = t - seed_off[rd]
            pN = int(spos[t])
        if n2 > 2:
            out.append((p0, pN, loc0, locN, n1, n2, 1))
        out_all.append(out)
    return out_all


def make_case(seed, n_reads=40, n_mods=300, n_refs=3):
    """Random reference occurrence structure and seed lists: each mod copy
    1 (one occurrence), copy 2 (two) or copy M; reads sample runs of nearby
    occurrences (so real blocks form) and noise."""
    rng = np.random.default_rng(seed)
    info = np.zeros(n_mods + 1, np.uint8)
    info[1:] = rng.choice([1, 1, 2, 2, 3], n_mods).astype(np.uint8)
    n_occ = np.where((info & 3) == 1, 1, np.where((info & 3) == 2, 2, 1))
    n_occ[0] = 1
    loc = np.concatenate([[0], np.cumsum(n_occ[:-1])]).astype(np.uint32)
    total = int(n_occ.sum())
    rev = rng.permutation(total).astype(np.uint32)
    bounds = np.sort(rng.choice(total, n_refs - 1, replace=False))
    rid = np.searchsorted(bounds, np.arange(total), side="right"
                          ).astype(np.uint32)
    sidx, spos, off = [], [], [0]
    for _ in range(n_reads):
        ns = int(rng.integers(0, 60))
        p = 0
        for _ in range(ns):
            p += int(rng.integers(1, 40))
            spos.append(p)
            if rng.random() < 0.15:
                sidx.append(0)
            else:
                sidx.append(int(rng.integers(1, n_mods + 1)))
        off.append(len(sidx))
    return (FakeRef(rev, loc, rid, info),
            np.array(sidx, np.uint32), np.array(spos, np.int64),
            np.array(off, np.int64))


def bench_case(n_reads, spr, n_mods=200000, n_refs=24, seed=1):
    """The chaining benchmark's seeds: colinear-ish occurrences (so real
    blocks form), runs of consecutive mods with 10 % misses."""
    rng = np.random.default_rng(seed)
    info = np.zeros(n_mods + 1, np.uint8)
    info[1:] = rng.choice([1, 1, 1, 2, 3], n_mods).astype(np.uint8)
    n_occ = np.where((info & 3) == 2, 2, 1)
    n_occ[0] = 1
    loc = np.concatenate([[0], np.cumsum(n_occ[:-1])]).astype(np.uint32)
    total = int(n_occ.sum())
    rev = (np.arange(total, dtype=np.uint32)
           + rng.integers(-3, 4, total).astype(np.int64)).clip(
               0, total - 1).astype(np.uint32)
    bounds = np.sort(rng.choice(total, n_refs - 1, replace=False))
    rid = np.searchsorted(bounds, np.arange(total),
                          side="right").astype(np.uint32)
    ns = rng.integers(max(1, spr - 10), spr + 10, n_reads)
    seed_off = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
    S = int(seed_off[-1])
    base = rng.integers(1, n_mods - 200, n_reads)
    within = np.arange(S) - np.repeat(seed_off[:-1], ns)
    sidx = (np.repeat(base, ns) + within // 2).astype(np.uint32)
    sidx[rng.random(S) < 0.1] = 0
    spos = (within * 16).astype(np.int64)
    return FakeRef(rev, loc, rid, info), sidx, spos, seed_off


def dense_planes(ref, sidx, spos, off, S):
    """The seeds of each read in the first S slots of a row (dead past)."""
    flat = tchain.seed_planes(ref, sidx, spos)
    R = len(off) - 1
    out = []
    for x in flat:
        d = np.zeros((R, S), x.dtype)
        for r in range(R):
            m = min(S, off[r + 1] - off[r])
            d[r, :m] = x[off[r]:off[r] + m]
        out.append(d)
    return out


def t32(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


PLANE_CASES = [(1, 64, 1), (2, 64, 2), (3, 64, 8), (4, 40, 3), (5, 8, 2)]


@pytest.mark.parametrize("seed,S,cap", PLANE_CASES)
def test_chain_scan_ref_equals_jax(seed, S, cap):
    ref, sidx, spos, off = make_case(seed, n_reads=48)
    planes = dense_planes(ref, sidx, spos, off, S)
    idmap = np.asarray(ref.id, np.uint32)
    jr, jc, jo = jchain.chain_scan(*[jnp.asarray(x) for x in planes],
                                   jnp.asarray(idmap), cap=cap)
    pr, pc, po = tchain.chain_scan_ref(*[t32(x) for x in planes],
                                       t32(idmap), cap=cap)
    assert pr.dtype == torch.int32 and pr.shape == (48, cap, 7)
    assert np.array_equal(pr.numpy().view(np.uint32), np.asarray(jr))
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    assert bool(po) == bool(jo)
    if cap == 1:
        assert bool(po)                 # some read has two records


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_chain_records_equals_jax_and_oracle(seed):
    ref, sidx, spos, off = make_case(seed)
    want = oracle(ref, sidx, spos, off)
    jax_out = jchain.chain_records(ref, sidx, spos, off, cap=2)
    got = tchain.chain_records(ref, sidx, spos, off, cap=2, device="cpu")
    assert len(got) == len(off) - 1
    assert got == jax_out
    assert [[tuple(int(v) for v in r) for r in g] for g in got] == want


def test_chain_records_bench_case_equals_jax():
    ref, sidx, spos, off = bench_case(3000, 30, n_mods=20000)
    want = jchain.chain_records(ref, sidx, spos, off)
    got = tchain.chain_records(ref, sidx, spos, off, device="cpu")
    assert got == want
    assert sum(len(g) for g in got) > 3000
    assert [[tuple(int(v) for v in r) for r in g] for g in got[:200]] == \
        oracle(ref, sidx, spos, off[:201])


def test_chain_records_no_seeds():
    ref, _s, _p, _o = make_case(1)
    off = np.zeros(4, np.int64)
    got = tchain.chain_records(ref, np.zeros(0, np.uint32),
                               np.zeros(0, np.int64), off, device="cpu")
    assert got == [[], [], []]


def test_chain_records_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ref, sidx, spos, off = make_case(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tchain.chain_records(ref, sidx, spos, off)


# ------------------------------------------- csrc/chain.cu as host code

MUTANTS = {
    # the final block gated on n1 > 2
    "final_n1": [("if (B.n2 > 2) {", "if (B.n1 > 2) {")],
    # no copy-2 retry
    "no_retry": [("if (end && !one) {", "if (false) {")],
    # seed ordinals that skip the dead seeds
    "live_ordinal": [("const uint32_t t = (uint32_t)(s - a);",
                      "const uint32_t t = (uint32_t)(n_live++);"),
                     ("Block B{0, 0, 0, 0, 0, 0, 0, 0};",
                      "Block B{0, 0, 0, 0, 0, 0, 0, 0};\n"
                      "    uint32_t n_live = 0;")],
}


def build_host(out_dir, name, edits=()):
    src = SRC.read_text()
    for a, b in edits:
        assert a in src, a
        src = src.replace(a, b)
    cu = out_dir / (name + ".cc")
    cu.write_text(src)
    so = out_dir / (name + ".so")
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-DMZ_CHAIN_HOST", "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    L = ctypes.CDLL(str(so))
    L.mz_chain_host.restype = None
    p = ctypes.c_void_p
    L.mz_chain_host.argtypes = [p] * 8 + [ctypes.c_int64, p, ctypes.c_int,
                                          p, p, p]
    return L


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("chain_host")
    libs = {"kernel": build_host(d, "kernel")}
    for name, edits in MUTANTS.items():
        libs[name] = build_host(d, name, edits)
    return libs


def csr_inputs(ref, sidx, spos, off):
    la, lb, ia, ib, is1, live, ps = tchain.seed_planes(ref, sidx, spos)
    flags = ((is1.astype(np.uint8) * tchain.IS1)
             | (live.astype(np.uint8) * tchain.LIVE))
    return ([np.ascontiguousarray(x) for x in (la, lb, ia, ib)]
            + [flags, np.ascontiguousarray(ps),
               np.ascontiguousarray(ref.id, np.uint32),
               np.ascontiguousarray(off, np.int64)])


def host_slots(L, ins, R, cap):
    out = np.zeros((R, cap, 7), np.uint32)
    counts = np.zeros(R, np.int32)
    ovf = np.zeros(1, np.uint8)
    L.mz_chain_host(*[x.ctypes.data for x in ins], R, None, cap,
                    out.ctypes.data, counts.ctypes.data, ovf.ctypes.data)
    return out, counts, bool(ovf[0])


def host_offsets(L, ins, R):
    """The count pass, the offsets, the emit pass."""
    counts = np.full(R, -7, np.int32)
    rec_off = np.zeros(R + 1, np.int64)
    L.mz_chain_host(*[x.ctypes.data for x in ins], R, rec_off.ctypes.data, 0,
                    None, counts.ctypes.data, None)
    rec_off[1:] = np.cumsum(counts)
    out = np.full((int(rec_off[-1]), 7), 0xDEADBEEF, np.uint32)
    L.mz_chain_host(*[x.ctypes.data for x in ins], R, rec_off.ctypes.data, 0,
                    out.ctypes.data, None, None)
    return out, rec_off


def gap_case():
    """Copy-1 seeds on consecutive occurrences, with 60 dead seeds inside
    a block: counted in the ordinals, they make the drift |d| > 50 that
    ends the block at the next seed (and a reversed read, and one with
    fewer dead seeds, that do not end)."""
    n = 64
    info = np.full(n + 1, 1, np.uint8)
    info[0] = 0
    arange = np.arange(n + 1, dtype=np.uint32)
    ref = FakeRef(arange, arange, np.zeros(n + 1, np.uint32), info)
    reads = [[10, 11] + [0] * 60 + [12, 13, 14, 15, 16],
             [40, 39] + [0] * 60 + [38, 37, 36, 35, 34],
             [20, 21] + [0] * 40 + [22, 23, 24, 25, 26]]
    off = np.concatenate([[0], np.cumsum([len(r) for r in reads])])
    sidx = np.concatenate(reads).astype(np.uint32)
    return ref, sidx, np.arange(len(sidx), dtype=np.int64) * 7, off


def cases():
    yield gap_case()
    yield make_case(1, n_reads=60)
    yield make_case(3, n_reads=60)
    yield bench_case(800, 30, n_mods=20000)


@pytest.mark.parametrize("cap", [1, 3, 8])
def test_chain_kernel_slots_equal_ref(host_libs, cap):
    for ref, sidx, spos, off in cases():
        R = len(off) - 1
        S = int(np.diff(off).max())
        # the slots form's seed offsets are r * S: rows of S seeds
        planes = dense_planes(ref, sidx, spos, off, S)
        flat = [p.reshape(-1) for p in planes]
        flags = ((flat[4].astype(np.uint8) * tchain.IS1)
                 | (flat[5].astype(np.uint8) * tchain.LIVE))
        ins = (flat[:4] + [flags, flat[6], np.ascontiguousarray(
            ref.id, np.uint32), np.arange(R + 1, dtype=np.int64) * S])
        got = host_slots(host_libs["kernel"], ins, R, cap)
        want = tchain.chain_scan_ref(*[t32(x) for x in planes],
                                     t32(np.asarray(ref.id, np.uint32)),
                                     cap=cap)
        assert np.array_equal(got[0], want[0].numpy().view(np.uint32))
        assert np.array_equal(got[1], want[1].numpy())
        assert got[2] == bool(want[2])


def test_chain_kernel_offsets_equal_ref(host_libs):
    for ref, sidx, spos, off in cases():
        ins = csr_inputs(ref, sidx, spos, off)
        out, rec_off = host_offsets(host_libs["kernel"], ins, len(off) - 1)
        want_rec, want_off = tchain.chain_emit_ref(
            *[t32(x) if x.dtype != np.uint8 else torch.from_numpy(x)
              for x in ins], cap=2, tile_reads=64)
        assert np.array_equal(rec_off, want_off.numpy())
        assert np.array_equal(out, want_rec.numpy().view(np.uint32))
        got = [[tuple(r) for r in out[a:b].tolist()]
               for a, b in zip(rec_off[:-1], rec_off[1:])]
        assert got == oracle(ref, sidx, spos, off)


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_chain_kernel_mutants_fail(host_libs, mutant):
    differ = 0
    for ref, sidx, spos, off in cases():
        ins = csr_inputs(ref, sidx, spos, off)
        got = host_offsets(host_libs[mutant], ins, len(off) - 1)
        want = host_offsets(host_libs["kernel"], ins, len(off) - 1)
        differ += not (np.array_equal(got[1], want[1])
                       and np.array_equal(got[0], want[0]))
    assert differ > 0
