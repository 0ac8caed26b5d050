"""The plain reference against brute-force Python loops on tiny inputs,
and against the port's own copies where the port has one."""

import numpy as np
import pytest
import torch

from reference import map_ref
from reference.seqhash_ref import (emit_reads, emit_sequence, first_seen,
                                   glibc_random, hash_factors)


def brute_modimizers(seq, k, w, f1):
    """seqhash.c literally: a rolling forward and reverse-complement
    k-mer, the smaller hash wins (forward only when strictly smaller)."""
    out = []
    mask = (1 << 2 * k) - 1
    for p in range(len(seq) - k + 1):
        x = y = 0
        for j in range(k):
            x = (x << 2) | int(seq[p + j])
            y |= (3 - int(seq[p + j])) << (2 * j)
        hx = ((x * f1) & (2 ** 64 - 1)) >> (64 - 2 * k)
        hy = ((y * f1) & (2 ** 64 - 1)) >> (64 - 2 * k)
        h, km = (hx, x) if hx < hy else (hy, y)
        assert km <= mask
        if h % w == 0:
            out.append((p, km))
    return out


def test_glibc_random_matches_the_ports_copy():
    from modimizer_tpu_torch.utils.glibc_random import GlibcRandom
    for seed in (1, 17, 12345, 2 ** 31 - 5):
        g = GlibcRandom(seed)
        assert glibc_random(seed, 8) == [g.next() for _ in range(8)]


@pytest.mark.parametrize("seed", [17, 3, 99])
def test_hash_factors_match_the_ports_seqhash(seed):
    from modimizer_tpu_torch.core.seqhash import Seqhash
    sh = Seqhash.create(19, 31, seed)
    assert hash_factors(seed) == (sh.factor1, sh.factor2)


@pytest.mark.parametrize("k,w", [(19, 31), (24, 31), (5, 3), (31, 7),
                                 (16, 1)])
def test_emit_sequence_is_the_brute_force(k, w):
    rng = np.random.default_rng(k * 100 + w)
    seq = rng.integers(0, 4, 700, dtype=np.uint8)
    f1, _ = hash_factors(17)
    pos, km = emit_sequence(seq, k, w, f1, "cpu", block=97)
    want = brute_modimizers(seq, k, w, f1)
    assert [(int(p), int(x)) for p, x in zip(pos, km)] == want


def test_emit_reads_is_per_read_and_in_stream_order():
    rng = np.random.default_rng(5)
    reads = rng.integers(0, 4, (7, 300), dtype=np.uint8)
    f1, _ = hash_factors(17)
    rid, pos, km = emit_reads(reads, 19, 5, f1, "cpu", block_rows=3)
    want = [(r, p, x) for r in range(7)
            for p, x in brute_modimizers(reads[r], 19, 5, f1)]
    assert list(zip(rid.tolist(), pos.tolist(), km.tolist())) == want


def test_first_seen_orders_by_first_occurrence():
    km = np.array([5, 3, 5, 9, 3, 3], np.uint64)
    kmers, counts, ids = first_seen(km)
    assert kmers.tolist() == [5, 3, 9]
    assert counts.tolist() == [2, 3, 1]
    assert ids.tolist() == [1, 2, 1, 3, 2, 2]


def test_lookup_is_the_brute_force():
    rng = np.random.default_rng(2)
    table = rng.permutation(50)[:20].astype(np.uint64)
    q = rng.integers(0, 50, 200).astype(np.uint64)
    got = map_ref.lookup(q, table)
    pos = {int(x): i + 1 for i, x in enumerate(table)}
    assert got.tolist() == [pos.get(int(x), 0) for x in q]
    # 32-bit keys (the control's table holds them so): two k-mers that
    # share their low 32 bits collide
    keys32 = np.array([7], np.uint64)
    q = np.array([(1 << 40) | 7], np.uint64)
    assert map_ref.lookup(q, keys32, 32).tolist() == [1]
    assert map_ref.lookup(q, keys32).tolist() == [0]


def literal_chain(read_off, sidx, info, rev, loc, ids):
    """modmap.c:216-280 one read and one seed at a time (the port's smoke
    run's chain_oracle): each M record (read, i0, iN, loc0, locN, n1,
    n2)."""
    L = len(rev)
    out = []
    for rd in range(len(read_off) - 1):
        loc0 = locN = i0 = iN = n1 = n2 = 0
        a = read_off[rd]
        for i in range(read_off[rd + 1] - a):
            ix = sidx[a + i]
            if ix == 0 or info[ix] & 3 == 3:
                continue
            lv = int(rev[min(loc[ix], L - 1)])
            is1 = info[ix] & 3 == 1

            def block_test(lv):
                if ids[lv] != ids[loc0]:
                    return True
                if loc0 < locN:
                    d = (locN - loc0 - (iN - i0)) & 0xFFFFFFFF
                    d = d - (1 << 32) if d >= 1 << 31 else d
                    return lv < locN or d > 50 or d < -50
                if loc0 > locN:
                    d = (loc0 - locN - (iN - i0)) & 0xFFFFFFFF
                    d = d - (1 << 32) if d >= 1 << 31 else d
                    return lv > locN or d > 50 or d < -50
                return False

            end = loc0 == 0 or block_test(lv)
            if end and loc0 and not is1:
                lv = int(rev[min(loc[ix] + 1, L - 1)])
                end = block_test(lv)
            if end:
                if n1 > 2:
                    out.append((rd, i0, iN, loc0, locN, n1, n2))
                n1 = n2 = 0
                loc0, i0 = lv, i
            if is1:
                n1 += 1
            else:
                n2 += 1
            locN, iN = lv, i
        if n2 > 2:
            out.append((rd, i0, iN, loc0, locN, n1, n2))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_vectorised_chain_is_the_literal_automaton(seed):
    """Seeds that walk the reference forwards and backwards with jumps,
    misses, repeats and two sequences, so that blocks end every way."""
    rng = np.random.default_rng(seed)
    n_occ, nm = 400, 150
    oid = rng.integers(1, nm + 1, n_occ)
    counts = np.bincount(oid, minlength=nm + 1)
    info = np.where(counts == 1, 1, np.where(counts == 2, 2, 3)).astype(
        np.uint8)
    info[0] = 0
    loc = np.zeros(nm + 1, np.int64)
    loc[1:] = np.cumsum(counts[:nm])
    rev = np.argsort(oid, kind="stable")
    ids = (np.arange(n_occ) >= n_occ // 2).astype(np.int64)
    nseed = rng.integers(0, 60, 30)
    read_off = np.concatenate([[0], np.cumsum(nseed)])
    sidx = []
    for n in nseed:
        start, step = rng.integers(0, n_occ), rng.choice([-1, 1])
        walk = (start + step * np.arange(n)
                + rng.integers(-3, 4, n) * (rng.random(n) < 0.2)) % n_occ
        s = oid[walk]
        s[rng.random(n) < 0.15] = 0
        sidx.append(s)
    sidx = np.concatenate(sidx).astype(np.int64)
    got = map_ref.chain(read_off, sidx, info, rev, loc, ids)
    want = literal_chain(read_off, sidx, info, rev, loc, ids)
    assert len(want) > 5
    assert [tuple(int(x) for x in (r[0],) + tuple(r[2:])) for r in got] \
        == want


def test_c_ratio_prints_as_c_does():
    assert map_ref.c_ratio(1, 3) == "0.33"
    assert map_ref.c_ratio(2, 0) == "inf"
    assert map_ref.c_ratio(0, 0) == "-nan"
