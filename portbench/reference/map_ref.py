"""What ``modmap -K k -W w -f ref.fa -q reads.fa`` must produce (the
reference C tool's modmap.c): the reference's table (each distinct
canonical modimizer of the reference in order of first occurrence, its
copy flags from its occurrence count), every query modimizer's id in that
table (0 where absent), and the lines it prints, timing lines left out:
three header lines, then for each read its Q line and the M lines of the
greedy colinear block automaton (modmap.c:188-281), quirks included: an
occurrence index of 0 reads as "no block", a copy-2 seed retries its
second occurrence, and the last block is written only when it holds more
than two copy-2 seeds."""

import numpy as np

from .seqhash_ref import emit_reads, emit_sequence, first_seen, hash_factors


def c_ratio(num, den):
    """C's "%.2f" of num / (double) den, with x86's -nan for 0 / 0."""
    if den == 0:
        return "inf" if num > 0 else "-nan"
    return "%.2f" % (num / den)


def table(ref_seq, k, w, f1, device, kmer_bits=64):
    """(occurrence positions, occurrence ids, distinct k-mers in id order,
    their occurrence counts): the reference's modset as modmap fills it.
    ``kmer_bits`` 32 keys the table by the k-mers' low 32 bits (the
    control)."""
    pos, km = emit_sequence(ref_seq, k, w, f1, device)
    if kmer_bits == 32:
        km = km & np.uint64(0xFFFFFFFF)
    kmers, counts, ids = first_seen(km)
    return pos, ids, kmers, counts


def lookup(kmers, ref_kmers, kmer_bits=64):
    """The id (1 + rank in ``ref_kmers``) of each query k-mer, 0 where
    absent."""
    if kmer_bits == 32:
        kmers = kmers & np.uint64(0xFFFFFFFF)
    order = np.argsort(ref_kmers, kind="stable")
    keys = ref_kmers[order]
    at = np.minimum(np.searchsorted(keys, kmers), max(len(keys) - 1, 0))
    if not len(keys):
        return np.zeros(len(kmers), np.int64)
    hit = keys[at] == kmers
    return np.where(hit, order[at] + 1, 0)


def _as_int32(x):
    """A value mod 2^32 read as a C int."""
    x = x & 0xFFFFFFFF
    return np.where(x >= 1 << 31, x - (1 << 32), x)


def chain(read_off, sidx, info, rev, loc, ids):
    """The block automaton over every read at once, one seed index a
    step: (read, step, i0, iN, loc0, locN, n1, n2) of each M line, in
    output order (the flush after a read's last seed sorts last)."""
    n = len(read_off) - 1
    nseed = np.diff(read_off)
    L = len(rev)
    loc0, locN, i0, iN, n1, n2 = (np.zeros(n, np.int64) for _ in range(6))
    recs = []
    by_len = np.argsort(-nseed, kind="stable")
    lens = nseed[by_len]
    for i in range(int(nseed.max()) if n else 0):
        r = by_len[:np.searchsorted(-lens, -i, side="left")]
        t = read_off[r] + i
        ix = sidx[t]
        ok = (ix != 0) & ((info[ix] & 3) != 3)
        r, ix = r[ok], ix[ok]
        if not len(r):
            continue
        is1 = (info[ix] & 3) == 1
        l0, lN, a0, aN = loc0[r], locN[r], i0[r], iN[r]

        def block_test(lv):
            span = aN - a0
            res = ids[lv] != ids[l0]
            up, down = l0 < lN, l0 > lN
            res |= up & ((lv < lN) | (np.abs(_as_int32(lN - l0 - span)) > 50))
            res |= down & ((lv > lN)
                           | (np.abs(_as_int32(l0 - lN - span)) > 50))
            return res

        lv = rev[np.minimum(loc[ix], L - 1)].astype(np.int64)
        end = (l0 == 0) | block_test(lv)
        retry = end & (l0 != 0) & ~is1
        if retry.any():
            lv = np.where(retry, rev[np.minimum(loc[ix] + 1, L - 1)], lv)
            end = np.where(retry, block_test(lv), end)
        out = end & (n1[r] > 2)
        if out.any():
            ro = r[out]
            recs.append(np.stack([ro, np.full(len(ro), i), i0[ro], iN[ro],
                                  loc0[ro], locN[ro], n1[ro], n2[ro]], 1))
        re = r[end]
        n1[re] = 0
        n2[re] = 0
        loc0[re] = lv[end]
        i0[re] = i
        n1[r[is1]] += 1
        n2[r[~is1]] += 1
        locN[r] = lv
        iN[r] = i
    fin = np.nonzero(n2 > 2)[0]
    recs.append(np.stack([fin, np.full(len(fin), 1 << 40), i0[fin],
                          iN[fin], loc0[fin], locN[fin], n1[fin], n2[fin]],
                         1))
    recs = np.concatenate(recs) if recs else np.zeros((0, 8), np.int64)
    return recs[np.lexsort((recs[:, 1], recs[:, 0]))]


def read_lines(read_off, sidx, spos, info, rev, loc, offs, ids, ref_name,
               qids, qlen):
    """The Q and M lines of every read, in order."""
    n = len(read_off) - 1
    rid = np.repeat(np.arange(n), np.diff(read_off))
    cls = np.where(sidx == 0, 4, info[sidx] & 3)
    counts = np.zeros((n, 5), np.int64)
    np.add.at(counts, (rid, cls), 1)
    recs = chain(read_off, sidx, info, rev, loc, ids)
    lines = []
    j = 0
    for q in range(n):
        c1, c2, cm, miss = counts[q, 1:]
        ns = int(read_off[q + 1] - read_off[q])
        lines.append("Q\t%s\t%d\t%d miss, %d copy1, %d copy2, %d multi, %s hit"
                     % (qids[q], qlen[q], miss, c1, c2, cm,
                        c_ratio(ns - miss, ns)))
        a = read_off[q]
        while j < len(recs) and recs[j, 0] == q:
            _r, _s, b0, bN, l0, lN, m1, m2 = (int(x) for x in recs[j])
            p0, pN = int(spos[a + b0]), int(spos[a + bN])
            lines.append("M\t%s\t%d\t%d\t%d\t%s\t%d\t%d\t%d %d\t%s\t%s"
                         % (qids[q], p0, pN, pN - p0, ref_name,
                            offs[l0], offs[lN], m1, m2,
                            c_ratio(m1 + m2, abs(lN - l0)), c_ratio(m1, c1)))
            j += 1
    return lines


def modmap(ref_seq, reads, cfg, device, kmer_bits=64):
    """The expected table, lookups and text of one modmap job: the
    reference sequence ``ref_seq`` (uint8 codes) named cfg["genome_name"],
    the queries ``reads`` ([n, L] uint8 codes) named r0, r1, ...
    ``kmer_bits`` 32 computes the control: the table and the lookup keyed
    by the k-mers' low 32 bits."""
    k, w, seed = cfg["k"], cfg["w"], cfg["hash_seed"]
    f1, _f2 = hash_factors(seed)
    opos, oid, ref_kmers, counts = table(ref_seq, k, w, f1, device,
                                         kmer_bits)
    nm = len(ref_kmers)
    info = np.zeros(nm + 1, np.uint8)
    info[1:] = np.select([counts == 1, counts == 2], [1, 2], 3)
    depth = np.zeros(nm + 1, np.int64)
    depth[1:] = counts
    loc = np.zeros(nm + 1, np.int64)
    loc[1:] = np.cumsum(depth[:nm])
    rev = np.argsort(oid, kind="stable")
    ids = np.zeros(len(oid), np.int64)      # one reference sequence
    qread, qpos, qkm = emit_reads(reads, k, w, f1, device)
    sidx = lookup(qkm, ref_kmers, kmer_bits)
    n, L = reads.shape
    read_off = np.searchsorted(qread, np.arange(n + 1))
    lines = ["  modmap initialised with k = %d, w = %d, random seed = %d"
             % (k, w, seed),
             "  %d hashes from 1 reference sequences, total length %d"
             % (len(oid), len(ref_seq)),
             "  %d copy 1, %d copy 2, %d multiple"
             % ((counts == 1).sum(), (counts == 2).sum(), (counts > 2).sum())]
    lines += read_lines(read_off, sidx, qpos, info, rev, loc, opos, ids,
                        cfg["genome_name"], ["r%d" % i for i in range(n)],
                        np.full(n, L))
    return {"kmers": ref_kmers, "info": info[1:], "read": qread, "pos": qpos,
            "sidx": sidx, "lines": lines, "bases": n * L,
            "ref_bases": len(ref_seq), "ref_rows": len(oid),
            "query_rows": len(qkm), "keys": nm,
            "hits": int((sidx != 0).sum())}
