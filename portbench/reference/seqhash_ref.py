"""Modimizers from first principles (the reference C tool's seqhash.c):

- the hash factors come from glibc's ``srandom(seed)`` and two ``random()``
  draws: ``factor1 = (random() << 32) | random() | 1`` (random() is a C
  long, so the first draw is not masked to 32 bits);
- a k-mer x of 2k bits hashes to ``(x * factor1 mod 2^64) >> (64 - 2k)``;
- each position's canonical k-mer is the forward one when its hash is
  strictly below the reverse complement's, else the reverse complement;
- a position emits when the canonical hash is divisible by w.

``emit_rows`` computes all of that with plain PyTorch integer operations
on whatever device its input lives on; int64 arithmetic wraps as u64 does,
and the logical right shift is an arithmetic shift and a mask.
"""

import numpy as np
import torch


def glibc_random(seed, n):
    """The first n values of glibc's random() after srandom(seed): the
    TYPE_3 additive generator (degree 31, separation 3) seeded by the
    Lehmer generator 16807 x mod (2^31 - 1), its first 310 outputs
    dropped."""
    seed &= 0xFFFFFFFF
    seed = seed or 1
    r = [seed]
    for i in range(1, 31):
        r.append(16807 * r[i - 1] % 2147483647)
    # the additive feedback: o_i = o_{i-31} + o_{i-3} (mod 2^32)
    for i in range(31, 34):
        r.append(r[i - 31])
    for i in range(34, 344 + n):
        r.append((r[i - 31] + r[i - 3]) & 0xFFFFFFFF)
    return [x >> 1 for x in r[344:344 + n]]


def hash_factors(seed):
    """(factor1, factor2) of seqhashCreate(k, w, seed)."""
    a, b, c, d = glibc_random(seed, 4)
    return (((a << 32) | b | 1) & (2 ** 64 - 1),
            ((c << 32) | d | 1) & (2 ** 64 - 1))


def signed64(x):
    """A u64 as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def hash_kmers(x, factor1, k):
    """(x * factor1 mod 2^64) >> (64 - 2k) on an int64 tensor."""
    s = 64 - 2 * k
    return ((x * signed64(factor1)) >> s) & ((1 << (2 * k)) - 1)


def emit_rows(codes, k, w, factor1):
    """The modimizers of each row of ``codes`` ([rows, L] int64 bases
    0..3, one sequence or one segment a row): (row, position, canonical
    k-mer) of every emitting position, in row-major order."""
    rows, L = codes.shape
    P = L - k + 1
    if P <= 0:
        z = torch.zeros(0, dtype=torch.int64, device=codes.device)
        return z, z, z
    fwd = torch.zeros((rows, P), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[:, j:j + P]
        fwd = (fwd << 2) | c
        rc |= (3 - c) << (2 * j)
    hf = hash_kmers(fwd, factor1, k)
    hr = hash_kmers(rc, factor1, k)
    is_f = hf < hr
    emit = torch.where(is_f, hf, hr) % w == 0
    row, pos = emit.nonzero(as_tuple=True)
    return row, pos, torch.where(is_f, fwd, rc)[row, pos]


def emit_reads(reads, k, w, factor1, device, lens=None, block_rows=2048):
    """The modimizers of a read set held as a [n, L] uint8 array, each read
    ``lens[i]`` bases long (all L where ``lens`` is None; the rest of a row
    is padding), in stream order, by blocks of rows on ``device``: numpy
    (read, position in the read, canonical k-mer as u64)."""
    out = [[], [], []]
    for s in range(0, len(reads), block_rows):
        block = reads[s:s + block_rows]
        if lens is not None:
            n = lens[s:s + block_rows]
            block = block[:, :int(n.max())]
        c = torch.from_numpy(np.ascontiguousarray(block)).to(device).long()
        row, pos, km = emit_rows(c, k, w, factor1)
        if lens is not None:                # k-mers inside their read
            keep = pos + k <= torch.from_numpy(n).to(device)[row]
            row, pos, km = row[keep], pos[keep], km[keep]
        out[0].append((row + s).cpu().numpy())
        out[1].append(pos.cpu().numpy())
        out[2].append(km.cpu().numpy().view(np.uint64))
        del c, row, pos, km
    return tuple(np.concatenate(a) for a in out)


def emit_sequence(seq, k, w, factor1, device, block=1 << 24):
    """The modimizers of one long sequence (uint8 codes), in blocks of
    ``block`` positions that overlap by k - 1 bases: numpy (position,
    canonical k-mer as u64)."""
    pos_all, km_all = [], []
    for s in range(0, max(len(seq) - k + 1, 0), block):
        seg = seq[s:s + block + k - 1]
        c = torch.from_numpy(np.ascontiguousarray(seg)).to(device).long()
        _row, pos, km = emit_rows(c[None, :], k, w, factor1)
        pos_all.append((pos + s).cpu().numpy())
        km_all.append(km.cpu().numpy().view(np.uint64))
        del c, pos, km
    if not pos_all:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    return np.concatenate(pos_all), np.concatenate(km_all)


def first_seen(kmers):
    """(distinct k-mers in order of first occurrence, their counts, the
    id of each input row: 1 + the rank of its k-mer in that order)."""
    if len(kmers) == 0:
        z = np.zeros(0, np.int64)
        return kmers[:0], z, z
    uniq, first, inverse, counts = np.unique(
        kmers, return_index=True, return_inverse=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(1, len(order) + 1)
    return uniq[order], counts[order], rank[inverse.ravel()]
