"""The binary modset file (MSHSTv2) of a table, written from first
principles (the reference C tool's modset.c ``modsetWrite`` and
seqhash.c ``seqhashWrite``), as ``modutils ... -w X.mod`` writes it:

- "MSHSTv2\\0", the table bits (int32), size = entries + 1 (int32);
- "SQHSHv2\\0" and the 80-byte Seqhash struct of x86-64: int seed, k, w,
  4 bytes of padding, u64 mask, int shift1, shift2, u64 factor1,
  factor2, u64 patternRC[4];
- the index: 2^bits u32 slots, entry i (1-based, in id order) at the
  first free slot of its probe walk, start ``hash & mask``, step
  ``((hash >> bits) & mask) | 1``, hash = (k-mer * factor1 mod 2^64) >>
  (64 - 2k), the entries placed in id order;
- value (u64), depth (u16) and info (u8) of entries 0..size-1, entry 0
  all zero;
- all of it gzip-framed (fzopen).
"""

import gzip
import struct

import numpy as np

from .seqhash_ref import hash_factors

MAGIC = b"MSHSTv2\x00"
SQHSH = b"SQHSHv2\x00"
_SEQHASH = struct.Struct("<iii4xQiiQQ4Q")


def seqhash_record(k, w, seed):
    """The 80-byte Seqhash struct of seqhashCreate(k, w, seed)."""
    f1, f2 = hash_factors(seed)
    return _SEQHASH.pack(seed, k, w, (1 << (2 * k)) - 1, 64 - 2 * k, 2 * k,
                         f1, f2, *((3 - i) << (2 * (k - 1))
                                   for i in range(4)))


def probe_index(kmers, k, seed, bits):
    """The 2^bits u32 index of entries 1..len(kmers) (distinct u64 k-mers
    in id order), each inserted in turn at the first free slot of its
    probe walk."""
    f1, _f2 = hash_factors(seed)
    mask = (1 << bits) - 1
    with np.errstate(over="ignore"):
        h = (np.asarray(kmers, np.uint64) * np.uint64(f1)) \
            >> np.uint64(64 - 2 * k)
    start = (h & np.uint64(mask)).tolist()
    step = (((h >> np.uint64(bits)) & np.uint64(mask))
            | np.uint64(1)).tolist()
    if len(start) >= (1 << bits) >> 2:
        raise ValueError("%d entries do not fit a table of %d bits"
                         % (len(start), bits))
    taken = set()
    slots = np.empty(len(start), np.int64)
    for i, o in enumerate(start):
        while o in taken:
            o = (o + step[i]) & mask
        taken.add(o)
        slots[i] = o
    index = np.zeros(1 << bits, np.uint32)
    index[slots] = np.arange(1, len(start) + 1, dtype=np.uint32)
    return index


def modset_bytes(kmers, depth, info, k, w, seed, bits):
    """The uncompressed MSHSTv2 stream of a table, as a list of buffers."""
    n = len(kmers)
    col = [np.zeros(n + 1, np.uint64), np.zeros(n + 1, np.uint16),
           np.zeros(n + 1, np.uint8)]
    for c, v in zip(col, (kmers, depth, info)):
        c[1:] = v
    return [MAGIC, struct.pack("<ii", bits, n + 1), SQHSH,
            seqhash_record(k, w, seed), probe_index(kmers, k, seed, bits),
            *col]


def write_modset(path, kmers, depth, info, k, w, seed, bits):
    """Write the table (k-mers, depths and copy flags of entries 1..n in id
    order) as a gzip-framed .mod file."""
    with gzip.GzipFile(path, "wb", compresslevel=1, mtime=0) as f:
        for part in modset_bytes(kmers, depth, info, k, w, seed, bits):
            f.write(memoryview(part).cast("B") if isinstance(part, np.ndarray)
                    else part)
