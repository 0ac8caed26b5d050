"""Seqhash: multiplicative canonical k-mer hash parameters + host-side scan.

Semantics (reference seqhash.h:15-60, seqhash.c:20-196):

- params: k in [1,31], w (window size for minimizers / divisor d for modimizers),
  seed; ``factor1/factor2`` are seed-derived odd 64-bit numbers via glibc
  ``random()`` (seqhash.c:30-34); ``mask = (1 << 2k) - 1``; shift1 = 64-2k.
- hash of a 2k-bit kmer x: ``(x * factor1) mod 2^64 >> shift1`` (seqhash.h:58).
- a rolling scan keeps the forward kmer h and its reverse complement hRC;
  the canonical hash is min(hash(h), hash(hRC)) with a direction flag
  (seqhash.c:60-79).
- the *modimizer* iterator emits, in position order, every kmer whose canonical
  hash is divisible by w, returning the canonical kmer (not the hash)
  (seqhash.c:154-196).

This module holds the parameter object, its byte-exact 80-byte struct
serialization (``SQHSHv2``, raw struct dump at seqhash.c:41-53, x86-64 layout),
and a vectorized numpy scan used by the host pipeline and as the oracle for the
device kernels in ops/seqhash.py.
"""

import struct
from dataclasses import dataclass, field

import numpy as np

from ..utils.glibc_random import GlibcRandom

U64 = np.uint64

# struct Seqhash on LP64: int seed,k,w; pad; U64 mask; int shift1,shift2;
# U64 factor1,factor2; U64 patternRC[4]  -> 80 bytes (seqhash.h:15-23)
_STRUCT = struct.Struct("<iii4xQiiQQ4Q")
MAGIC = b"SQHSHv2\x00"


@dataclass
class Seqhash:
    k: int
    w: int
    seed: int
    mask: int = 0
    shift1: int = 0
    shift2: int = 0
    factor1: int = 0
    factor2: int = 0
    patternRC: tuple = field(default=None)

    @classmethod
    def create(cls, k: int, w: int, seed: int) -> "Seqhash":
        """Equivalent of seqhashCreate (seqhash.c:20-37)."""
        if k < 1 or k >= 32:
            raise ValueError(f"seqhash k {k} must be between 1 and 32")
        if w < 1:
            raise ValueError(f"seqhash w {w} must be positive")
        rng = GlibcRandom(seed)
        sh = cls(k=k, w=w, seed=seed)
        sh.mask = (1 << (2 * k)) - 1
        sh.factor1 = rng.seqhash_factor()
        sh.shift1 = 64 - 2 * k
        sh.factor2 = rng.seqhash_factor()
        sh.shift2 = 2 * k
        sh.patternRC = tuple((3 - i) << (2 * (k - 1)) for i in range(4))
        return sh

    # ---------- serialization (byte-exact vs the C struct dump) ----------

    def to_bytes(self) -> bytes:
        return _STRUCT.pack(
            self.seed, self.k, self.w, self.mask, self.shift1, self.shift2,
            self.factor1, self.factor2, *self.patternRC)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "Seqhash":
        (seed, k, w, mask, s1, s2, f1, f2, p0, p1, p2, p3) = _STRUCT.unpack(buf)
        return cls(k=k, w=w, seed=seed, mask=mask, shift1=s1, shift2=s2,
                   factor1=f1, factor2=f2, patternRC=(p0, p1, p2, p3))

    def write(self, f) -> None:
        f.write(MAGIC)
        f.write(self.to_bytes())

    @classmethod
    def read(cls, f) -> "Seqhash":
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(f"seqhash read mismatch: {magic!r}")
        return cls.from_bytes(f.read(_STRUCT.size))

    def report(self) -> str:
        return "SH k %d  w/m %d  s %d\n" % (self.k, self.w, self.seed)

    # ---------- hashing ----------

    def hash_kmers(self, kmers: np.ndarray) -> np.ndarray:
        """seqhash(sh, kmer) = (kmer * factor1) >> shift1 (seqhash.h:58)."""
        with np.errstate(over="ignore"):
            return (kmers.astype(U64) * U64(self.factor1)) >> U64(self.shift1)

    def scan(self, codes: np.ndarray):
        """All-positions canonical scan of one sequence of base codes (0..3).

        Returns (kmers u64[P], hashes u64[P], isF bool[P]) for every kmer
        position P = len-k+1 (empty arrays if len < k).  Matches the rolling
        h/hRC recurrence of seqhash.c:70-79 evaluated at every position.
        """
        k = self.k
        codes = np.asarray(codes, dtype=np.uint8)
        n = len(codes)
        if n < k:
            z = np.zeros(0, U64)
            return z, z.copy(), np.zeros(0, bool)
        P = n - k + 1
        c = codes.astype(U64)
        h = np.zeros(P, U64)
        hrc = np.zeros(P, U64)
        three = U64(3)
        for j in range(k):
            h = (h << U64(2)) | c[j:j + P]
            hrc |= (three - c[j:j + P]) << U64(2 * j)
        hf = self.hash_kmers(h)
        hr = self.hash_kmers(hrc)
        isF = hf < hr
        hashes = np.where(isF, hf, hr)
        kmers = np.where(isF, h, hrc)
        return kmers, hashes, isF

    def modimizers(self, codes: np.ndarray):
        """Modimizer emission for one sequence: (kmers, pos, isF) in position
        order, for positions where canonical hash % w == 0 (seqhash.c:154-196)."""
        kmers, hashes, isF = self.scan(codes)
        sel = (hashes % U64(self.w)) == U64(0)
        pos = np.nonzero(sel)[0].astype(np.int32)
        return kmers[sel], pos, isF[sel]

    def kmer_text(self, kmer: int, length: int = None) -> str:
        """seqString: kmer -> lowercase acgt text (seqhash.c:198-206)."""
        length = self.k if length is None else length
        trans = "acgt"
        out = [""] * length
        kmer = int(kmer)
        for i in range(length - 1, -1, -1):
            out[i] = trans[kmer & 0x3]
            kmer >>= 2
        return "".join(out)

    def kmer_from_text(self, s: str) -> int:
        conv = {"a": 0, "c": 1, "g": 2, "t": 3, "A": 0, "C": 1, "G": 2, "T": 3}
        x = 0
        for ch in s:
            x = (x << 2) | conv.get(ch, 0)
        return x
