"""Bit-exact reproduction of glibc's srandom()/random() (TYPE_3 generator).

The reference derives its hash factors from the platform PRNG:
``srandom(seed); factor = (random() << 32) | random() | 0x01``
(reference seqhash.c:30-34).  Those factors are persisted inside every .mod/.ref
file, so seed-compatible creation requires reproducing glibc's additive-feedback
generator exactly: a degree-31, separation-3 lagged Fibonacci generator over
int32, seeded by a Lehmer LCG, with the first 310 outputs discarded.
"""


class GlibcRandom:
    """glibc random() with the default 128-byte (TYPE_3) state."""

    DEG = 31
    SEP = 3

    def __init__(self, seed: int):
        seed &= 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * self.DEG
        r[0] = seed
        for i in range(1, self.DEG):
            # r[i] = (16807 * r[i-1]) % 2147483647, via Schrage's trick
            # (glibc stdlib/random_r.c __initstate_r).
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        self._r = r
        self._f = self.SEP
        self._p = 0
        for _ in range(self.DEG * 10):  # glibc discards 10*deg outputs
            self.next()

    def next(self) -> int:
        r = self._r
        f, p = self._f, self._p
        r[f] = (r[f] + r[p]) & 0xFFFFFFFF
        val = (r[f] >> 1) & 0x7FFFFFFF
        self._f = f + 1 if f + 1 < self.DEG else 0
        self._p = p + 1 if p + 1 < self.DEG else 0
        return val

    def seqhash_factor(self) -> int:
        """One 64-bit odd factor: (random() << 32) | random() | 1.

        random() returns a C long (64-bit on LP64), so the first draw lands in
        bits 32..62 unmasked (reference seqhash.c:31,33).
        """
        hi = self.next()
        lo = self.next()
        return ((hi << 32) | lo | 0x01) & 0xFFFFFFFFFFFFFFFF
