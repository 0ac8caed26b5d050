"""Serialization parity for the reference's Array and DICT containers.

arrayWrite (array.c:213-218) dumps the live ArrayStruct header — including
the raw ``char *base`` heap pointer — followed by dim*size payload bytes.
dictWrite (dict.c:90-103) similarly dumps the probe table and the raw
``char **names`` pointer array before the name strings.  The pointer bytes
are ASLR garbage, so even two runs of the reference produce different files;
readers overwrite them.  We write zeros there (deterministic superset) and
reproduce everything meaningful exactly: magic, dim (including the growth
schedule), size, max, payload bytes, and the dict's probe-table layout
(hashString double hashing, dict.c:45-63).
"""

import struct

import numpy as np

ARRAY_MAGIC = 8918274

# struct ArrayStruct: int magic; pad; char* base; int dim,size,max; pad -> 32B
_ARR_HDR = struct.Struct("<i4xQiii4x")


class CArray:
    """Growable array reproducing array.c's dim growth for serialization."""

    def __init__(self, n, itemsize, dtype=None):
        if n < 1:
            n = 1
        self.dim = n
        self.itemsize = itemsize
        self.max = 0
        self.dtype = dtype or np.dtype(f"V{itemsize}")
        self.data = np.zeros(n, self.dtype)

    def _extend(self, n):
        """arrayExtend growth rule (array.c:150-160)."""
        if n < self.dim:
            return
        dim = self.dim
        if dim * self.itemsize < (1 << 23):
            dim *= 2
        else:
            dim += 1024 + ((1 << 23) // self.itemsize)
        if n >= dim:
            dim = n + 1
        new = np.zeros(dim, self.dtype)
        new[:self.dim] = self.data
        self.data = new
        self.dim = dim

    def set(self, i, value):
        """array(a, i, type) = value semantics."""
        if i >= self.max:
            if i >= self.dim:
                self._extend(i)
            self.max = i + 1
        self.data[i] = value

    def get(self, i):
        return self.data[i]

    def write(self, f):
        f.write(_ARR_HDR.pack(ARRAY_MAGIC, 0, self.dim, self.itemsize,
                              self.max))
        f.write(self.data[:self.dim])

    @classmethod
    def read(cls, f, dtype=None):
        hdr = f.read(_ARR_HDR.size)
        magic, _base, dim, size, mx = _ARR_HDR.unpack(hdr)
        a = cls(dim, size, dtype)
        payload = f.read(dim * size)
        a.data = np.frombuffer(payload, a.dtype).copy()
        a.dim = dim
        a.max = mx
        return a

    @classmethod
    def from_values(cls, values, dtype, initial=1024):
        a = cls(initial, np.dtype(dtype).itemsize, np.dtype(dtype))
        for i, v in enumerate(values):
            a.set(i, v)
        return a


def _hash_string(s: bytes, n: int, is_diff: bool) -> int:
    """dict.c:45-63 hashString."""
    rotate = 21 if is_diff else 13
    leftover = 32 - rotate
    x = 0
    for ch in s:
        x = ch ^ (((x >> leftover) | (x << rotate)) & 0xFFFFFFFF)
    j = x
    i = n
    while i < 32:
        j ^= (x >> i)
        i += n
    j &= (1 << n) - 1
    if is_diff:
        j |= 1
    return j


class CDict:
    """String->dense-int interning dict with the reference's exact probe
    layout and growth (dict.c)."""

    def __init__(self, size=1024):
        self.dim = 10
        self.size = 1024
        while self.size < size:
            self.dim += 1
            self.size *= 2
        self.table = np.zeros(self.size, np.int32)
        self.names = [None]  # 1-based
        self.max = 0

    def find(self, s: str):
        b = s.encode("latin1")
        x = _hash_string(b, self.dim, False)
        i = int(self.table[x])
        if not i:
            return None, x
        if self.names[i] == s:
            return i - 1, x
        d = _hash_string(b, self.dim, True)
        while True:
            x = (x + d) & ((1 << self.dim) - 1)
            i = int(self.table[x])
            if not i:
                return None, x
            if self.names[i] == s:
                return i - 1, x

    def add(self, s: str):
        """Returns (id, is_new)."""
        found, pos = self.find(s)
        if found is not None:
            return found, False
        self.max += 1
        i = self.max
        self.table[pos] = i
        self.names.append(s)
        if self.max > 0.3 * self.size:
            self.dim += 1
            self.size *= 2
            new_table = np.zeros(self.size, np.int32)
            for j in range(1, self.max + 1):
                b = self.names[j].encode("latin1")
                x = _hash_string(b, self.dim, False)
                if not new_table[x]:
                    new_table[x] = j
                else:
                    d = _hash_string(b, self.dim, True)
                    while True:
                        x = (x + d) & ((1 << self.dim) - 1)
                        if not new_table[x]:
                            new_table[x] = j
                            break
            self.table = new_table
        return i - 1, True

    def name(self, i: int) -> str:
        return self.names[i + 1]

    def write(self, f):
        f.write(int(self.dim).to_bytes(4, "little"))
        f.write(int(self.max).to_bytes(4, "little"))
        f.write(self.table)
        f.write(b"\x00" * 8 * (self.max + 1))  # raw char* array: zeros
        for i in range(1, self.max + 1):
            b = self.names[i].encode("latin1")
            f.write(len(b).to_bytes(4, "little"))
            f.write(b)

    @classmethod
    def read(cls, f):
        dim = int.from_bytes(f.read(4), "little")
        d = cls(1 << dim)
        d.max = int.from_bytes(f.read(4), "little")
        d.table = np.frombuffer(f.read(4 * d.size), np.int32).copy()
        f.read(8 * (d.max + 1))
        for _ in range(d.max):
            ln = int.from_bytes(f.read(4), "little")
            d.names.append(f.read(ln).decode("latin1"))
        return d
