"""Modset: the k-mer set/dictionary with depth and copy-number annotation.

Host-canonical representation of the reference's Modset (modset.h:17-28):
an open-addressed probe table ``index`` (2^tableBits u32 slots) over dense
side arrays ``value`` (u64 kmer), ``depth`` (saturating u16), ``info`` (u8
flag bits), entries 1..max in *first-encounter order*.  The probe layout and
ids are part of the on-disk format (the entire table is serialized,
modset.c:79-104), so construction replays insertions exactly via the native
C++ runtime (native/modset_native.cpp); the heavy k-mer production runs on
TPU (ops/seqhash.py) and feeds batches here.

info bits (modset.h:44-69): bits 0-1 copy number {0,1,2,M}; 4=MINOR,
8=REPEAT, 0x10=INTERNAL, 0x20=RDNA.
"""

import sys

import numpy as np

from .seqhash import Seqhash
from ..native import lib as native_lib
from ..utils.errors import ModsetOverflowError
from ..utils import alloc, profiling
from ..io.fzio import GzWriter, read_maybe_gz

MAGIC = b"MSHSTv2\x00"

MS_MINOR = 4
MS_REPEAT = 8
MS_INTERNAL = 0x10
MS_RDNA = 0x20


class Modset:
    def __init__(self, hasher: Seqhash, bits: int, size: int = 0):
        """modsetCreate (modset.c:15-31)."""
        if bits < 20 or bits > 34:
            raise ValueError(f"table bits {bits} must be between 20 and 34")
        self.hasher = hasher
        self.table_bits = bits
        self.table_size = 1 << bits
        self.table_mask = self.table_size - 1
        if size >= (self.table_size >> 2):
            raise ValueError(f"Modset size {size} is too big for {bits} bits")
        self.size = size if size else (self.table_size >> 2) - 1
        self.index = np.zeros(self.table_size, np.uint32)
        self.value = np.zeros(self.size, np.uint64)
        self.depth = np.zeros(self.size, np.uint16)
        self.info = np.zeros(self.size, np.uint8)
        self.max = 0
        alloc.add(self.index.nbytes + self.value.nbytes
                  + self.depth.nbytes + self.info.nbytes)

    # ---------------- core lookup/insert ----------------

    def find_batch(self, kmers: np.ndarray) -> np.ndarray:
        """Vectorized modsetIndexFind(..., isAdd=false): 0 where absent."""
        kmers = np.ascontiguousarray(kmers, np.uint64)
        out = np.empty(len(kmers), np.uint32)
        if len(kmers):
            native_lib().ms_find_batch(
                self.index, self.value, self.table_bits,
                self.hasher.factor1, self.hasher.shift1,
                kmers, len(kmers), out)
        return out

    def add_batch(self, kmers: np.ndarray, counts: np.ndarray = None,
                  return_indices: bool = False):
        """Replay insertions in stream order with saturating depth add.

        ``kmers`` must be in first-encounter stream order for id parity
        (modset.c:56-59: index = ++max).  counts=None means 1 each.
        With return_indices=True also returns the table index per kmer.
        """
        kmers = np.ascontiguousarray(kmers, np.uint64)
        out_idx = np.empty(len(kmers), np.uint32) if return_indices else None
        if len(kmers) == 0:
            return out_idx if return_indices else None
        if counts is None:
            counts_ptr = None
        else:
            counts = np.ascontiguousarray(counts, np.uint32)
            counts_ptr = counts.ctypes.data
        new_max = native_lib().ms_insert_batch(
            self.index, self.value, self.depth, self.info,
            self.table_bits, self.hasher.factor1, self.hasher.shift1,
            self.max, self.size, kmers, counts_ptr, len(kmers),
            out_idx.ctypes.data if return_indices else None)
        if new_max < 0:
            # the reference dies from inside the insert (modset.c:58)
            # with max == size at first overflow; the library raises and
            # the CLI layer (cli_guard) dies with the identical message
            raise ModsetOverflowError(
                "hashTableSize %u is too small for %u"
                % (self.size, self.size))
        self.max = int(new_max)
        return out_idx if return_indices else None

    # ---------------- whole-set operations ----------------

    def pack(self) -> bool:
        """modsetPack (modset.c:36-43): shrink side arrays to max+1."""
        if self.size == self.max + 1:
            return False
        n = self.max + 1
        self.value = np.ascontiguousarray(self.value[:n]) if n <= len(self.value) \
            else np.concatenate([self.value, np.zeros(n - len(self.value), np.uint64)])
        self.depth = np.ascontiguousarray(self.depth[:n]) if n <= len(self.depth) \
            else np.concatenate([self.depth, np.zeros(n - len(self.depth), np.uint16)])
        self.info = np.ascontiguousarray(self.info[:n]) if n <= len(self.info) \
            else np.concatenate([self.info, np.zeros(n - len(self.info), np.uint8)])
        self.size = n
        alloc.add(self.value.nbytes + self.depth.nbytes + self.info.nbytes)
        return True

    def depth_prune(self, dmin: int, dmax: int) -> None:
        """modsetDepthPrune (modset.c:64-77): keep dmin <= depth (< dmax)."""
        N = self.max
        d = self.depth[1:N + 1]
        keep = d >= dmin
        if dmax:
            keep &= d < dmax
        kept = np.nonzero(keep)[0] + 1
        n = len(kept)
        self.value[1:n + 1] = self.value[kept]
        self.depth[1:n + 1] = self.depth[kept]
        self.info[1:n + 1] = self.info[kept]
        self.max = n
        r = native_lib().ms_rebuild_table(
            self.index, self.value, self.table_bits,
            self.hasher.factor1, self.hasher.shift1, n)
        if r < 0:
            raise RuntimeError("duplicate kmer during prune rebuild")
        sys.stderr.write(
            "  pruned Modset from %d to %d with min %d <= depth < max %d\n"
            % (N, self.max, dmin, dmax))

    def merge(self, other: "Modset") -> bool:
        """modsetMerge (modset.c:106-128): union with saturating depth add and
        the reference's quirky copy update (old_copy | min(c1+c2,3), flag bits
        of merged-into entries cleared)."""
        sh1, sh2 = self.hasher, other.hasher
        if sh1.w != sh2.w or sh1.k != sh2.k or sh1.factor1 != sh2.factor1:
            return False
        new_size = self.max + other.max + 1
        if new_size >= (self.table_size >> 2):
            new_size = (self.table_size >> 2) - 1
        if new_size > self.size:
            grow = new_size - self.size
            self.value = np.concatenate([self.value, np.zeros(grow, np.uint64)])
            self.depth = np.concatenate([self.depth, np.zeros(grow, np.uint16)])
            self.info = np.concatenate([self.info, np.zeros(grow, np.uint8)])
        else:
            self.value = self.value[:new_size].copy()
            self.depth = self.depth[:new_size].copy()
            self.info = self.info[:new_size].copy()
        self.size = new_size
        alloc.add(self.value.nbytes + self.depth.nbytes + self.info.nbytes)
        n = other.max
        if n:
            new_max = native_lib().ms_merge_batch(
                self.index, self.value, self.depth, self.info,
                self.table_bits, self.hasher.factor1, self.hasher.shift1,
                self.max, self.size,
                np.ascontiguousarray(other.value[1:n + 1], np.uint64),
                np.ascontiguousarray(other.depth[1:n + 1], np.uint16),
                np.ascontiguousarray(other.info[1:n + 1], np.uint8), n)
            if new_max < 0:
                raise ModsetOverflowError(       # modset.c:58, via merge
                    "hashTableSize %u is too small for %u"
                    % (self.size, self.size))
            self.max = int(new_max)
        return True

    # ---------------- info-bit helpers (vectorized) ----------------

    def copy_num(self, idx) -> np.ndarray:
        return self.info[idx] & 3

    def set_copy(self, idx, c: int) -> None:
        if c == 3:
            self.info[idx] |= 3
        else:
            self.info[idx] = (self.info[idx] & 0xFC) | c

    def set_copy_thresholds(self, copy1min: int, copy2min: int,
                            copyMmin: int) -> None:
        """modutils -s (modutils.c:205-213)."""
        with profiling.span("mod.copy"):
            d = self.depth[1:self.max + 1]
            info = self.info[1:self.max + 1]
            c0 = d < copy1min
            c1 = ~c0 & (d < copy2min)
            c2 = ~c0 & ~c1 & (d < copyMmin)
            cM = ~c0 & ~c1 & ~c2
            info[c0] &= 0xFC
            info[c1] = (info[c1] & 0xFC) | 1
            info[c2] = (info[c2] & 0xFC) | 2
            info[cM] |= 3

    def set_copyM_threshold(self, copyMmin: int) -> None:
        """modutils -sM (modutils.c:215-218)."""
        sel = self.depth[1:self.max + 1] >= copyMmin
        info = self.info[1:self.max + 1]
        info[sel] |= 3

    # ---------------- reporting ----------------

    def depth_histogram(self) -> np.ndarray:
        if self.max == 0:
            return np.zeros(0, np.uint32)
        d = self.depth[1:self.max + 1]
        from ..native import u16_hist
        h = u16_hist(d, int(d.max()) + 1)
        return h.astype(np.uint32)

    def summary(self, f) -> None:
        """modsetSummary, exact text (modset.c:130-153)."""
        with profiling.span("mod.summary"):
            self._summary(f)

    def _summary(self, f):
        f.write(self.hasher.report())
        f.write("MS table bits %d size %d number of entries %d"
                % (self.table_bits, self.table_size, self.max))
        if not self.max:
            f.write("\n")
            return
        h = self.depth_histogram()
        copy = np.bincount(self.copy_num(np.arange(1, self.max + 1)),
                           minlength=4)
        idx = np.arange(len(h), dtype=np.uint64)
        s = int(h.sum())
        tot = int((idx * h).sum())
        htot = tot // 2
        i = len(h)
        cum = 0
        for j in range(len(h)):
            cum += j * int(h[j])
            if htot - cum < 0:
                i = j
                break
        f.write(" total count %d\nMS average depth %.1f N50 depth %d"
                % (tot, tot / s, i))
        if copy[0] < self.max:
            f.write(" copy0 %d copy1 %d copy2 %d copyM %d"
                    % (copy[0], copy[1], copy[2], copy[3]))
        f.write("\n")

    # ---------------- binary serialization (byte-exact) ----------------

    def to_bytes(self) -> bytes:
        """Raw MSHSTv2 stream (modset.c:79-88); caller applies gzip framing."""
        parts = [MAGIC,
                 int(self.table_bits).to_bytes(4, "little"),
                 int(self.max + 1).to_bytes(4, "little"),
                 b"SQHSHv2\x00", self.hasher.to_bytes(),
                 self.index.tobytes(),
                 self.value[:self.max + 1].tobytes(),
                 self.depth[:self.max + 1].tobytes(),
                 self.info[:self.max + 1].tobytes()]
        return b"".join(parts)

    def write(self, path_or_file) -> None:
        """modutils-compatible write: gzip framing as fzopen does."""
        with GzWriter(path_or_file) as w:
            w.write(MAGIC)
            w.write(int(self.table_bits).to_bytes(4, "little"))
            w.write(int(self.max + 1).to_bytes(4, "little"))
            w.write(b"SQHSHv2\x00")
            w.write(self.hasher.to_bytes())
            # contiguous 1-D slices pass to GzWriter as views (no tobytes
            # copy — these are the multi-hundred-MB payloads)
            w.write(self.index)
            w.write(self.value[:self.max + 1])
            w.write(self.depth[:self.max + 1])
            w.write(self.info[:self.max + 1])

    @classmethod
    def from_bytes(cls, data: bytes) -> "Modset":
        off = 0
        if data[off:off + 8] != MAGIC:
            raise ValueError(f"bad modset header {data[:8]!r} != MSHSTv2")
        off += 8
        bits = int.from_bytes(data[off:off + 4], "little"); off += 4
        size = int.from_bytes(data[off:off + 4], "little"); off += 4
        if data[off:off + 8] != b"SQHSHv2\x00":
            raise ValueError("seqhash read mismatch")
        off += 8
        sh = Seqhash.from_bytes(data[off:off + 80]); off += 80
        ms = cls.__new__(cls)
        # skip __init__'s zero-filled allocations (268MB for bits=26) —
        # every field is about to be overwritten from the file
        ms.hasher = sh
        ms.table_bits = bits
        ms.table_size = 1 << bits
        ms.table_mask = ms.table_size - 1
        ms.size = size if size else (ms.table_size >> 2) - 1
        ts = ms.table_size
        # one writable copy of the whole payload instead of four .copy()s
        # (read_maybe_gz already hands us a bytearray, making this free)
        buf = bytearray(data) if not isinstance(data, bytearray) else data
        ms.index = np.frombuffer(buf, np.uint32, ts, off); off += 4 * ts
        ms.value = np.frombuffer(buf, np.uint64, size, off); off += 8 * size
        ms.depth = np.frombuffer(buf, np.uint16, size, off); off += 2 * size
        ms.info = np.frombuffer(buf, np.uint8, size, off); off += size
        alloc.add(4 * ts + 11 * size)
        ms.max = size - 1
        return ms

    @classmethod
    def read(cls, path) -> "Modset":
        return cls.from_bytes(read_maybe_gz(path))

    # ---------------- text serialization ----------------

    def write_text(self, f) -> None:
        """modutils -wt (modutils.c:191-200)."""
        sh = self.hasher
        f.write("modset bits %d size %d k %d w %d seed %d\n"
                % (self.table_bits, self.max + 1, sh.k, sh.w, sh.seed))
        for i in range(1, self.max + 1):
            f.write("%d\t%s\t%d\t%d\n"
                    % (i, sh.kmer_text(int(self.value[i])),
                       self.depth[i], self.info[i]))

    @classmethod
    def read_text(cls, f) -> "Modset":
        """modutils -rt (modutils.c:169-190)."""
        import re
        hdr = f.readline()
        m = re.match(r"modset bits (\d+) size (\d+) k (\d+) w (\d+) seed (-?\d+)",
                     hdr)
        if not m:
            raise ValueError("failed to read first line of text file")
        bits, size, k, w, seed = map(int, m.groups())
        sh = Seqhash.create(k, w, seed)
        ms = cls(sh, bits, size)
        kmers, depths, infos = [], [], []
        for _ in range(size - 1):
            line = f.readline()
            _i, s, depth, info = line.rstrip("\n").split("\t")
            kmers.append(sh.kmer_from_text(s))
            depths.append(int(depth))
            infos.append(int(info))
        ms.add_batch(np.array(kmers, np.uint64), np.zeros(len(kmers), np.uint32))
        ms.depth[1:ms.max + 1] = np.array(depths, np.uint16)
        ms.info[1:ms.max + 1] = np.array(infos, np.uint8)
        return ms
