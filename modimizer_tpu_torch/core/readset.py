"""Readset: modasm's long-read hit-list structure (reference: modasm.c:31-287).

Port of ``modimizer_tpu/core/readset.py``.  Where the reference keeps one
malloc'd hit/dx list per read (modasm.c:34-35,180-183), the readset is flat
CSR arrays — ``hits``/``dx`` with ``hit_off`` row offsets — built in one
scan over the packed read stream by the port's scanner on the given device
(ops/seqhash.ModimizerScanner) plus one vectorized table lookup, instead of
a per-read rolling-iterator loop.  The inverse map (mod -> reads,
modasm.c:258-287) is the same CSR trick transposed.  ``device`` is the
device the scan ran on (None after the native host scan or a ``read``):
the overlap self-join runs there.

The irregular per-read analyses (overlaps, triage, assembly walks) run in the
native C++ runtime (native/modasm_native.cpp) over these same buffers; this
module owns the memory, the build, the stats report and the RSMSHv2
persistence (byte-exact; modasm.c:110-149).
"""

import ctypes

import numpy as np

from ..io.carray import ARRAY_MAGIC, _ARR_HDR
from ..utils import alloc, profiling
from ..native import lib as native_lib, RSView
from ..ops.seqhash import ModimizerScanner
from .modset import Modset

MAGIC = b"RSMSHv2\x00"
TOPBIT = np.uint32(0x80000000)
TOPMASK = np.uint32(0x7FFFFFFF)
U16MAX = 0xFFFF

# on-disk Read record (modasm.c:31-59): 72 bytes, pointer fields are written
# as zeros (the reference dumps live heap pointers there; readers overwrite)
READ_DTYPE = np.dtype({
    "names": ["len", "nHit", "hit_ptr", "dx_ptr", "bad", "otherFlags",
              "pad1", "nMiss", "contained", "nCopy", "pad2"],
    "formats": ["<i4", "<i4", "<u8", "<u8", "u1", "u1", "<u2", "<i4",
                "<i4", ("<i4", 4), ("<u4", 4)],
    "offsets": [0, 4, 8, 16, 24, 25, 26, 28, 32, 36, 52],
    "itemsize": 72,
})

INITIAL_DIM = 1 << 16  # readsetCreate(ms, 1<<16) at modasm.c:1568


def _grow_dim(dim: int, need: int, itemsize: int = 72) -> int:
    """arrayExtend growth schedule (array.c:143-160) until need < dim."""
    while need >= dim:
        if dim * itemsize < (1 << 23):
            dim *= 2
        else:
            dim += 1024 + ((1 << 23) // itemsize)
        if need >= dim:
            dim = need + 1
    return dim


def _cdiv(num, den):
    """C double division semantics: x/0 -> inf, 0/0 -> -nan (x86 printf)."""
    num = float(num)
    den = float(den)
    if den:
        return num / den
    if num:
        return float("inf") if num > 0 else float("-inf")
    return None  # prints as "-nan"


def _f(v, prec):
    return "-nan" if v is None else "%.*f" % (prec, v)


class Readset:
    def __init__(self, ms: Modset):
        self.ms = ms
        n = 1  # read 0 burned (modasm.c:95)
        self.n_reads = n
        self.reads_dim = INITIAL_DIM
        self.len = np.zeros(n, np.int32)
        self.n_hit = np.zeros(n, np.int32)
        self.n_miss = np.zeros(n, np.int32)
        self.bad = np.zeros(n, np.uint8)
        self.other_flags = np.zeros(n, np.uint8)
        self.contained = np.zeros(n, np.int32)
        self.n_copy = np.zeros((n, 4), np.int32)
        self.hit_off = np.zeros(n + 1, np.int64)
        self.hits = np.zeros(0, np.uint32)
        self.dx = np.zeros(0, np.uint16)
        self.tot_hit = 0
        self.device = None      # the torch device the readset's scan ran on
        self.inv_off = None
        self.inv_reads = None
        # modInfo side arrays (modasm.c:61-77), allocated by -R (refFlag)
        self.mi_flags = None
        self.mi_pos = None
        self.mi_good = self.mi_mod2 = None
        self.mi_badld = self.mi_split = self.mi_splitld = None

    # ---------------- construction ----------------

    def file_read(self, filename, device=None) -> None:
        """readsetFileRead (modasm.c:151-191): scan on ``device`` (the
        scanner's: None takes the CUDA card unless MODIMIZER_SCAN=host) +
        batched lookup + one fused native assembly pass (hits/dx/counts/
        depth — the numpy version's temporaries cost ~3x the whole
        reference command)."""
        from ..io import seqio
        ms = self.ms
        with profiling.span("rs.parse"):
            batch, _t = seqio.read_seq_file(filename, seqio.dna2index_n0(),
                                            is_qual=False, want_ids=False)
        offsets = np.ascontiguousarray(batch.offsets, np.int64)
        scanner = ModimizerScanner(ms.hasher, device=device)
        with profiling.span("rs.scan"):
            kmers, gpos, isF = scanner.scan_stream(batch.codes, offsets)
        self.device = scanner.device if scanner.used_device else None
        with profiling.span("rs.lookup"):
            sidx = ms.find_batch(kmers)

        n = batch.n
        self.n_reads = n + 1
        self.len = np.concatenate(
            [[0], batch.lengths]).astype(np.int32)
        self.n_hit = np.zeros(n + 1, np.int32)
        self.n_miss = np.zeros(n + 1, np.int32)
        self.bad = np.zeros(n + 1, np.uint8)
        self.other_flags = np.zeros(n + 1, np.uint8)
        self.contained = np.zeros(n + 1, np.int32)
        self.n_copy = np.zeros((n + 1, 4), np.int32)

        # hits (idx|TOPBIT·isF), dx (U16 gap, modasm.c:172), per-read
        # hit/miss counts and the rebuilt saturating depth
        # (modasm.c:158,174) in one native pass over the emit stream
        hits = np.empty(len(gpos), np.uint32)
        dx = np.empty(len(gpos), np.uint16)
        ms.depth[:] = 0
        tot = int(native_lib().rs_hits_from_scan(
            np.ascontiguousarray(gpos, np.int64),
            np.ascontiguousarray(isF).view(np.uint8),
            np.ascontiguousarray(sidx, np.uint32), len(gpos), offsets, n,
            hits, dx, self.n_hit, self.n_miss, ms.depth))
        self.hits = hits[:tot]
        self.dx = dx[:tot]
        self.tot_hit = tot
        self.hit_off = np.zeros(n + 2, np.int64)
        self.hit_off[2:] = np.cumsum(self.n_hit[1:])
        self.reads_dim = _grow_dim(INITIAL_DIM, n)
        alloc.add(self.hits.nbytes + self.dx.nbytes)
        self.inv_build()

    def inv_build(self) -> None:
        """invBuild (modasm.c:258-287): CSR inverse + per-read nCopy."""
        ms = self.ms
        self.inv_off = np.zeros(ms.max + 2, np.int64)
        self.inv_reads = np.zeros(max(self.tot_hit, 1), np.uint32)
        alloc.add(self.inv_off.nbytes + self.inv_reads.nbytes)
        native_lib().rs_inv_build(ctypes.byref(self._view()))

    # ---------------- native bridge ----------------

    def ensure_mod_info(self) -> None:
        if self.mi_flags is None:
            n = self.ms.max + 1
            self.mi_flags = np.zeros(n, np.uint8)
            self.mi_pos = np.zeros(n, np.int32)
            self.mi_good = np.zeros(n, np.int32)
            self.mi_mod2 = np.zeros(n, np.int32)
            self.mi_badld = np.zeros(n, np.int32)
            self.mi_split = np.zeros(n, np.int32)
            self.mi_splitld = np.zeros(n, np.int32)

    def _view(self, fd_out=-1, fd_stdout=-1) -> "RSView":
        def ptr(a, t):
            if a is None:
                return None
            return a.ctypes.data_as(ctypes.POINTER(t))
        c = ctypes
        v = RSView()
        v.rlen = ptr(self.len, c.c_int32)
        v.nHit = ptr(self.n_hit, c.c_int32)
        v.nMiss = ptr(self.n_miss, c.c_int32)
        v.bad = ptr(self.bad, c.c_uint8)
        v.oflags = ptr(self.other_flags, c.c_uint8)
        v.contained = ptr(self.contained, c.c_int32)
        v.nCopy = ptr(self.n_copy, c.c_int32)
        v.hitOff = ptr(self.hit_off, c.c_int64)
        v.hits = ptr(self.hits, c.c_uint32)
        v.dx = ptr(self.dx, c.c_uint16)
        v.depth = ptr(self.ms.depth, c.c_uint16)
        v.info = ptr(self.ms.info, c.c_uint8)
        v.invOff = ptr(self.inv_off, c.c_int64)
        v.invReads = ptr(self.inv_reads, c.c_uint32)
        v.miFlags = ptr(self.mi_flags, c.c_uint8)
        v.miPos = ptr(self.mi_pos, c.c_int32)
        v.miGood = ptr(self.mi_good, c.c_int32)
        v.miMod2 = ptr(self.mi_mod2, c.c_int32)
        v.miBadLD = ptr(self.mi_badld, c.c_int32)
        v.miSplit = ptr(self.mi_split, c.c_int32)
        v.miSplitLD = ptr(self.mi_splitld, c.c_int32)
        v.nReads = self.n_reads
        v.msMax = self.ms.max
        v.totHit = self.tot_hit
        v.hasherW = self.ms.hasher.w
        v.fdOut = fd_out
        v.fdStdout = fd_stdout
        return v

    def device_overlap_candidates(self, dmax: int = 64, device=None):
        """Batched findOverlaps phase 1 on ``device`` (parallel/overlaps.py;
        None: the device of the readset's scan, else the CUDA card):
        per-read CSR candidate lists in the reference's stable-sorted order
        (descending U16-wrapped nHit over first-encounter order,
        modasm.c:353), ready for the native *_pre phase-2 engines."""
        from ..parallel.overlaps import overlap_counts
        if self.tot_hit == 0:
            return (np.zeros(0, np.uint32), np.zeros(0, np.uint16),
                    np.zeros(self.n_reads + 1, np.int64))
        res = overlap_counts(self, dmax=dmax, device=device)
        x, y, cnt = res["x"], res["y"], res["n_hit"]
        rank = res["first_rank"]
        wrapped = (cnt & np.uint32(0xFFFF)).astype(np.uint16)
        # re-sort with the WRAPPED count (the reference sorts the U16 field)
        oo = np.lexsort((rank, (0xFFFF - wrapped.astype(np.int32)), x))
        x, y, wrapped = x[oo], y[oo], wrapped[oo]
        off = np.zeros(self.n_reads + 1, np.int64)
        np.cumsum(np.bincount(x, minlength=self.n_reads), out=off[1:])
        return (np.ascontiguousarray(y, np.uint32),
                np.ascontiguousarray(wrapped, np.uint16),
                np.ascontiguousarray(off, np.int64))

    def native_call(self, name, out_f, *extra):
        """Run a native modasm command with exact stream interleaving;
        returns what the command returns."""
        import sys
        sys.stdout.flush()
        out_f.flush()
        try:
            fd_out = out_f.fileno()
        except (AttributeError, OSError):
            fd_out = sys.stdout.fileno()
        v = self._view(fd_out, sys.stdout.fileno())
        return getattr(native_lib(), name)(ctypes.byref(v), *extra)

    # ---------------- stats (modasm.c:193-256) ----------------

    def stats(self, out) -> None:
        import sys
        n = self.n_reads - 1
        if not n:
            sys.stderr.write("stats called on empty readset\n")
            return
        self.ms.summary(out)
        ms = self.ms
        lens = self.len[1:].astype(np.int64)
        tot_len = int(lens.sum())
        tot_miss = int(self.n_miss[1:].sum())
        tot_copy = self.n_copy[1:].sum(axis=0, dtype=np.int64)
        c1 = self.n_copy[1:, 1]
        u0 = c1 == 0
        u1 = c1 == 1
        n_u0, n_u1 = int(u0.sum()), int(u1.sum())
        len_u0, len_u1 = int(lens[u0].sum()), int(lens[u1].sum())
        bad = self.bad[1:]
        n_bad = int((bad != 0).sum())
        bits = [int(((bad & (1 << b)) != 0).sum()) for b in range(6)]
        tot_hit = self.tot_hit

        out.write("RS %d sequences, total length %d (av %s)\n"
                  % (n, tot_len, _f(_cdiv(tot_len, n), 1)))
        out.write("RS %d mod hits, %s bp/hit, frac hit %s, av hits/read %s\n"
                  % (tot_hit, _f(_cdiv(tot_len, tot_hit), 1),
                     _f(_cdiv(tot_hit, tot_miss + tot_hit), 2),
                     _f(_cdiv(tot_hit, n), 1)))
        out.write("RS hit distribution %s copy0, %s copy1, %s copy2, %s copyM\n"
                  % tuple(_f(_cdiv(int(tot_copy[j]), tot_hit), 2)
                          for j in range(4)))
        n_multi = n - n_u0 - n_u1
        out.write("RS num reads and av_len with 0 copy1 hits %d %s"
                  " with 1 copy1 hits %d %s >1 copy1 hits %d %s"
                  " av copy1 hits %s\n"
                  % (n_u0, _f(_cdiv(len_u0, n_u0), 1),
                     n_u1, _f(_cdiv(len_u1, n_u1), 1),
                     n_multi, _f(_cdiv(tot_len - len_u0 - len_u1, n_multi), 1),
                     _f(_cdiv(int(tot_copy[1]) - n_u1, n_multi), 1)))
        out.write("RS bad %u : %u repeat, %u order10, %u order1, "
                  % (n_bad, bits[0], bits[1], bits[2]))
        out.write("%u no_match, %u low_hit, %u low_copy1\n"
                  % (bits[3], bits[4], bits[5]))

        cn = (ms.info[1:ms.max + 1] & 3).astype(np.int64)
        d = ms.depth[1:ms.max + 1].astype(np.int64)
        n_copy = np.bincount(cn, minlength=4)
        hit_copy = np.bincount(cn[d > 0], minlength=4)
        hit2 = d > 1
        hit2_copy = np.bincount(cn[hit2], minlength=4)
        depth_copy = np.bincount(cn[hit2], weights=d[hit2],
                                 minlength=4).astype(np.int64)
        parts = []
        for j in range(4):
            parts.append("%s %s %s" % (
                _f(_cdiv(int(hit_copy[j]), int(n_copy[j])), 3),
                _f(_cdiv(int(hit2_copy[j]), int(n_copy[j])), 3),
                _f(_cdiv(int(depth_copy[j]), int(hit2_copy[j])), 1)))
        out.write("RS mod frac hit hit>1 av: copy0 %s copy1 %s copy2 %s"
                  " copyM %s\n" % tuple(parts))

    # ---------------- persistence (RSMSHv2, modasm.c:110-149) ----------------

    def write(self, root: str) -> None:
        # fopenTag routes through fzopen (utils.c:129-139), i.e. gzip framing
        self.ms.write(root + ".mod")
        from ..io.fzio import GzWriter
        with GzWriter(root + ".readset") as f:
            f.write(MAGIC)
            f.write(int(self.tot_hit).to_bytes(8, "little"))
            recs = np.zeros(self.reads_dim, READ_DTYPE)
            m = self.n_reads
            recs["len"][:m] = self.len
            recs["nHit"][:m] = self.n_hit
            recs["bad"][:m] = self.bad
            recs["otherFlags"][:m] = self.other_flags
            recs["nMiss"][:m] = self.n_miss
            recs["contained"][:m] = self.contained
            recs["nCopy"][:m] = self.n_copy
            f.write(_ARR_HDR.pack(ARRAY_MAGIC, 0, self.reads_dim,
                                  READ_DTYPE.itemsize, m))
            f.write(recs)
            for i in range(1, m):
                a, b = self.hit_off[i], self.hit_off[i + 1]
                if b > a:
                    f.write(self.hits[a:b])
                    f.write(self.dx[a:b])

    @classmethod
    def read(cls, root: str) -> "Readset":
        import io
        from ..io.fzio import read_maybe_gz
        ms = Modset.read(root + ".mod")
        rs = cls(ms)
        with io.BytesIO(read_maybe_gz(root + ".readset")) as f:
            if f.read(8) != MAGIC:
                raise ValueError("bad readset header != RSMSHv2")
            rs.tot_hit = int.from_bytes(f.read(8), "little")
            hdr = f.read(_ARR_HDR.size)
            magic, _base, dim, size, mx = _ARR_HDR.unpack(hdr)
            if magic != ARRAY_MAGIC or size != READ_DTYPE.itemsize:
                raise ValueError("bad reads array header")
            recs = np.frombuffer(f.read(dim * size), READ_DTYPE, dim)
            rs.reads_dim = dim
            rs.n_reads = mx
            rs.len = recs["len"][:mx].astype(np.int32)
            rs.n_hit = recs["nHit"][:mx].astype(np.int32)
            rs.n_miss = recs["nMiss"][:mx].astype(np.int32)
            rs.bad = recs["bad"][:mx].astype(np.uint8)
            rs.other_flags = recs["otherFlags"][:mx].astype(np.uint8)
            rs.contained = recs["contained"][:mx].astype(np.int32)
            rs.n_copy = recs["nCopy"][:mx].astype(np.int32)
            rs.hit_off = np.zeros(mx + 1, np.int64)
            rs.hit_off[1:] = np.cumsum(rs.n_hit)
            tot = int(rs.hit_off[-1])
            hits = np.empty(tot, np.uint32)
            dx = np.empty(tot, np.uint16)
            for i in range(1, mx):
                a, b = rs.hit_off[i], rs.hit_off[i + 1]
                nh = int(b - a)
                if nh:
                    hits[a:b] = np.frombuffer(f.read(4 * nh), np.uint32)
                    dx[a:b] = np.frombuffer(f.read(2 * nh), np.uint16)
            rs.hits, rs.dx = hits, dx
        rs.inv_build()
        return rs
