"""Sequence IO: FASTA / FASTQ (plain or gzip) / custom binary / ONE-code.

Re-designed host ingest for the TPU pipeline (reference: seqio.c).  Instead of
the reference's byte-at-a-time buffered scanner, files are parsed with
vectorized numpy passes into a *ragged batch* representation — one contiguous
code array plus offsets — which feeds the device hash kernels directly and
also supports record streaming for the conversion utilities.

Behavioral parity notes (all against seqio.c):
- conversion tables are faithful copies of the semantics at seqio.c:610-718
  (values, -2 for "remove/illegal");
- FASTA reading *drops* characters whose conversion is negative
  (seqio.c:322: ``if ((*t++ = convert[*s++]) < 0) --t``); FASTQ converts
  in place without dropping (seqio.c:328-331);
- the custom binary format reproduces the 64-byte header and record layout
  byte-exactly on write (seqio.c:152-168, 543-551).  NB the reference's
  binary *read* path is broken (the seqExpand priming loop at seqio.c:91-97
  self-corrupts); ours implements the evident intent and reads
  reference-written files correctly.
"""

import os
from dataclasses import dataclass, field

import numpy as np

from ..utils import profiling


# ------------------------------------------------------------------
# conversion tables (semantics of seqio.c:610-718)
# ------------------------------------------------------------------


def _table(mapping, default=-2):
    t = np.full(128, default, np.int16)
    for chars, val in mapping:
        for ch in chars:
            t[ord(ch)] = val if not isinstance(val, str) else ord(val)
    return t


dna2textConv = _table([("A", "A"), ("C", "C"), ("G", "G"), ("T", "T"),
                       ("N", "N"), ("a", "a"), ("c", "c"), ("g", "g"),
                       ("t", "t"), ("n", "n")])  # case-preserving (seqio.c:610)
dna2textAmbigConv = _table(
    [("Aa", "A"), ("Bb", "B"), ("Cc", "C"), ("Dd", "D"), ("Gg", "G"),
     ("Hh", "H"), ("Kk", "K"), ("Mm", "M"), ("Nn", "N"), ("Rr", "R"),
     ("Ss", "S"), ("Tt", "T"), ("Vv", "V"), ("Ww", "W"), ("Yy", "Y"),
     ("-", "-")])
dna2textAmbig2NConv = _table(
    [("Aa", "A"), ("Cc", "C"), ("Gg", "G"), ("Tt", "T"),
     ("BbDdHhKkMmNnRrSsVvWwYy", "N")])
dna2indexConv = _table([("Aa", 0), ("Cc", 1), ("Gg", 2), ("Tt", 3), ("Nn", 4)])
dna2index4Conv = _table([("Aa", 0), ("Cc", 1), ("Gg", 2), ("Tt", 3), ("Nn", 0)])
dna2binaryConv = _table([("Aa", 1), ("Cc", 2), ("Gg", 4), ("Tt", 8), ("Nn", 15)])
dna2binaryAmbigConv = _table(
    [("-", 0), ("Aa", 1), ("Cc", 2), ("Mm", 3), ("Gg", 4), ("Rr", 5),
     ("Ss", 6), ("Vv", 7), ("Tt", 8), ("Ww", 9), ("Yy", 10), ("Hh", 11),
     ("Kk", 12), ("Dd", 13), ("Bb", 14), ("Nn", 15)])
noConv = np.arange(128, dtype=np.int16)


def dna2index_n0() -> np.ndarray:
    """dna2indexConv with N,n -> 0, as every mod* program sets before reading
    (modutils.c:39, modmap.c:97)."""
    t = dna2indexConv.copy()
    t[ord("N")] = 0
    t[ord("n")] = 0
    return t


def _full256(conv: np.ndarray) -> np.ndarray:
    """Extend a 128-entry table to 256 so any byte can index it."""
    t = np.full(256, -2, np.int16)
    t[:128] = conv
    return t


# ------------------------------------------------------------------
# ragged batches
# ------------------------------------------------------------------


@dataclass
class SeqBatch:
    """Ragged batch of converted sequences: the host->device currency."""
    codes: np.ndarray            # int8/uint8 concatenated converted sequences
    offsets: np.ndarray          # int64 [n+1]; seq i = codes[offsets[i]:offsets[i+1]]
    ids: list = field(default_factory=list)     # optional id strings
    descs: list = field(default_factory=list)   # optional description strings
    quals: np.ndarray = None     # concatenated quals aligned with codes (or None)

    def __post_init__(self):
        from ..utils import alloc
        alloc.add(self.codes.nbytes + self.offsets.nbytes
                  + (self.quals.nbytes if self.quals is not None else 0))

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def seq(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i]:self.offsets[i + 1]]

    def qual(self, i: int) -> np.ndarray:
        return self.quals[self.offsets[i]:self.offsets[i + 1]]


# ------------------------------------------------------------------
# file type sniffing (seqio.c:47-148)
# ------------------------------------------------------------------

FASTA, FASTQ, BINARY, ONE, BAM, UNKNOWN = "fasta", "fastq", "binary", "onecode", "bam", "unknown"
TYPE_NAMES = {FASTA: "fasta", FASTQ: "fastq", BINARY: "binary",
              ONE: "onecode", BAM: "bam", UNKNOWN: "unknown"}


def sniff_type(first_byte: int) -> str:
    c = chr(first_byte) if first_byte < 128 else "?"
    if c == ">":
        return FASTA
    if c == "@":
        return FASTQ
    if c == "b":
        return BINARY
    if c == "1":
        return ONE
    return UNKNOWN


# ------------------------------------------------------------------
# vectorized FASTA / FASTQ parsing
# ------------------------------------------------------------------


def _split_hdr(data, s, e):
    hdr = data[s:e]
    for i, ch in enumerate(hdr):
        if ch in (9, 32, 11, 12, 13):
            return hdr[:i].decode("latin1"), hdr[i + 1:].decode("latin1")
    return hdr.decode("latin1"), ""


# a FASTA pass takes one thread a this many bytes, up to OpenMP's threads
PARSE_BYTES_A_THREAD = 4 << 20


def parse_threads(n: int) -> int:
    """The threads the native FASTA pass takes for ``n`` bytes."""
    from ..native import lib as native_lib
    return max(1, min(n // PARSE_BYTES_A_THREAD,
                      native_lib().io_max_threads()))


def fasta_pass(data, conv: np.ndarray, threads: int):
    """The native FASTA pass over ``data`` (any buffer) with the
    256-entry int16 table ``conv``: (codes int8, offsets int64 [nrec + 1],
    hdr int64 [nrec, 4]: the record's '>', header end, id end, desc
    start).  No returned array views ``data``."""
    from ..native import FASTA_ALLOC, lib as native_lib
    out = []

    def alloc(kind, count):
        a = np.empty(count, np.int8 if kind == 2 else np.int64)
        out.append(a)
        return a.ctypes.data

    buf = np.frombuffer(data, np.uint8)
    nc = native_lib().io_fasta_parse(buf, len(buf), conv, threads,
                                     FASTA_ALLOC(alloc))
    if nc < 0:
        raise MemoryError("FASTA parse: allocation failed")
    offsets, hdr, codes = out
    return codes, offsets, hdr.reshape(-1, 4)


def _parse_fasta(data, convert: np.ndarray, want_ids: bool, threads=None):
    """FASTA parse of ``data`` (any buffer) in the native runtime, on
    ``threads`` threads (by default as ``parse_threads`` says); the tests
    hold it against the JAX package's numpy twin of ``_parse_fasta_np``."""
    conv = np.ascontiguousarray(_full256(convert), np.int16)
    return _fasta_batch(data, *fasta_pass(
        data, conv, parse_threads(len(data)) if threads is None else threads),
        want_ids)


def _fasta_batch(data, codes, offsets, hdr, want_ids):
    ids, descs = [], []
    if want_ids and len(hdr):
        buf = np.frombuffer(data, np.uint8)
        ids = _texts(buf, hdr[:, 0] + 1, hdr[:, 2])
        descs = _texts(buf, hdr[:, 3], hdr[:, 1])
    return SeqBatch(codes, offsets, ids, descs)


def _texts(buf, a, b):
    """``[bytes(buf[a[i]:b[i]]).decode("latin1")]`` in one gather and one
    decode: the slices joined by newlines, which no header line holds."""
    lens = np.maximum(b - a, 0)
    ends = np.cumsum(lens + 1)
    # a slice's separator slot reads buf[b], inside the buffer
    at = np.repeat(np.minimum(a, b) - (ends - lens - 1), lens + 1)
    joined = buf[np.arange(ends[-1]) + at]
    joined[ends - 1] = 0x0A
    return joined.tobytes().decode("latin1").split("\n")[:-1]


def _parse_fasta_np(data: bytes, convert: np.ndarray, want_ids: bool):
    """Vectorized FASTA parse. Drops chars with negative conversion."""
    buf = np.frombuffer(data, np.uint8)
    if len(buf) == 0:
        return SeqBatch(np.zeros(0, np.int8), np.zeros(1, np.int64))
    nl = buf == ord("\n")
    # record starts: '>' at position 0 or after newline
    gt = buf == ord(">")
    starts = np.flatnonzero(gt & np.concatenate(([True], nl[:-1])))
    # header line end for each record (virtual newline at EOF)
    nl_pos = np.concatenate([np.flatnonzero(nl), [len(buf)]])
    hdr_end = nl_pos[np.searchsorted(nl_pos, starts)]
    hdr_end = np.minimum(hdr_end, len(buf) - 1)
    # sequence region = (hdr_end, next start); mask header bytes out
    region_end = np.empty(len(starts), np.int64)
    region_end[:-1] = starts[1:]
    region_end[-1] = len(buf)

    conv = _full256(convert)
    converted = conv[buf]
    # blank out header lines (start..hdr_end inclusive) directly: header
    # bytes are a tiny fraction, so build their index list instead of a
    # whole-file cumsum mask (int8/bool cumsums are pathologically slow on
    # this host)
    hlen = (hdr_end - starts + 1).astype(np.int64)
    htot = int(hlen.sum())
    hbase = np.repeat(starts, hlen)
    hoff = np.arange(htot, dtype=np.int64) - np.repeat(
        np.cumsum(hlen) - hlen, hlen)
    converted[hbase + hoff] = -2

    keep = converted >= 0
    codes = converted[keep].astype(np.int8)

    # per-record lengths: count kept bytes in [hdr_end+1, region_end)
    bnds = np.empty(2 * len(starts), np.int64)
    bnds[0::2] = hdr_end + 1
    bnds[1::2] = region_end
    # reduceat quirk: for empty [b, b) segments it returns keep64[b]; those
    # are sequences of length 0 whose count we then zero explicitly.  A
    # sentinel 0 is appended so an end boundary of len(buf) is valid.
    keep64 = np.concatenate([keep.astype(np.int64), [0]])
    sums = np.add.reduceat(keep64, bnds)[0::2]
    empty = bnds[0::2] >= bnds[1::2]
    sums[empty] = 0
    lens = sums
    offsets = np.concatenate(([0], np.cumsum(lens)))

    ids, descs = [], []
    if want_ids:
        for s, e in zip(starts, hdr_end):
            hdr = data[s + 1:e]
            sp = -1
            for i, ch in enumerate(hdr):
                if ch in (9, 32, 11, 12, 13):
                    sp = i
                    break
            if sp < 0:
                ids.append(hdr.decode("latin1"))
                descs.append("")
            else:
                ids.append(hdr[:sp].decode("latin1"))
                descs.append(hdr[sp + 1:].decode("latin1"))
    return SeqBatch(codes, offsets, ids, descs)


def _parse_fastq(data: bytes, convert: np.ndarray, is_qual: bool,
                 want_ids: bool):
    """FASTQ parse in the native runtime (4-line records; no dropping)."""
    from ..native import lib as native_lib
    buf = np.frombuffer(data, np.uint8)
    n = len(buf)
    L = native_lib()
    n_rec = L.io_fastq_count(buf, n)
    codes = np.empty(n, np.int8)
    offsets = np.zeros(n_rec + 1, np.int64)
    hdr = np.zeros(2 * max(n_rec, 1), np.int64)
    quals = np.empty(n, np.int8) if is_qual else None
    conv = (np.ascontiguousarray(_full256(convert), np.int16)
            if convert is not None else None)
    nc = L.io_parse_fastq(
        buf, n, conv.ctypes.data if conv is not None else None,
        int(is_qual), codes, offsets, hdr,
        quals.ctypes.data if quals is not None else None)
    if nc < 0:
        raise ValueError("qual not same length as seq")
    codes = codes[:nc]
    ids, descs = [], []
    if want_ids:
        for r in range(n_rec):
            i_, d_ = _split_hdr(data, hdr[2 * r], hdr[2 * r + 1])
            ids.append(i_)
            descs.append(d_)
    return SeqBatch(codes, offsets, ids, descs,
                    quals[:nc] if quals is not None else None)


def _parse_fastq_np(data: bytes, convert: np.ndarray, is_qual: bool,
                    want_ids: bool):
    """Vectorized FASTQ parse (4-line records; no dropping on convert)."""
    buf = np.frombuffer(data, np.uint8)
    nl_pos = np.flatnonzero(buf == ord("\n"))
    if len(data) and data[-1:] != b"\n":
        nl_pos = np.concatenate([nl_pos, [len(buf)]])
    line_starts = np.concatenate(([0], nl_pos[:-1] + 1))
    n_lines = len(line_starts)
    n_rec = n_lines // 4
    ls = line_starts[:n_rec * 4].reshape(n_rec, 4)
    le = nl_pos[:n_rec * 4].reshape(n_rec, 4)

    seq_s, seq_e = ls[:, 1], le[:, 1]
    lens = seq_e - seq_s
    offsets = np.concatenate(([0], np.cumsum(lens)))
    total = int(offsets[-1])

    d = np.zeros(len(buf) + 1, np.int64)
    np.add.at(d, seq_s, 1)
    np.add.at(d, seq_e, -1)
    take = np.cumsum(d[:-1]) > 0
    raw = buf[take]
    if convert is not None:
        codes = _full256(convert)[raw].astype(np.int8)
    else:
        codes = raw.view(np.int8)

    quals = None
    if is_qual:
        q_s, q_e = ls[:, 3], le[:, 3]
        if not np.array_equal(q_e - q_s, lens):
            raise ValueError("qual not same length as seq")
        dq = np.zeros(len(buf) + 1, np.int64)
        np.add.at(dq, q_s, 1)
        np.add.at(dq, q_e, -1)
        takeq = np.cumsum(dq[:-1]) > 0
        quals = (buf[takeq] - 33).astype(np.int8)

    ids, descs = [], []
    if want_ids:
        for i in range(n_rec):
            hdr = data[ls[i, 0] + 1:le[i, 0]]
            sp = -1
            for j, ch in enumerate(hdr):
                if ch in (9, 32, 11, 12, 13):
                    sp = j
                    break
            if sp < 0:
                ids.append(hdr.decode("latin1"))
                descs.append("")
            else:
                ids.append(hdr[:sp].decode("latin1"))
                descs.append(hdr[sp + 1:].decode("latin1"))
    return SeqBatch(codes, offsets, ids, descs, quals)


# ------------------------------------------------------------------
# 2-bit / 1-bit packing (seqio.c:557-606 semantics)
# ------------------------------------------------------------------


def seq_pack(codes: np.ndarray) -> np.ndarray:
    """Pack base codes (0..3) into bytes: 4 bases/byte, first base in the
    high bits (sqioSeqPack, seqio.c:557-571)."""
    n = len(codes)
    nb = (n + 3) // 4
    padded = np.zeros(nb * 4, np.uint8)
    padded[:n] = np.asarray(codes, np.uint8) & 3
    quads = padded.reshape(nb, 4)
    out = (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) | quads[:, 3]
    if n % 4:
        # the reference's remainder loop packs the tail into the LOW bits
        r = n % 4
        tail = np.zeros(4, np.uint8)
        tail[:r] = padded[(nb - 1) * 4:(nb - 1) * 4 + r]
        v = 0
        for i in range(r):
            v = ((v << 2) | int(tail[i])) & 0xFF
        out[-1] = v
    return out.astype(np.uint8)


def seq_unpack(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of seq_pack -> base codes 0..3 (intended semantics)."""
    packed = np.asarray(packed, np.uint8)
    nb = (n + 3) // 4
    b = packed[:nb]
    out = np.empty(nb * 4, np.uint8)
    out[0::4] = (b >> 6) & 3
    out[1::4] = (b >> 4) & 3
    out[2::4] = (b >> 2) & 3
    out[3::4] = b & 3
    if n % 4:
        r = n % 4
        v = int(b[-1])
        tail = np.zeros(r, np.uint8)
        for i in range(r - 1, -1, -1):
            tail[i] = v & 3
            v >>= 2
        out[(nb - 1) * 4:(nb - 1) * 4 + r] = tail
    return out[:n]


def qual_pack(quals: np.ndarray, thresh: int) -> np.ndarray:
    """1-bit qualities: bit set if q >= thresh (sqioQualPack, seqio.c:583-596).

    The reference shifts *after* setting the bit, so within each full byte the
    first qual lands at bit 7's neighbour — we reproduce the exact layout:
    for 8 quals q0..q7 the byte is ((q0<<7)|(q1<<6)|...)>>... matching
    ``for i in 8: { if q>=t: u|=1; u<<=1 }`` i.e. u = sum(bit_i << (7-i)) << 1
    truncated to 8 bits => bit_i at position (7-i+1)&7... we simply emulate
    the loop.
    """
    q = np.asarray(quals, np.int16)
    n = len(q)
    nb = (n + 7) // 8
    bits = (q >= thresh).astype(np.uint8)
    out = np.zeros(nb, np.uint8)
    # emulate: full groups of 8 while len > 8; remainder loop identical shape
    full = (n - 1) // 8 if n > 8 else 0
    pos = 0
    for g in range(nb):
        cnt = min(8, n - pos) if g == nb - 1 else 8
        u = 0
        for i in range(cnt):
            if bits[pos + i]:
                u |= 1
            u = (u << 1) & 0xFF
        out[g] = u
        pos += cnt
    return out


def qual_unpack(packed: np.ndarray, n: int, thresh: int) -> np.ndarray:
    """Inverse: qual = thresh where bit set else 0 (intended semantics)."""
    out = np.zeros(n, np.uint8)
    pos = 0
    packed = np.asarray(packed, np.uint8)
    nb = (n + 7) // 8
    for g in range(nb):
        cnt = min(8, n - pos)
        u = int(packed[g])
        for i in range(cnt - 1, -1, -1):
            out[pos + i] = thresh if (u >> 1) & 1 else 0
            u >>= 1
        pos += cnt
    return out


# ------------------------------------------------------------------
# custom binary format (seqio.c:152-168, 273-295, 543-551)
# ------------------------------------------------------------------


def _parse_binary(data: bytes, convert: np.ndarray, is_qual: bool,
                  want_ids: bool):
    if len(data) <= 64:
        raise ValueError("binary file too short")
    qual_thresh = data[1]
    hdr = np.frombuffer(data, np.uint64, 7, 8)
    n_seq, tot_id, tot_desc, tot_seq, max_id, max_desc, max_seq = (int(x) for x in hdr)
    off = 64
    ids, descs = [], []
    seqs, quals = [], []
    for _ in range(n_seq):
        id_len, desc_len, seq_len = np.frombuffer(data, np.int32, 3, off)
        off += 12
        id_len, desc_len, seq_len = int(id_len), int(desc_len), int(seq_len)
        n_bytes = id_len + 1 + desc_len + 1 + (seq_len + 3) // 4
        if qual_thresh:
            n_bytes += (seq_len + 7) // 8
        n_bytes = 4 * ((n_bytes + 3) // 4)
        rec = data[off:off + n_bytes]
        off += n_bytes
        if want_ids:
            ids.append(rec[:id_len].decode("latin1"))
            descs.append(rec[id_len + 1:id_len + 1 + desc_len].decode("latin1"))
        p = id_len + 1 + desc_len + 1
        packed = np.frombuffer(rec, np.uint8, (seq_len + 3) // 4, p)
        codes = seq_unpack(packed, seq_len)
        if convert is not None:
            # binary stores 2-bit indices; map through unpackConvert letters
            # then the caller's table, like the reference's unpackConvert
            letters = np.array([ord("A"), ord("C"), ord("G"), ord("T")],
                               np.uint8)[codes]
            codes = _full256(convert)[letters].astype(np.int8)
        seqs.append(codes.astype(np.int8))
        if qual_thresh and is_qual:
            qp = p + (seq_len + 3) // 4
            qpacked = np.frombuffer(rec, np.uint8, (seq_len + 7) // 8, qp)
            quals.append(qual_unpack(qpacked, seq_len, qual_thresh).astype(np.int8))
    lens = np.array([len(s) for s in seqs], np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens)))
    codes = np.concatenate(seqs) if seqs else np.zeros(0, np.int8)
    q = (np.concatenate(quals) if quals and is_qual and qual_thresh else None)
    return SeqBatch(codes, offsets, ids, descs, q), qual_thresh


# ------------------------------------------------------------------
# reading entry point
# ------------------------------------------------------------------


def incomplete_tail_fixup(data, ftype):
    """Reference seqio DROPS a final partial record: EOF mid-line (or while
    seeking a FASTA record's first sequence line) makes bufAdvanceInRecord
    print ``incomplete sequence record line N`` and seqIOread return false
    (seqio.c:216-219, 303-321).  N = completed newlines + 1 (verified
    empirically across FASTA/FASTQ tail shapes).  Returns (data', N) with
    the partial record removed, or (data, None) if the tail is complete."""
    if not len(data):
        return data, None
    if ftype == FASTA:
        cut, n = fasta_tail_cut(data)
        return (data, None) if n is None else (data[:cut], n)
    if ftype == FASTQ:
        nl = data.count(b"\n")
        if data[-1] == 0x0A and nl % 4 == 0:
            return data, None
        cut = len(data)
        if data[-1] != 0x0A:
            cut = data.rfind(b"\n") + 1      # drop the unterminated line
        for _ in range(nl % 4):              # drop the partial record's
            if cut == 0:
                break
            cut = data.rfind(b"\n", 0, cut - 1) + 1  # complete lines
        return data[:cut], nl + 1
    return data, None


def fasta_tail_cut(data):
    """``incomplete_tail_fixup``'s FASTA rule over any non-empty buffer
    (bytes, bytearray, a map) without a copy: (cut, N) where the final
    record, from ``cut``, is partial, else (len(data), None).  The final
    record starts at the last '>' at 0 or after a newline, found by
    one-byte reverse searches; the newlines of N are counted only when the
    record is dropped."""
    n = len(data)
    cut = data.rfind(b">")
    while cut > 0 and data[cut - 1] != 0x0A:
        cut = data.rfind(b">", 0, cut)
    cut = max(cut, 0)
    # EOF mid-line, or the final record is a bare header line: the
    # reference hits EOF advancing to its (absent) sequence line
    if data[n - 1] != 0x0A or data.find(b"\n", cut) == n - 1:
        from ..native import byte_hist256
        return cut, int(byte_hist256(np.frombuffer(data, np.uint8))[0x0A]) + 1
    return n, None


def _map_fasta(f):
    """A read-only map of the open file ``f`` if it is a regular, non-empty
    file whose first byte is '>' (plain FASTA), else None.  Not populated:
    the pass's threads fault its pages in together, where ``MAP_POPULATE``
    maps them on one thread first (1-10 ms more a 64-200 MB file on an
    8-core host)."""
    import mmap
    import stat
    st = os.fstat(f.fileno())
    if not stat.S_ISREG(st.st_mode) or st.st_size == 0 or f.read(1) != b">":
        f.seek(0)
        return None
    return mmap.mmap(f.fileno(), 0, flags=mmap.MAP_PRIVATE,
                     prot=mmap.PROT_READ)


def _read_fasta(data, convert, want_ids):
    """The FASTA path of ``read_seq_file`` over whole-file bytes or a map:
    the partial final record dropped as ``incomplete_tail_fixup`` drops it,
    then one native pass over a view of the rest."""
    cut, line = fasta_tail_cut(data)
    if line is not None:
        import sys
        sys.stderr.write("incomplete sequence record line %d\n" % line)
    threads = parse_threads(cut)
    profiling.count("parse.threads", threads)
    return _parse_fasta(np.frombuffer(data, np.uint8, cut),
                        dna2textAmbigConv if convert is None else convert,
                        want_ids, threads)


def _apply_tail_fixup(data, ftype):
    data, n = incomplete_tail_fixup(data, ftype)
    if n is not None:
        import sys
        sys.stderr.write("incomplete sequence record line %d\n" % n)
    return data


def read_seq_file(filename, convert=None, is_qual=False, want_ids=True):
    """Read a whole sequence file into a SeqBatch (auto-detects type).

    ``convert=None`` mirrors the reference defaults: FASTA gets
    dna2textAmbigConv (whitespace removal), FASTQ/binary stay raw text
    (seqio.c:49,76).  Returns (batch, file_type).  A plain FASTA file is
    parsed from a map of its pages.  The job's counters: ``parse.bases``
    gains the batch's bases, ``parse.mapped`` 1 a mapped file and
    ``parse.threads`` the threads of each native FASTA pass.
    """
    batch, ftype = _read_seq_file(filename, convert, is_qual, want_ids)
    profiling.count("parse.bases", len(batch.codes))
    return batch, ftype


def _read_seq_file(filename, convert, is_qual, want_ids):
    from .fzio import gz_decompress_all
    if filename == "-":
        import sys
        data = sys.stdin.buffer.read()
        if data[:2] == b"\x1f\x8b":
            data = gz_decompress_all(data)
    else:
        with open(filename, "rb") as f:
            mm = _map_fasta(f)
            if mm is None:
                data = bytearray(f.read())
        if mm is not None:
            profiling.count("parse.mapped", 1)
            with mm:
                return _read_fasta(mm, convert, want_ids), FASTA
        if data[:2] == b"\x1f\x8b":
            data = gz_decompress_all(data)
    if not data:
        raise IOError(f"sequence file {filename} unreadable or empty")
    ftype = sniff_type(data[0])
    if ftype == FASTA:
        return _read_fasta(data, convert, want_ids), FASTA
    if ftype == FASTQ:
        return _parse_fastq(_apply_tail_fixup(data, FASTQ), convert,
                            is_qual, want_ids), FASTQ
    if ftype == BINARY:
        conv = convert if convert is not None else dna2textConv
        batch, _t = _parse_binary(data, conv, is_qual, want_ids)
        return batch, BINARY
    if ftype == ONE:
        from .onecode import read_one_seq
        return read_one_seq(data, convert, is_qual, want_ids), ONE
    # not >/@/b/1: the reference hands these to htslib (seqio.c:47-148);
    # our native BAM/SAM layer takes them (io/bamio.py)
    from . import bamio
    if bamio.is_bam(data):
        return bamio.parse_bam(data, convert, is_qual, want_ids,
                               filename), BAM
    if bamio.is_cram(data):
        from . import cramio
        return cramio.parse_cram(data, convert, is_qual, want_ids,
                                 filename), BAM
    if bamio.looks_like_sam(data):
        return bamio.parse_sam(data, convert, is_qual, want_ids,
                               filename), BAM
    raise ValueError(f"sequence file {filename} is unknown type")


# ------------------------------------------------------------------
# writing (fasta / fastq / binary), exact output bytes
# ------------------------------------------------------------------


class SeqWriter:
    """Sequence writer matching seqIOopenWrite/seqIOwrite output bytes.

    ``filename`` handling follows seqio.c:366-442: '-' = stdout, '-z' =
    gzipped stdout, a .gz suffix means gzip (and is stripped for type
    sniffing), then .fa -> FASTA, .fq -> FASTQ, else BINARY when type is
    UNKNOWN.
    """

    def __init__(self, filename, ftype=UNKNOWN, convert=None, qual_thresh=0):
        self.type = ftype
        self.convert = convert
        self.is_qual = qual_thresh > 0
        self.qual_thresh = qual_thresh
        if self.type == FASTA and self.is_qual:
            import sys
            sys.stderr.write(
                "warning : can't write qualities to FASTA file %s\n" % filename)
            self.is_qual = False
        self.n_seq = 0
        self.tot_id = self.tot_desc = self.tot_seq = 0
        self.max_id = self.max_desc = self.max_seq = 0

        name = filename
        self._gz = False
        if name == "-":
            import sys
            self._f = sys.stdout.buffer
            self._close = False
        elif name == "-z":
            import sys
            from .fzio import GzWriter
            self._f = GzWriter(sys.stdout.buffer)
            self._gz = True
            self._close = True
        elif name.endswith(".gz"):
            from .fzio import GzWriter
            name = name[:-3]
            self._f = GzWriter(filename)
            self._gz = True
            self._close = True
        else:
            self._f = open(filename, "wb")
            self._close = True
        if self.type == UNKNOWN:
            if name.endswith(".fa"):
                self.type = FASTA
            elif name.endswith(".fq"):
                self.type = FASTQ
            else:
                self.type = BINARY
        if self.type != ONE and len(name) > 5 and name[-5] == "." and \
                name[-4] == "1":
            self.type = ONE  # .1xxx suffix implies ONE (seqio.c:381-383)
        if self.type == ONE:
            from .onecode import OneSeqWriter
            otype = "seq"
            if len(name) > 5 and name[-5] == "." and name[-4] == "1":
                otype = name[-3:]
            self._one = OneSeqWriter(self._f, qual_thresh > 0, otype)
        elif self.type == BINARY:
            if self._gz:
                raise IOError("can't write a gzipped binary file")
            self._f.write(b"\x00" * 64)  # header rewritten on close

    def write(self, seq_id, desc, seq, qual=None):
        """seq: bytes/str of sequence characters, or code array if the
        writer's convert table maps codes (e.g. index2char handling is done
        by the caller)."""
        if isinstance(seq, str):
            seq = seq.encode("latin1")
        if isinstance(seq, np.ndarray):
            seq = seq.astype(np.uint8).tobytes()
        id_b = (seq_id or "").encode("latin1")
        desc_b = desc.encode("latin1") if desc else None
        self.n_seq += 1
        self.tot_id += len(id_b)
        self.max_id = max(self.max_id, len(id_b))
        dl = len(desc_b) if desc_b else 0
        self.tot_desc += dl
        self.max_desc = max(self.max_desc, dl)
        self.tot_seq += len(seq)
        self.max_seq = max(self.max_seq, len(seq))

        conv = self.convert

        def convert_seq(s):
            if conv is None:
                return s
            arr = _full256(conv)[np.frombuffer(s, np.uint8)]
            return arr.astype(np.uint8).tobytes()  # in-place style: no drop

        if self.type == ONE:
            self._one.write(seq_id, desc, convert_seq(seq), qual)
        elif self.type == FASTA:
            out = b">" + id_b
            if desc_b is not None:
                out += b" " + desc_b
            out += b"\n" + convert_seq(seq) + b"\n"
            self._f.write(out)
        elif self.type == FASTQ:
            out = b"@" + id_b
            if desc_b is not None:
                out += b" " + desc_b
            out += b"\n" + convert_seq(seq) + b"\n+\n"
            if qual is None:
                out += b"!" * len(seq)
            else:
                q = np.asarray(qual, np.int16) + 33
                out += q.astype(np.uint8).tobytes()
            out += b"\n"
            self._f.write(out)
        else:  # binary
            codes = np.frombuffer(seq, np.uint8)
            table = _full256(conv if conv is not None else dna2index4Conv)
            codes = (table[codes] & 3).astype(np.uint8)
            packed = seq_pack(codes)
            n_bytes = len(id_b) + dl + 2 + len(packed)
            if self.is_qual:
                n_bytes += (len(seq) + 7) // 8
            pad = 3 - ((n_bytes + 3) % 4)
            rec = bytearray()
            rec += int(len(id_b)).to_bytes(4, "little")
            rec += int(dl).to_bytes(4, "little")
            rec += int(len(seq)).to_bytes(4, "little")
            rec += id_b + b"\x00"
            rec += (desc_b or b"") + b"\x00"
            rec += packed.tobytes()
            if self.is_qual:
                q = qual if qual is not None else np.zeros(len(seq), np.uint8)
                rec += qual_pack(q, self.qual_thresh).tobytes()
            rec += b"\x00" * pad
            self._f.write(bytes(rec))

    def close(self):
        if self.type == ONE:
            self._one.close()
        if self.type == BINARY:
            self._f.flush()
            self._f.seek(0)
            hdr = bytearray(64)
            hdr[0] = ord("b")
            hdr[1] = self.qual_thresh
            for i, v in enumerate([self.n_seq, self.tot_id, self.tot_desc,
                                   self.tot_seq, self.max_id, self.max_desc,
                                   self.max_seq]):
                hdr[8 + 8 * i:16 + 8 * i] = int(v).to_bytes(8, "little")
            self._f.write(bytes(hdr))
        if self._close:
            self._f.close()
        elif hasattr(self._f, "flush"):
            self._f.flush()
