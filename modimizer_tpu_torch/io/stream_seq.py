"""Parse-ahead FASTA/FASTQ streaming for the device scan pipeline.

The e2e modset build (modutils -a, modutils.c:19-49) spends ~20% of its
wall time parsing the input before the first chunk reaches the device.
This module turns the parse into a producer: the file is read and
record-boundary-split into segments, each segment parsed by the native
parser on a background thread (ctypes releases the GIL, so the parse
genuinely overlaps device compute and the table replay), and the parsed
(codes, offsets) batches stream into ModimizerScanner.scan_kmers_batches.

Segments split at record starts — '\\n>' for FASTA; every 4th line for
FASTQ (strict 4-line records, matching the reference's one-line-sequence
FASTQ grammar, seqio.c:302-332) — so every batch is whole reads and the
concatenated batches are byte-identical to a whole-file parse
(tests/test_stream_scan.py pins equality incl. on gzipped input).
"""

import gzip
import io
import os
import queue
import threading

import numpy as np

_SEG_BYTES = 64 << 20

# gz inputs whose ISIZE trailer is at or below this decode whole-buffer
# through libdeflate (1.6-1.9x zlib) on the producer thread; larger (or
# ISIZE-wrapped >4 GB) files stream through zlib to bound memory
_GZ_WHOLE_MAX = 1 << 30


def _parse_segment_fasta(data, conv):
    """Native FASTA parse of one segment -> (codes i8, offsets i64)."""
    from ..native import lib as native_lib
    L = native_lib()
    buf = np.frombuffer(data, np.uint8)
    n = len(buf)
    if n == 0:
        return np.zeros(0, np.int8), np.zeros(1, np.int64)
    n_rec = L.io_fasta_count(buf, n)
    codes = np.empty(n, np.int8)
    offsets = np.zeros(n_rec + 1, np.int64)
    hdr = np.zeros(2 * max(n_rec, 1), np.int64)
    nc = L.io_parse_fasta(buf, n, conv, codes, offsets, hdr)
    return codes[:nc], offsets


def _parse_segment_fastq(data, conv):
    """Native FASTQ parse (codes only) -> (codes i8, offsets i64)."""
    from ..native import lib as native_lib
    L = native_lib()
    buf = np.frombuffer(data, np.uint8)
    n = len(buf)
    if n == 0:
        return np.zeros(0, np.int8), np.zeros(1, np.int64)
    n_rec = L.io_fastq_count(buf, n)
    codes = np.empty(n, np.int8)
    offsets = np.zeros(n_rec + 1, np.int64)
    hdr = np.zeros(2 * max(n_rec, 1), np.int64)
    nc = L.io_parse_fastq(buf, n, conv.ctypes.data, 0, codes, offsets,
                          hdr, None)
    if nc < 0:  # pragma: no cover - codes-only parse never checks quals
        raise ValueError("FASTQ qual/seq length mismatch")
    return codes[:nc], offsets


def _cut_fasta(data):
    """Largest split point so data[:cut] ends a whole FASTA record
    (the remainder begins with '>'); -1 if none."""
    cut = data.rfind(b"\n>")
    return cut + 1 if cut >= 0 else -1


def _cut_fastq(data):
    """Largest split point on a 4-line (one-record) boundary; -1 if the
    segment holds less than one full record."""
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 0x0A)
    n4 = (len(nl) // 4) * 4
    if n4 == 0:
        return -1
    return int(nl[n4 - 1]) + 1


def iter_seq_batches(path, convert, seg_bytes=_SEG_BYTES, depth=2):
    """Yield (codes, offsets) batches of whole FASTA/FASTQ records from
    `path` (plain or gzipped), parsed ahead on a background thread.

    Raises ValueError before the first yield if the content is neither
    FASTA nor FASTQ (callers fall back to the generic reader)."""
    from .seqio import _full256
    conv = np.ascontiguousarray(_full256(convert), np.int16)
    f = open(path, "rb")
    head = f.read(2)
    f.seek(0)
    gz_whole = False
    if head[:2] == b"\x1f\x8b":
        from .fzio import _libdeflate
        f.seek(-4, 2)
        isize = int.from_bytes(f.read(4), "little")
        f.seek(0)
        limit = int(os.environ.get("MODIMIZER_GZ_WHOLE_MAX", _GZ_WHOLE_MAX))
        g = gzip.GzipFile(fileobj=f)
        head = g.read(1)
        if _libdeflate() and 0 < isize <= limit:
            # whole-buffer decode inside the producer: on this class of
            # single-core host decode CPU adds directly to wall time, so
            # the 1.6-1.9x libdeflate saving beats interleaved zlib
            gz_whole = True
            f.seek(0)
        else:
            g.seek(0)
            f = g
    if head[:1] == b">":
        cut_fn, parse_fn = _cut_fasta, _parse_segment_fasta
    elif head[:1] == b"@":
        cut_fn, parse_fn = _cut_fastq, _parse_segment_fastq
    else:
        f.close()
        raise ValueError(f"{path} is not FASTA/FASTQ")

    q = queue.Queue(maxsize=depth)
    _DONE = object()

    is_fastq = cut_fn is _cut_fastq

    def producer():
        src = f
        try:
            if gz_whole:
                from .fzio import gz_decompress_all
                comp = bytearray(f.read())
                f.close()
                src = io.BytesIO(gz_decompress_all(comp))
                del comp
            carry = b""
            nl_done = 0    # newlines already emitted in parsed segments
            while True:
                data = src.read(seg_bytes)
                if not data:
                    if carry:
                        # reference semantics: a final partial record is
                        # DROPPED with a message (seqio.c:216-219); the
                        # carry is exactly the final record (FASTA) /
                        # trailing partial group (FASTQ)
                        from .seqio import (FASTA as _FA, FASTQ as _FQ,
                                            incomplete_tail_fixup)
                        carry, n = incomplete_tail_fixup(
                            carry, _FQ if is_fastq else _FA)
                        if n is not None:
                            import sys as _sys
                            _sys.stderr.write(
                                "incomplete sequence record line %d\n"
                                % (nl_done + n))
                        if carry:
                            q.put(parse_fn(carry, conv))
                    break
                data = carry + data
                # split on a record boundary so the remainder starts a
                # record (a segment holding one giant record keeps
                # growing until its next record or EOF)
                cut = cut_fn(data)
                if cut < 0:
                    carry = data
                    continue
                seg, carry = data[:cut], data[cut:]
                nl_done += seg.count(b"\n")
                q.put(parse_fn(seg, conv))
            q.put(_DONE)
        except BaseException as e:  # surfaced in the consumer
            q.put(e)
        finally:
            src.close()
            if not f.closed:
                f.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _DONE:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def iter_fasta_batches(path, convert, seg_bytes=_SEG_BYTES, depth=2):
    """FASTA-only entry: like iter_seq_batches but rejects FASTQ too."""
    with open(path, "rb") as fh:
        head = fh.read(2)
    if head[:2] == b"\x1f\x8b":
        with gzip.open(path, "rb") as gh:
            head = gh.read(1)
    if head[:1] != b">":
        raise ValueError(f"{path} is not FASTA")
    return iter_seq_batches(path, convert, seg_bytes=seg_bytes, depth=depth)
