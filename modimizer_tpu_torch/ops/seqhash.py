"""Streaming modimizer scanner on PyTorch (port of
``modimizer_tpu/ops/seqhash.py::ModimizerScanner``).

Chunking, the carry buffer of ``scan_kmers_batches``, ``bo``/``cap`` and the
three overflow tiers (normal ``bo``, a 4x-wide device retry, an exact native
host rescan) are the JAX scanner's, so both packages produce the same rows
in the same stream order.

``scan_kmers``, ``scan_kmers_batches`` and ``scan_stream`` feed one chunk
pipeline (``_pipeline``); they differ only in where a chunk's codes and read
offsets come from (the whole stream, or the carry buffer) and in whether a
chunk yields k-mers alone or k-mers with positions and isF.  Per chunk:
``put_chunk`` packs the 2-bit stream and the chunk's validity bit-words into
one pinned host tensor and uploads it with one ``non_blocking`` copy;
``scan_chunk`` runs ``scan_compact`` and ``densify``, so no row whose k-mer
crosses a read boundary leaves the card; a ``non_blocking`` download of the
dense rows and the total into pinned memory is queued behind a CUDA event.
A chunk is read only after its event has completed, while up to
``max_inflight`` later chunks are already queued behind it.

Device policy (no hidden fallback):
  - ``device=None`` takes the CUDA card and raises without one
    (``require_cuda``), unless the caller asked for the host scan: then the
    scanner holds no device.
  - the native host scan runs only when asked for: ``host=True``, or
    ``MODIMIZER_SCAN=host`` when ``host`` is not given.  Every scan of such
    a scanner runs on the host, whatever its length.
  - an explicit ``torch.device("cpu")`` runs the kernels' plain PyTorch
    versions.
"""

import os

import numpy as np
import torch

from .. import require_cuda
from ..native import lib as native_lib
from ..utils import profiling
from .consts import BLK_COMPACT, BLOCK, scan_bo
from .device_scan import scan_chunk
from .scan_kernel import kernel_params

DEFAULT_CHUNK = 1 << 25     # 32 Mbase per device dispatch


def put_chunk(seg, vwords, device):
    """Pack a chunk's codes into 2-bit words and upload them with its
    validity words: one host tensor (pinned for a CUDA card), one
    ``non_blocking`` copy.  ``seg`` holds the chunk's C + k - 1 codes (fewer
    at the stream's end), ``vwords`` its C/64 u64 validity words; returns
    (sw int64 [C/32 + 2], vbits int64 [C/64]) on ``device``."""
    nv = len(vwords)
    nw = 2 * nv + 2
    host = torch.empty(nw + nv, dtype=torch.int64,
                       pin_memory=device.type == "cuda")
    h = host.numpy()
    native_lib().pk_pack2(np.ascontiguousarray(seg).view(np.uint8),
                          len(seg), h[:nw].view(np.uint64), nw)
    h[nw:] = vwords.view(np.int64)
    words = host.to(device, non_blocking=True)
    return words[:nw], words[nw:]


def first_encounter_unique(kmers: np.ndarray):
    """(unique kmers in first-encounter stream order, counts) — the exact
    insertion stream the reference's sequential table build would produce."""
    if len(kmers) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    uniq, first_idx, counts = np.unique(kmers, return_index=True,
                                        return_counts=True)
    order = np.argsort(first_idx, kind="stable")
    return uniq[order], counts[order].astype(np.uint32)


class ModimizerScanner:
    """Streams a flat base-code stream through the device scan and yields
    (kmers, global positions, isF) in exact stream order."""

    def __init__(self, sh, chunk: int = DEFAULT_CHUNK, device=None,
                 host: bool = None):
        if host is None:
            host = os.environ.get("MODIMIZER_SCAN") == "host"
        if device is not None:
            device = torch.device(device)
        elif not host:
            device = require_cuda()
        self.sh = sh
        self.kp = kernel_params(sh)
        self.device = device          # None: native host scan only
        self.chunk = max(BLOCK, (chunk // BLOCK) * BLOCK)
        self.bo = scan_bo(sh.w)
        # dense download rows: expected emits (chunk/w) + 12.5% (min 64K)
        # margin for skewed composition; overflow takes the wide retry
        self.cap = int(min((self.chunk // BLK_COMPACT) * self.bo,
                           max(4096, self.chunk // sh.w
                               + max(self.chunk // (8 * sh.w), 65536))))
        self.max_inflight = 4
        self.host = bool(host)        # every scan on the native host scan
        self.used_device = False      # set per scan call
        self.n_wide = 0               # chunks retried at 4x bo on device
        self.n_fallback = 0           # chunks that hit the native rescan

    def _wide(self):
        """bo/cap for the device-side overflow retry: 4x capacity handles
        emit bursts (e.g. poly-A runs, which emit at every position since
        kmer 0 hashes to 0) up to ~4x the 6-sigma margin without abandoning
        the chunk to the host rescan."""
        bo = int(min(BLK_COMPACT, self.bo * 4))
        cap = int(min((self.chunk // BLK_COMPACT) * bo, self.cap * 4))
        return bo, cap

    # ---- the native host scan ----

    def _scan_host(self, codes, offsets):
        """Whole-stream host scan via the native OpenMP rolling-hash kernel
        (native/modasm_native.cpp sh_scan_emit_reads): read-boundary-aware,
        so no separate validity pass is needed.  Returns (kmers, gpos,
        isF)."""
        sh = self.sh
        n = len(codes)
        if n < sh.k:
            return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                    np.zeros(0, bool))
        cap = max(4096, (n // sh.w) * 4 + 1024)
        L = native_lib()
        codes = np.ascontiguousarray(codes).view(np.uint8)
        offsets = np.ascontiguousarray(offsets, np.int64)
        while True:
            out_k = np.empty(cap, np.uint64)
            out_p = np.empty(cap, np.int64)
            out_f = np.empty(cap, np.uint8)
            cnt = L.sh_scan_emit_reads(codes, offsets, len(offsets) - 1,
                                       sh.k, sh.w, sh.factor1, sh.shift1,
                                       out_k, out_p, out_f, cap)
            if cnt >= 0:
                break
            cap = -cnt
        return (out_k[:cnt], out_p[:cnt], out_f[:cnt].astype(bool))

    def _rescan_rows(self, s, m, codes, offsets):
        """Exact per-chunk overflow fallback on the native OpenMP kernel.

        Read-boundary semantics match the device path's validity mask: a
        kmer at global pos p < s+m is emitted iff it lies fully inside one
        read.  Clipping offsets to the segment preserves that — clipped
        read *starts* can only move to s (every kmer here starts at >= s
        anyway) and clipped *ends* only cut kmers ending past s+m+k-2,
        which no kmer with pos < s+m does.  Returns (kmers, gpos, isF)."""
        k = self.sh.k
        seg = np.ascontiguousarray(codes[s:s + m + k - 1])
        lo = np.clip(offsets, s, s + len(seg)) - s
        kms, pos, isF = self._scan_host(seg, lo)
        keep = pos < m
        return kms[keep], pos[keep] + s, isF[keep]

    def scan_batch(self, batch):
        """Scan a SeqBatch; returns (kmers, read_ids, read_pos, isF)."""
        offsets = np.ascontiguousarray(batch.offsets, np.int64)
        kmers, gpos, isF = self.scan_stream(batch.codes, offsets)
        # gpos is ascending (stream order): one native walk beats
        # searchsorted + two np.repeat temporaries
        with profiling.span("scan.rid_rpos"):
            gpos = np.ascontiguousarray(gpos, np.int64)
            rid = np.empty(len(gpos), np.int64)
            rpos = np.empty(len(gpos), np.int64)
            native_lib().sh_rid_rpos(gpos, len(gpos), offsets,
                                     len(offsets) - 1, rid, rpos)
        return kmers, rid, rpos, isF

    # ---- the chunk pipeline ----

    def _require_device(self):
        if self.device is None:
            raise RuntimeError(
                "ModimizerScanner: this scanner was made for the host scan "
                "alone (MODIMIZER_SCAN=host or host=True) and holds no "
                "CUDA device for a device scan")
        self.used_device = True

    def _stream_chunks(self, codes, offsets):
        """The chunks of a whole stream: its validity words computed once,
        each chunk given its slice.  A chunk is (stream position, codes,
        offsets, its start in codes, its validity words)."""
        C = self.chunk
        n = len(codes)
        with profiling.span("scan.validity"):
            vwords = np.empty(max(1, -(-n // C)) * C // 64, np.uint64)
            native_lib().pk_valid_words(offsets, len(offsets) - 1, n,
                                        self.sh.k, vwords, len(vwords))
        for s in range(0, n, C):
            yield s, codes, offsets, s, vwords[s // 64:(s + C) // 64]

    def _batch_chunks(self, batches):
        """The chunks of a stream that arrives as (codes, offsets) batches
        of whole reads: a carry buffer holds the codes from the next
        chunk's start on, so chunk boundaries are those of the stream in
        one piece.  A chunk's validity words come from its window of the
        read offsets (clipped to it: see _rescan_rows)."""
        L = native_lib()
        k = self.sh.k
        C = self.chunk
        halo = k - 1
        NWB = (C + halo + 63) // 64      # validity words of a whole window
        buf = np.zeros(0, np.uint8)      # codes from stream position s on
        offs = np.zeros(1, np.int64)     # read offsets in buf's coordinates
        s = 0
        it = iter(batches)
        eof = False
        while True:
            while not eof and len(buf) < C + halo:
                try:
                    codes_b, offs_b = next(it)
                except StopIteration:
                    eof = True
                    break
                cb = np.ascontiguousarray(codes_b).view(np.uint8)
                ob = np.asarray(offs_b, np.int64)
                if len(ob) == 0 or ob[-1] != len(cb):
                    raise ValueError("scan_kmers_batches: batch offsets "
                                     "must cover whole reads")
                offs = np.concatenate([offs, ob[1:] + len(buf)])
                buf = np.concatenate([buf, cb]) if len(buf) else cb
            if not len(buf):
                return
            with profiling.span("scan.validity"):
                m_win = min(C + halo, len(buf))
                j = int(np.searchsorted(offs, m_win, side="left"))
                win = np.ascontiguousarray(np.clip(offs[:j + 1], 0, m_win))
                vw = np.empty(NWB, np.uint64)
                L.pk_valid_words(win, len(win) - 1, m_win, k, vw, NWB)
            yield s, buf, offs, 0, vw[:C // 64]
            s += C
            buf = buf[C:]
            j = max(int(np.searchsorted(offs, C, side="right")) - 1, 0)
            offs = offs[j:] - C

    def _launch(self, words, with_meta, wide=False):
        bo, cap = self._wide() if wide else (self.bo, self.cap)
        kp = self.kp
        return self._download(scan_chunk(
            *words, k=kp.k, w=kp.w, factor1=kp.factor1, bo=bo, cap=cap,
            with_meta=with_meta))

    def _download(self, tensors):
        """Queue device->host copies into pinned memory; returns a future
        for _wait.  On the CPU the tensors are already there."""
        if self.device.type != "cuda":
            return tensors, None
        outs = tuple(None if t is None else
                     torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t, non_blocking=True) for t in tensors)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return outs, ev

    @staticmethod
    def _wait(fut):
        outs, ev = fut
        if ev is not None:
            ev.synchronize()
        return outs

    def _pipeline(self, chunks, with_meta):
        """Scan ``chunks`` on the device, up to ``max_inflight`` queued
        behind the one being read, and yield each one's rows in stream
        order: its k-mers (u64), or (k-mers, global positions, isF) with
        ``with_meta``."""
        k = self.sh.k
        pending = []
        for chunk in chunks:
            _s, codes, _offsets, at, vw = chunk
            with profiling.span("scan.pack"):
                words = put_chunk(codes[at:at + self.chunk + k - 1], vw,
                                  self.device)
            with profiling.span("scan.dispatch"):
                pending.append((chunk, words,
                                self._launch(words, with_meta)))
            if len(pending) > self.max_inflight:
                yield self._drain(*pending.pop(0), with_meta)
        for entry in pending:
            yield self._drain(*entry, with_meta)

    def _drain(self, chunk, words, fut, with_meta):
        """Wait for a chunk and walk the overflow tiers: a wide retry on
        the device, then the exact host rescan."""
        s, codes, offsets, at, _vw = chunk
        with profiling.span("scan.download"):
            dk, dm, tot = self._wait(fut)
            tot = int(tot)
            if tot < 0:      # block or cap overflow: retry wide on device
                self.n_wide += 1
                dk, dm, tot = self._wait(self._launch(words, with_meta,
                                                      wide=True))
                tot = int(tot)
            if tot < 0:      # still overflowing: exact native host rescan
                self.n_fallback += 1
                kms, pos, isF = self._rescan_rows(
                    at, min(self.chunk, len(codes) - at), codes, offsets)
                return (kms, pos + (s - at), isF) if with_meta else kms
            kms = dk[:tot].numpy().view(np.uint64)
            if not with_meta:
                return kms
            meta = dm[:tot].numpy().view(np.uint32)
            return (kms, s + (meta >> 1).astype(np.int64),
                    (meta & 1).astype(bool))

    # ---- the entry points ----

    def scan_kmers(self, codes: np.ndarray, offsets: np.ndarray,
                   consumer=None):
        """Kmers-only scan of a whole stream in exact stream order,
        pipelined over chunks.  Returns the concatenated kmers if consumer
        is None, else the total emit count (consumer gets each chunk's
        kmers in order)."""
        codes = np.ascontiguousarray(codes).view(np.uint8)
        offsets = np.ascontiguousarray(offsets, np.int64)
        sink = _Sink(consumer)
        if self.host:
            self.used_device = False
            sink(self._scan_host(codes, offsets)[0])
            return sink.result()
        self._require_device()
        for kms in self._pipeline(self._stream_chunks(codes, offsets),
                                  False):
            sink(kms)
        return sink.result()

    def scan_kmers_batches(self, batches, consumer=None):
        """Streaming scan_kmers over (codes, offsets) batches of whole reads
        (e.g. io.stream_seq.iter_seq_batches): chunks ride a carry buffer
        across batches, so chunk boundaries, rows and stream order equal one
        scan_kmers call on the concatenated stream.  Returns total emits
        (consumer mode) or the concatenated kmers."""
        self._require_device()
        sink = _Sink(consumer)
        for kms in self._pipeline(self._batch_chunks(batches), False):
            sink(kms)
        return sink.result()

    def scan_stream(self, codes: np.ndarray, offsets: np.ndarray):
        """codes: uint8/int8 [N] (values 0..3), offsets: int64 [n_reads+1].
        Returns (kmers u64, global positions int64, isF bool) in stream
        order, of the k-mers that lie inside one read."""
        codes = np.ascontiguousarray(codes).view(np.uint8)
        offsets = np.ascontiguousarray(offsets, np.int64)
        if self.host:
            self.used_device = False
            out = self._scan_host(codes, offsets)
            profiling.count("scan.rows", len(out[0]))
            return out
        self._require_device()
        parts = list(self._pipeline(self._stream_chunks(codes, offsets),
                                    True))
        if not parts:
            return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                    np.zeros(0, bool))
        with profiling.span("scan.concat"):
            out = tuple(np.concatenate(p) for p in zip(*parts))
        profiling.count("scan.rows", len(out[0]))
        return out


class _Sink:
    """Hands each chunk's kmers to a consumer, or collects them."""

    def __init__(self, consumer):
        self.consumer = consumer
        self.parts = []
        self.total = 0

    def __call__(self, kms):
        self.total += len(kms)
        if self.consumer is None:
            self.parts.append(kms)
        else:
            with profiling.span("scan.consumer"):
                self.consumer(kms)

    def result(self):
        """The consumer's total, or the kmers; counted as ``scan.rows``."""
        profiling.count("scan.rows", self.total)
        if self.consumer is not None:
            return self.total
        return (np.concatenate(self.parts) if self.parts
                else np.zeros(0, np.uint64))
