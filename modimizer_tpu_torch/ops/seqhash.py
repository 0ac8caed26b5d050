"""Streaming modimizer scanner on PyTorch (port of
``modimizer_tpu/ops/seqhash.py::ModimizerScanner``).

Chunking, the carry buffer of ``scan_kmers_batches``, ``bo``/``cap`` and the
three overflow tiers (normal ``bo``, a 4x-wide device retry, an exact native
host rescan) are the JAX scanner's, so both packages produce the same rows
in the same stream order.  Per chunk: pack the 2-bit stream and the validity
bit-words into pinned host tensors, upload them with ``non_blocking``
copies, run ``scan_compact`` and ``densify``, queue a ``non_blocking``
download of the dense rows and the total into pinned memory, and record a
CUDA event.  A chunk is read only after its event has completed, while up to
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
from .device_scan import scan_chunk, scan_kmers_body
from .scan_kernel import kernel_params

# 32 Mbase per device dispatch (the JAX scanner's MODIMIZER_CHUNK)
DEFAULT_CHUNK = int(os.environ.get("MODIMIZER_CHUNK", str(1 << 25)))


def _validity_filter(gpos: np.ndarray, offsets: np.ndarray, k: int):
    """Keep emitted positions whose k-mer lies inside one read."""
    rid = np.searchsorted(offsets, gpos, side="right") - 1
    ok = (rid >= 0) & (gpos + k <= offsets[np.minimum(rid + 1,
                                                      len(offsets) - 1)])
    ok &= rid < len(offsets) - 1
    return ok, rid


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
                 host: bool = None, want_isf: bool = True):
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
        self.want_isf = want_isf      # kept as the JAX scanner keeps it
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

    # ---- host <-> device ----

    def _host_buf(self, n):
        return torch.empty(n, dtype=torch.int64,
                           pin_memory=self.device.type == "cuda")

    def _put_sw(self, seg):
        """2-bit pack a segment (C + k - 1 codes) into C/32 + 2 words on
        the device."""
        nw = self.chunk // 32 + 2
        host = self._host_buf(nw)
        native_lib().pk_pack2(np.ascontiguousarray(seg).view(np.uint8),
                              len(seg), host.numpy().view(np.uint64), nw)
        return host.to(self.device, non_blocking=True)

    def _put_words(self, words):
        host = self._host_buf(len(words))
        host.numpy()[:] = words.view(np.int64)
        return host.to(self.device, non_blocking=True)

    def _download(self, tensors):
        """Queue device->host copies into pinned memory; returns a future
        for _wait.  On the CPU the tensors are already there."""
        if self.device.type != "cuda":
            return tensors, None
        outs = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
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

    # ---- kmers-only chunks (modutils -a) ----

    def _launch_kmers(self, sw, vb, wide=False):
        bo, cap = self._wide() if wide else (self.bo, self.cap)
        kp = self.kp
        return self._download(scan_kmers_body(
            sw, vb, k=kp.k, w=kp.w, factor1=kp.factor1, bo=bo, cap=cap))

    def _finish_kmers(self, fut, sw, vb, rescan):
        """Wait for a chunk and walk the overflow tiers; returns its kmers
        (u64, stream order)."""
        with profiling.span("scan.download"):
            dk, tot = self._wait(fut)
            tot = int(tot)
            if tot < 0:      # block or cap overflow: retry wide on device
                self.n_wide += 1
                dk, tot = self._wait(self._launch_kmers(sw, vb, wide=True))
                tot = int(tot)
            if tot < 0:      # still overflowing: exact native host rescan
                self.n_fallback += 1
                return rescan()
            return dk[:tot].numpy().view(np.uint64)

    def _require_device(self):
        if self.device is None:
            raise RuntimeError(
                "ModimizerScanner: this scanner was made for the host scan "
                "alone (MODIMIZER_SCAN=host or host=True) and holds no "
                "CUDA device for a device scan")
        self.used_device = True

    def scan_kmers(self, codes: np.ndarray, offsets: np.ndarray,
                   consumer=None):
        """Kmers-only scan of a whole stream in exact stream order,
        pipelined over chunks.  Returns the concatenated kmers if consumer
        is None, else the total emit count (consumer gets each chunk's
        kmers in order)."""
        k = self.sh.k
        n = len(codes)
        codes = np.ascontiguousarray(codes).view(np.uint8)
        offsets = np.asarray(offsets, np.int64)
        sink = _Sink(consumer)
        if self.host:
            self.used_device = False
            sink(self._scan_host(codes, offsets)[0])
            return sink.result()
        self._require_device()
        C = self.chunk
        n_chunks = max(1, -(-n // C))
        with profiling.span("scan.validity"):
            vwords = np.empty(n_chunks * C // 64, np.uint64)
            native_lib().pk_valid_words(offsets, len(offsets) - 1, n, k,
                                        vwords, len(vwords))

        def drain(entry):
            s, sw, vb, fut = entry
            sink(self._finish_kmers(
                fut, sw, vb,
                lambda: self._rescan_rows(s, min(C, n - s), codes,
                                          offsets)[0]))

        pending = []
        for s in range(0, n, C):
            with profiling.span("scan.pack"):
                sw = self._put_sw(codes[s:s + C + k - 1])
                vb = self._put_words(vwords[s // 64:s // 64 + C // 64])
            with profiling.span("scan.dispatch"):
                pending.append((s, sw, vb, self._launch_kmers(sw, vb)))
            if len(pending) > self.max_inflight:
                drain(pending.pop(0))
        for entry in pending:
            drain(entry)
        return sink.result()

    def scan_kmers_batches(self, batches, consumer=None):
        """Streaming scan_kmers over (codes, offsets) batches of whole reads
        (e.g. io.stream_seq.iter_seq_batches): chunks ride a carry buffer
        across batches, so chunk boundaries, rows and stream order equal one
        scan_kmers call on the concatenated stream.  Validity is computed
        per chunk from a clipped offsets window.  Returns total emits
        (consumer mode) or the concatenated kmers."""
        self._require_device()
        L = native_lib()
        k = self.sh.k
        C = self.chunk
        halo = k - 1
        NWV = C // 64                    # validity words the device reads
        NWB = (C + halo + 63) // 64      # buffer incl. halo positions
        sink = _Sink(consumer)
        pending = []
        buf = np.zeros(0, np.uint8)
        base = 0                         # absolute stream position of buf[0]
        offs = np.zeros(1, np.int64)     # absolute read offsets
        n_in = 0                         # absolute codes ingested
        eof = False
        s = 0                            # next chunk start (absolute)

        def win_valid(sa, m_win):
            j0 = max(int(np.searchsorted(offs, sa, side="right")) - 1, 0)
            j1 = int(np.searchsorted(offs, sa + m_win, side="left"))
            oo = np.ascontiguousarray(
                np.clip(offs[j0:j1 + 1], sa, sa + m_win) - sa)
            vw = np.zeros(NWB, np.uint64)
            L.pk_valid_words(oo, len(oo) - 1, m_win, k, vw, NWB)
            return vw[:NWV]

        def dispatch(sa):
            seg = buf[sa - base:sa - base + C + halo]
            with profiling.span("scan.pack"):
                sw = self._put_sw(seg)
                vb = self._put_words(win_valid(sa, len(seg)))
            with profiling.span("scan.dispatch"):
                return sw, vb, self._launch_kmers(sw, vb)

        def rescan_window(sa):
            # exact host rescan of the chunk window (clipping argument: see
            # _rescan_rows)
            rel = sa - base
            m = min(C, n_in - sa)
            seg = np.ascontiguousarray(buf[rel:rel + m + halo])
            lo = np.clip(offs, sa, sa + len(seg)) - sa
            kms, pos, _ = self._scan_host(seg, lo)
            return kms[pos < m]

        def drain(entry):
            sa, (sw, vb, fut) = entry
            sink(self._finish_kmers(fut, sw, vb, lambda: rescan_window(sa)))

        it = iter(batches)
        while True:
            while not eof and n_in - s < C + halo:
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
                offs = np.concatenate([offs, ob[1:] + n_in])
                buf = np.concatenate([buf, cb])
                n_in += len(cb)
            if s >= n_in:
                break
            pending.append((s, dispatch(s)))
            s += C
            if len(pending) > self.max_inflight:
                drain(pending.pop(0))
                # trim consumed bytes; the oldest pending chunk's window
                # stays resident for its host rescan
                cut = (pending[0][0] if pending else s) - base
                if cut > (64 << 20):
                    buf = buf[cut:]
                    base += cut
                    j = max(int(np.searchsorted(offs, base,
                                                side="right")) - 1, 0)
                    offs = offs[j:]
        for entry in pending:
            drain(entry)
        return sink.result()

    # ---- meta chunks (scan_stream, modutils -P) ----

    def scan_stream(self, codes: np.ndarray, offsets: np.ndarray):
        """codes: uint8/int8 [N] (values 0..3), offsets: int64 [n_reads+1].
        Returns (kmers u64, global positions int64, isF bool) in stream
        order, read-boundary filtered."""
        k = self.sh.k
        n = len(codes)
        codes = np.ascontiguousarray(codes).view(np.uint8)
        offsets = np.asarray(offsets, np.int64)
        if self.host:
            self.used_device = False
            out = self._scan_host(codes, offsets)
            profiling.count("scan.rows", len(out[0]))
            return out
        self._require_device()
        C = self.chunk
        kp = self.kp
        out_k, out_p, out_f = [], [], []

        def launch(sw, m, wide=False):
            bo, cap = self._wide() if wide else (self.bo, self.cap)
            return self._download(scan_chunk(
                sw, m, k=kp.k, w=kp.w, factor1=kp.factor1, bo=bo, cap=cap))

        def drain(entry):
            s, m, sw, fut = entry
            with profiling.span("scan.download"):
                km, meta, total = self._wait(fut)
                total = int(total)
                if total < 0:    # block or cap overflow: retry wide
                    self.n_wide += 1
                    km, meta, total = self._wait(launch(sw, m, wide=True))
                    total = int(total)
                if total < 0:    # still overflowing: exact host rescan
                    self.n_fallback += 1
                    kms, gpos, isF = self._rescan_rows(s, m, codes, offsets)
                else:
                    kms = km[:total].numpy().view(np.uint64)
                    meta = meta[:total].numpy().view(np.uint32)
            if total >= 0:
                with profiling.span("scan.validity"):
                    gpos = s + (meta >> 1).astype(np.int64)
                    isF = (meta & 1).astype(bool)
                    ok, _rid = _validity_filter(gpos, offsets, k)
                    kms, gpos, isF = kms[ok], gpos[ok], isF[ok]
            out_k.append(kms)
            out_p.append(gpos)
            out_f.append(isF)

        pending = []
        for s in range(0, n, C):
            m = min(C, n - s)
            with profiling.span("scan.pack"):
                sw = self._put_sw(codes[s:s + C + k - 1])
            with profiling.span("scan.dispatch"):
                pending.append((s, m, sw, launch(sw, m)))
            if len(pending) > self.max_inflight:
                drain(pending.pop(0))
        for entry in pending:
            drain(entry)
        if not out_k:
            return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                    np.zeros(0, bool))
        with profiling.span("scan.concat"):
            out = (np.concatenate(out_k), np.concatenate(out_p),
                   np.concatenate(out_f))
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
