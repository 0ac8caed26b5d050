"""Device-resident modset count on one device (port of the n = 1 path of
``modimizer_tpu/parallel/sharded.py``: ``_compact_core``, ``compact_local``
and ``ShardedModsetBuilder``).

The builder scans the stream chunk by chunk with ``scan_compact`` (the rows
stay on the device, in the kernel's stream-order blocks), folds the
buffered rows into a sorted state of (k-mer, depth, first position) when
they would pass ``max_buffer_rows`` and at the end, and returns the unique
k-mers with their counts in first-encounter order: the insertion stream of
the sequential build.  Overflow handling, the pending window, state growth,
snapshots and ``total_emitted`` are the JAX builder's.

The JAX n = 1 route scans in the stripe partition (stride-32 blocks), which
only changes which block a row is compacted in; the fold sorts, so the
state, ``finalize`` and ``total_emitted`` are the same.  ``bo`` can differ
from the JAX builder's after an overflow, since the two partitions can
overflow in different blocks.

u64 k-mers and positions ride in int64 tensors: the all-ones sentinel and
``POS_INF`` are -1.  Live k-mers are canonical (< 2^62) and live positions
below 2^63, so int64 order is their u64 order; the fold drops the sentinel
rows before it sorts.  Snapshots keep the JAX ``.npz`` layout (u64/u32
state of shape [1, S], the same ``meta`` vector), so one package resumes
the other's build.
"""

import math

import numpy as np
import torch

from .. import require_cuda
from ..native import lib as native_lib
from ..ops.scan_kernel import kernel_params, scan_compact
from ..ops.consts import BLK_COMPACT as BLK
from ..utils import profiling

SENTINEL = -1               # u64 0xFFFF...FF: no k-mer
POS_INF = -1                # u64 0xFFFF...FF: no position
DEPTH_MAX = 0xFFFF
_M32 = 0xFFFFFFFF
_I64_MAX = (1 << 63) - 1


def compact_core(sk, sd, sm, bk, bm, S: int):
    """Fold batch rows (k-mers ``bk``, positions ``bm``; each row counts 1)
    into the state (``sk``, depths ``sd``, first positions ``sm``): one row
    per live k-mer, ascending, with its summed depth saturated at 0xFFFF
    and its smallest position, sentinel-padded to S.  Returns (new_k int64
    [S], new_d int32 [S], new_m int64 [S], n_heads, overflow = n_heads >
    S)."""
    allk = torch.cat([sk, bk])
    live = allk != SENTINEL
    k = allk[live]
    d = torch.cat([sd.to(torch.int64),
                   (bk != SENTINEL).to(torch.int64)])[live]
    m = torch.cat([sm, bm])[live]
    uniq, inv = torch.unique(k, sorted=True, return_inverse=True)
    n = uniq.numel()
    depth = torch.zeros(n, dtype=torch.int64, device=k.device)
    depth.index_add_(0, inv, d)
    first = torch.full((n,), _I64_MAX, dtype=torch.int64, device=k.device)
    first.scatter_reduce_(0, inv, m, "amin")
    h = min(n, S)
    new_k = torch.full((S,), SENTINEL, dtype=torch.int64, device=k.device)
    new_d = torch.zeros(S, dtype=torch.int32, device=k.device)
    new_m = torch.full((S,), POS_INF, dtype=torch.int64, device=k.device)
    new_k[:h] = uniq[:h]
    new_d[:h] = depth[:h].clamp_(max=DEPTH_MAX).to(torch.int32)
    new_m[:h] = first[:h]
    return new_k, new_d, new_m, n, n > S


def compact_local(state_k, state_d, state_m, bases, recv_k, recv_p, *, S):
    """n = 1 fold: batches of (k-mers int64, chunk-local positions int32
    with -1 for none, as ``scan_compact`` leaves them), each with its chunk
    base in ``bases``, into the state."""
    bk = torch.cat(recv_k)
    bm = torch.cat([(p.to(torch.int64) & _M32) + int(b)
                    for p, b in zip(recv_p, bases)])
    bm = torch.where(bk != SENTINEL, bm, torch.full_like(bm, POS_INF))
    return compact_core(state_k, state_d, state_m, bk, bm, S)


def _one_device(device):
    """The builder's device: a torch.device or its name, or a list of one
    (the JAX builder's one-device mesh); None takes the CUDA card."""
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise NotImplementedError(
                "ShardedModsetBuilder: %d devices; the port counts on one "
                "(the routed multi-device build is not ported yet)"
                % len(device))
        device = device[0]
    return require_cuda() if device is None else torch.device(device)


class ShardedModsetBuilder:
    """Counts a stream's emitted k-mers on one device; ``finalize`` returns
    the exact first-encounter insertion stream.  ``n_compact`` counts the
    folds of buffered rows into the state (growth retries not counted),
    ``n_replay`` the chunks replayed at a wider ``bo``."""

    SNAP_VERSION = 1

    def __init__(self, sh, device=None, chunk_per_dev=1 << 22,
                 state_size=1 << 20, max_state_size=1 << 28,
                 max_buffer_rows=1 << 25):
        self.sh = sh
        self.kp = kernel_params(sh)
        self.device = _one_device(device)
        self.chunk = max(BLK, (chunk_per_dev // BLK) * BLK)
        self.S = state_size
        self.max_S = max_state_size
        self.max_buffer_rows = max_buffer_rows
        # routing slots of the multi-device build: unused at n = 1, kept
        # for the snapshot's meta
        self.cap = int(max(1024, 4 * self.chunk / sh.w))
        # emits per block ~ Binomial(BLK, 1/w): mean + 6 sigma
        mean = BLK // sh.w
        want = mean + 6 * max(1, math.isqrt(max(0, mean - 1)) + 1)
        self.bo = int(min(BLK, max(8, ((want + 7) // 8) * 8)))
        dev = self.device
        self.state_k = torch.full((self.S,), SENTINEL, dtype=torch.int64,
                                  device=dev)
        self.state_d = torch.zeros(self.S, dtype=torch.int32, device=dev)
        self.state_m = torch.full((self.S,), POS_INF, dtype=torch.int64,
                                  device=dev)
        self.recv_k = []        # buffered rows on the device
        self.recv_p = []
        self.bases = []         # chunk base of each batch
        self.total_emitted = 0
        self._pending = []      # (inputs, base, out) awaiting overflow check
        self.n_compact = 0
        self.n_replay = 0

    def _recv_rows(self):
        return (self.chunk // BLK) * self.bo

    def _widen(self):
        self.bo = min(BLK, self.bo * 2)

    def _grow(self, new_S):
        if new_S > self.max_S:
            raise RuntimeError("sharded modset state exceeds max_state_size")
        pad = new_S - self.S
        dev = self.device
        self.state_k = torch.cat([self.state_k, torch.full(
            (pad,), SENTINEL, dtype=torch.int64, device=dev)])
        self.state_d = torch.cat([self.state_d, torch.zeros(
            pad, dtype=torch.int32, device=dev)])
        self.state_m = torch.cat([self.state_m, torch.full(
            (pad,), POS_INF, dtype=torch.int64, device=dev)])
        self.S = new_S

    def _route(self, inputs):
        """scan_compact of one chunk: (k-mers, positions, n_emit,
        overflow) on the device."""
        sw, vb = inputs
        kp = self.kp
        out_k, out_p, _cnt, n_emit, overflow = scan_compact(
            sw, vb, k=kp.k, w=kp.w, factor1=kp.factor1, C=self.chunk,
            bo=self.bo, meta_isf=False)
        return out_k, out_p, n_emit, overflow

    def _append(self, out, base):
        self.recv_k.append(out[0])
        self.recv_p.append(out[1])
        self.bases.append(base)

    def _buffered_rows(self):
        return len(self.recv_k) * self._recv_rows()

    def _compact(self):
        self._check_pending(force=True)
        if not self.recv_k:
            return
        with profiling.stage("count.compact"):
            while True:
                out = compact_local(self.state_k, self.state_d, self.state_m,
                                    self.bases, self.recv_k, self.recv_p,
                                    S=self.S)
                if not out[4]:
                    break
                new_s = self.S * 2
                while new_s < out[3]:
                    new_s *= 2
                self._grow(new_s)
        self.state_k, self.state_d, self.state_m = out[:3]
        self.recv_k, self.recv_p, self.bases = [], [], []
        self.n_compact += 1

    def _check_pending(self, force=False, window=4):
        while self._pending and (force or len(self._pending) > window):
            inputs, base, out = self._pending.pop(0)
            if bool(out[3]):
                self._replay_overflow((inputs, base))
                continue
            self.total_emitted += int(out[2])

    def _replay_overflow(self, first):
        """A chunk overflowed a block (low-complexity input): drop its batch
        and every later uncommitted one, widen bo, scan them again."""
        replay = [first] + [(i, b) for (i, b, _o) in self._pending]
        self._pending = []
        n_drop = len(replay)
        del self.recv_k[-n_drop:]
        del self.recv_p[-n_drop:]
        del self.bases[-n_drop:]
        self._widen()
        for inputs, base in replay:
            while True:
                out = self._route(inputs)
                if not bool(out[3]):
                    break
                self._widen()
            self._append(out, base)
            self.total_emitted += int(out[2])
            self.n_replay += 1

    def _put(self, words):
        """u64 numpy words -> int64 on the device (pinned, non_blocking)."""
        host = torch.from_numpy(words.view(np.int64))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def feed_stream(self, codes: np.ndarray, offsets: np.ndarray,
                    base: int = 0):
        """Scan a flat host stream (codes 0..3, read offsets) chunk by chunk
        into the buffer; ``base`` is the stream position of codes[0]."""
        L = native_lib()
        k = self.sh.k
        n_total = len(codes)
        codes = np.ascontiguousarray(codes).view(np.uint8)
        offsets = np.ascontiguousarray(offsets, np.int64)
        C = self.chunk
        NW = C // 32
        n_chunks = max(1, -(-n_total // C))
        vwords = np.empty(n_chunks * C // 64, np.uint64)
        L.pk_valid_words(offsets, len(offsets) - 1, n_total, k, vwords,
                         len(vwords))
        for s in range(0, max(n_total, 1), C):
            with profiling.stage("count.pack"):
                seg = codes[s:s + C + k - 1]
                sw = np.empty(NW + 2, np.uint64)
                L.pk_pack2(np.ascontiguousarray(seg), len(seg), sw, NW + 2)
                inputs = (self._put(sw),
                          self._put(vwords[s // 64:s // 64 + C // 64]))
            with profiling.stage("count.scan"):
                out = self._route(inputs)
            if self._buffered_rows() + self._recv_rows() > self.max_buffer_rows:
                self._compact()
            self._append(out, base + s)
            self._pending.append((inputs, base + s, out))
            with profiling.stage("count.check"):
                self._check_pending()
        with profiling.stage("count.check"):
            self._check_pending(force=True)

    # ---------- snapshots: the JAX builder's .npz layout ----------

    def save(self, path, cursor: int = 0):
        """Snapshot the build (after flushing and compacting) to ``path``
        (.npz); ``cursor`` is the caller's stream position, returned by
        ``restore``."""
        self._compact()
        meta = np.array([self.SNAP_VERSION, self.sh.k, self.sh.w,
                         self.sh.seed, 1, self.S, self.bo, self.cap,
                         self.chunk, self.total_emitted, int(cursor)],
                        np.int64)
        ks = self.state_k.cpu().numpy().view(np.uint64).reshape(1, -1)
        ds = self.state_d.cpu().numpy().view(np.uint32).reshape(1, -1)
        ms = self.state_m.cpu().numpy().view(np.uint64).reshape(1, -1)
        with open(path, "wb") as f:
            np.savez(f, meta=meta, state_k=ks, state_d=ds, state_m=ms)

    @classmethod
    def restore(cls, path, sh, device=None, **kwargs):
        """Rebuild a builder from a snapshot of either package; returns
        (builder, cursor)."""
        with open(path, "rb") as f:
            d = np.load(f)
            meta = d["meta"]
            ks, ds, ms = d["state_k"], d["state_d"], d["state_m"]
        (ver, k, w, seed, n, S, bo, cap, chunk, total_emitted,
         cursor) = (int(x) for x in meta)
        if ver != cls.SNAP_VERSION:
            raise ValueError(f"{path}: snapshot version {ver} != "
                             f"{cls.SNAP_VERSION}")
        if (k, w, seed) != (sh.k, sh.w, sh.seed):
            raise ValueError(
                f"{path}: snapshot seqhash (k={k} w={w} seed={seed}) does "
                f"not match (k={sh.k} w={sh.w} seed={sh.seed})")
        if n != 1:
            raise ValueError(
                f"{path}: snapshot has {n} shards but the port builds on "
                f"one device — finalize + merge to re-shard")
        b = cls(sh, device, chunk_per_dev=chunk, state_size=S, **kwargs)
        b.bo, b.cap, b.total_emitted = bo, cap, total_emitted

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)
                                    .view(dtype)).to(b.device)
        b.state_k = put(ks, np.int64)
        b.state_d = put(ds, np.int32)
        b.state_m = put(ms, np.int64)
        return b, cursor

    def finalize(self):
        """(k-mers u64, counts u32) in first-encounter order: the insertion
        stream of the sequential build."""
        self._compact()
        with profiling.stage("count.download"):
            real = self.state_k != SENTINEL
            order = torch.argsort(self.state_m[real], stable=True)
            ks = self.state_k[real][order].cpu().numpy().view(np.uint64)
            ds = self.state_d[real][order].cpu().numpy().view(np.uint32)
        return ks, np.minimum(ds, DEPTH_MAX).astype(np.uint32)
