"""Device-resident modset count and merge over a shard mesh (port of
``modimizer_tpu/parallel/sharded.py``: ``_compact_core``, ``compact_local``,
``sharded_scan_route``, ``compact_sharded``, ``ShardedModsetBuilder``,
``sharded_merge_step`` and ``sharded_merge``).

The builder scans the stream chunk by chunk with ``scan_compact`` (the rows
stay on the device, in the kernel's stream-order blocks), folds the
buffered rows into a sorted state of (k-mer, depth, first position) when
they would pass ``max_buffer_rows`` and at the end, and returns the unique
k-mers with their counts in first-encounter order: the insertion stream of
the sequential build.  Overflow handling, the pending window, state growth,
snapshots and ``total_emitted`` are the JAX builder's.

Two paths, as in the JAX builder.  On a mesh without a process group (a
device) it keeps one state and folds chunk-local positions (JAX's n = 1
path).  On a mesh over a process group (``parallel/mesh.py``; one process
a device, every rank calling the same methods with the same arguments) it
is JAX's n > 1 path, at any size: rank r scans chunk ``s + r*C`` of each
super-chunk of ``n*C`` positions, routes each row to the rank that owns its
canonical hash (``route_rows``, ``csrc/route.cu``) with one
``all_to_all``, and keeps the state of the k-mers it owns.  Every decision
that changes the control flow (replay, widen, grow) comes from an
all-reduce, so it is the same on every rank, and every rank joins every
collective, a rank whose chunk starts past the stream's end too (it scans
zero words and emits nothing).  ``sharded_merge`` routes the two modsets'
rows by k-mer and reduces them with ``merge_reduce`` (``csrc/merge.cu``).

The JAX n = 1 route scans in the stripe partition (stride-32 blocks), which
only changes which block a row is compacted in; the fold sorts, so the
state, ``finalize`` and ``total_emitted`` are the same.  ``bo`` (and
``cap``) can differ from the JAX builder's after an overflow, since the two
partitions can overflow in different blocks.

u64 k-mers and positions ride in int64 tensors: the all-ones sentinel and
``POS_INF`` are -1.  Live k-mers are canonical (< 2^62) and live positions
below 2^63, so int64 order is their u64 order; the fold and the merge drop
the sentinel rows before they sort.  Snapshots keep the JAX ``.npz`` layout
(u64/u32 state of shape [n, S], the same ``meta`` vector), so one package
resumes the other's build on a mesh of the same size.
"""

import math

import numpy as np
import torch

from ..native import lib as native_lib
from ..ops.consts import BLK_COMPACT as BLK
from ..ops.merge import merge_reduce
from ..ops.route import gather_rows, route_rows
from ..ops.scan_kernel import kernel_params, scan_compact
from ..utils import profiling
from .mesh import as_mesh

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


def sharded_scan_route(sw, vbits, base, *, kp, cap, C, bo, mesh):
    """One rank's step of the routed build: scan_compact its chunk (stream
    position ``base``), route the rows to their owners (``route_rows``
    builder mode: global positions ``base + p``) and exchange them (one
    ``all_to_all``).  Returns (recv_k, recv_p) int64 [n*cap] (k-mers and
    global positions received, sentinel-padded), this rank's emit count
    and its overflow flag (a block's or an owner's capacity; the caller
    widens both)."""
    ck, cp, _cnt, n_emit, ovf = scan_compact(
        sw, vbits, k=kp.k, w=kp.w, factor1=kp.factor1, C=C, bo=bo,
        meta_isf=False)
    rt = route_rows(ck, mesh.n, cap, "builder", k=kp.k, w=kp.w,
                    factor1=kp.factor1, pos=cp, base=base)
    recv = mesh.all_to_all(torch.stack([rt.send_k, rt.send_p], 1))
    return recv[:, 0], recv[:, 1], n_emit, ovf | rt.overflow


def compact_sharded(state_k, state_d, state_m, recv_k, recv_p, *, S):
    """The routed fold: this rank's received batches (k-mers, global
    positions; sentinel-padded) into its state."""
    return compact_core(state_k, state_d, state_m, torch.cat(recv_k),
                        torch.cat(recv_p), S)


class ShardedModsetBuilder:
    """Counts a stream's emitted k-mers on a mesh (a ``Mesh``, or a device
    for one rank with no group); ``finalize`` returns the exact
    first-encounter insertion stream on every rank.  ``n_compact`` counts
    the folds of buffered rows into the state (growth retries not counted),
    ``n_replay`` the chunks replayed wider."""

    SNAP_VERSION = 1

    def __init__(self, sh, mesh=None, chunk_per_dev=1 << 22,
                 state_size=1 << 20, cap=None, max_state_size=1 << 28,
                 max_buffer_rows=1 << 25):
        self.sh = sh
        self.kp = kernel_params(sh)
        self.mesh = as_mesh(mesh)
        self.device = self.mesh.device
        self.n = self.mesh.n
        self.routed = self.mesh.distributed
        self.chunk = max(BLK, (chunk_per_dev // BLK) * BLK)
        self.S = state_size
        self.max_S = max_state_size
        self.max_buffer_rows = max_buffer_rows
        # routing slots per (sender, owner) pair: chunk / (w n) expected,
        # with a 4x margin; an overflow widens and replays
        self.cap = cap or int(max(1024, 4 * self.chunk / sh.w / self.n))
        if cap and not self.routed:
            want = cap * BLK // self.chunk
        else:
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
        if self.routed:
            return self.n * self.cap
        return (self.chunk // BLK) * self.bo

    def _widen(self):
        self.bo = min(BLK, self.bo * 2)
        if self.routed:
            self.cap *= 2

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

    def _route(self, inputs, base):
        """One chunk (stream position ``base``) scanned, and routed on a
        mesh: (k-mers, positions, n_emit, overflow) on the device."""
        sw, vb = inputs
        kp = self.kp
        if self.routed:
            return sharded_scan_route(sw, vb, base, kp=kp, cap=self.cap,
                                      C=self.chunk, bo=self.bo,
                                      mesh=self.mesh)
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
                if self.routed:
                    out = compact_sharded(self.state_k, self.state_d,
                                          self.state_m, self.recv_k,
                                          self.recv_p, S=self.S)
                    need = self.mesh.max(out[3])
                else:
                    out = compact_local(self.state_k, self.state_d,
                                        self.state_m, self.bases,
                                        self.recv_k, self.recv_p, S=self.S)
                    need = out[3]
                if need <= self.S:
                    break
                new_s = self.S * 2
                while new_s < need:
                    new_s *= 2
                self._grow(new_s)
        self.state_k, self.state_d, self.state_m = out[:3]
        self.recv_k, self.recv_p, self.bases = [], [], []
        self.n_compact += 1

    def _check_pending(self, force=False, window=4):
        while self._pending and (force or len(self._pending) > window):
            inputs, base, out = self._pending.pop(0)
            if self.mesh.any(out[3]):
                self._replay_overflow((inputs, base))
                continue
            self.total_emitted += self.mesh.sum(out[2])

    def _replay_overflow(self, first):
        """A chunk overflowed a block or an owner's slots (low-complexity
        input): drop its batch and every later uncommitted one, widen, scan
        them again."""
        replay = [first] + [(i, b) for (i, b, _o) in self._pending]
        self._pending = []
        n_drop = len(replay)
        del self.recv_k[-n_drop:]
        del self.recv_p[-n_drop:]
        del self.bases[-n_drop:]
        self._widen()
        for inputs, base in replay:
            while True:
                out = self._route(inputs, base)
                if not self.mesh.any(out[3]):
                    break
                self._widen()
            self._append(out, base)
            self.total_emitted += self.mesh.sum(out[2])
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
        into the buffer; ``base`` is the stream position of codes[0].  On a
        mesh, rank r takes chunk s + r*C of each super-chunk s."""
        step = self.n * self.chunk
        n_steps = max(1, -(-len(codes) // step))
        self._feed(codes, offsets, base, [s * step + self.mesh.rank
                                          * self.chunk
                                          for s in range(n_steps)])

    def _feed(self, codes, offsets, base, starts):
        """Scan the chunks of ``codes`` that start at ``starts`` (a chunk
        past the end scans zero words and emits nothing, but joins every
        collective), each at stream position ``base`` + its start."""
        L = native_lib()
        k = self.sh.k
        n_total = len(codes)
        codes = np.ascontiguousarray(codes).view(np.uint8)
        offsets = np.ascontiguousarray(offsets, np.int64)
        C = self.chunk
        NW = C // 32
        # pk_valid_words clears bits up to n_total: cover the whole stream
        vwords = np.empty(-(-max(max(starts) + C, n_total) // 64),
                          np.uint64)
        L.pk_valid_words(offsets, len(offsets) - 1, n_total, k, vwords,
                         len(vwords))
        for st in starts:
            with profiling.stage("count.pack"):
                seg = codes[st:st + C + k - 1]
                sw = np.empty(NW + 2, np.uint64)
                L.pk_pack2(np.ascontiguousarray(seg), len(seg), sw, NW + 2)
                inputs = (self._put(sw),
                          self._put(vwords[st // 64:st // 64 + C // 64]))
            with profiling.stage("count.scan"):
                out = self._route(inputs, base + st)
            if self._buffered_rows() + self._recv_rows() > self.max_buffer_rows:
                self._compact()
            self._append(out, base + st)
            self._pending.append((inputs, base + st, out))
            with profiling.stage("count.check"):
                self._check_pending()
        with profiling.stage("count.check"):
            self._check_pending(force=True)

    def _gathered(self):
        """The state of every rank, [n, S] each."""
        return tuple(self.mesh.all_gather(t)
                     for t in (self.state_k, self.state_d, self.state_m))

    # ---------- snapshots: the JAX builder's .npz layout ----------

    def save(self, path, cursor: int = 0):
        """Snapshot the build (after flushing and compacting) to ``path``
        (.npz); ``cursor`` is the caller's stream position, returned by
        ``restore``.  On a mesh every rank calls it (the state gather is
        collective) and rank 0 writes."""
        self._compact()
        ks, ds, ms = (t.cpu().numpy() for t in self._gathered())
        if self.mesh.rank == 0:
            meta = np.array([self.SNAP_VERSION, self.sh.k, self.sh.w,
                             self.sh.seed, self.n, self.S, self.bo,
                             self.cap, self.chunk, self.total_emitted,
                             int(cursor)], np.int64)
            with open(path, "wb") as f:
                np.savez(f, meta=meta, state_k=ks.view(np.uint64),
                         state_d=ds.view(np.uint32),
                         state_m=ms.view(np.uint64))
        self.mesh.barrier()                 # the file is written

    @classmethod
    def restore(cls, path, sh, mesh=None, **kwargs):
        """Rebuild a builder from a snapshot of either package on a mesh of
        its size (rank r takes shard r); returns (builder, cursor)."""
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
        mesh = as_mesh(mesh)
        if n != mesh.n:
            raise ValueError(
                f"{path}: snapshot has {n} shards but the mesh has "
                f"{mesh.n} — finalize + merge to re-shard")
        b = cls(sh, mesh, chunk_per_dev=chunk, state_size=S, **kwargs)
        b.bo, b.cap, b.total_emitted = bo, cap, total_emitted
        r = mesh.rank

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a[r]).view(dtype)
                                    ).to(b.device)
        b.state_k = put(ks, np.int64)
        b.state_d = put(ds, np.int32)
        b.state_m = put(ms, np.int64)
        return b, cursor

    def finalize(self):
        """(k-mers u64, counts u32) in first-encounter order: the insertion
        stream of the sequential build (on every rank of a mesh)."""
        self._compact()
        with profiling.stage("count.download"):
            ks, ds, ms = (t.reshape(-1) for t in self._gathered())
            real = ks != SENTINEL
            order = torch.argsort(ms[real], stable=True)
            ks = ks[real][order].cpu().numpy().view(np.uint64)
            ds = ds[real][order].cpu().numpy().view(np.uint32)
        return ks, np.minimum(ds, DEPTH_MAX).astype(np.uint32)


# ------------------------------------------------------------------
# the sharded modset merge: modutils -m / modsetMerge (modset.c:106-128)
# distributed by k-mer over the mesh
# ------------------------------------------------------------------

def sharded_merge_step(kmers, depth, info, rank, *, cap, mesh):
    """One rank's merge step: its [cap] rows (k-mer int64, sentinel-padded;
    depth and info u32 in int32, B's rows marked by info bit 8; rank int64)
    routed to the rank that owns each k-mer (``route_rows`` merge mode, one
    ``all_to_all``), the live rows received sorted by k-mer, and reduced
    with modsetMerge's math (``merge_reduce``).  Returns (k-mers, depth,
    info, rank) [n*cap], heads in k-mer order then pads, and the overflow
    flag."""
    n_shards = mesh.n
    rt = route_rows(kmers, n_shards, cap, "merge")
    cols = torch.stack([gather_rows(rt.index, kmers, SENTINEL),
                        gather_rows(rt.index, depth.to(torch.int64), 0),
                        gather_rows(rt.index, info.to(torch.int64), 0),
                        gather_rows(rt.index, rank, POS_INF)], 1)
    recv = mesh.all_to_all(cols)
    recv = recv[recv[:, 0] != SENTINEL]
    recv = recv[torch.sort(recv[:, 0]).indices]
    out = merge_reduce(recv[:, 0].contiguous(),
                       recv[:, 1].to(torch.int32).contiguous(),
                       recv[:, 2].to(torch.int32).contiguous(),
                       recv[:, 3].contiguous(), n_shards * cap)
    return (*out[:4], rt.overflow)


def sharded_merge(ms1, ms2, mesh=None):
    """Device modsetMerge on a mesh (every rank calls it with the same
    modsets): returns (kmers u64, depth u16, info u8) in the exact
    first-encounter order of the sequential merge (ms1's ids, then ms2's
    new k-mers in ms2's id order), on every rank; the caller replays them
    into a canonical table.  None when the hashers differ, like modsetMerge
    (modset.c:110-111)."""
    s1, s2 = ms1.hasher, ms2.hasher
    if s1.w != s2.w or s1.k != s2.k or s1.factor1 != s2.factor1:
        return None
    mesh = as_mesh(mesh)
    n, r = mesh.n, mesh.rank
    n1, n2 = ms1.max, ms2.max
    total = n1 + n2
    cap = max(1024, -(-total // n))  # slots a rank
    with profiling.stage("merge.rows"):
        lo, hi = r * cap, (r + 1) * cap

        def mine(a, b, fill, dtype, b_mark=0):
            """Rows [lo, hi) of A's entries then B's (B's ORed with
            ``b_mark``), padded with ``fill``, on the device."""
            out = np.full(cap, fill, dtype)
            a_hi = max(lo, min(hi, n1))
            out[:a_hi - lo] = a[lo + 1:a_hi + 1]
            b_lo = max(lo, n1)
            b_hi = max(b_lo, min(hi, total))
            out[b_lo - lo:b_hi - lo] = b[b_lo - n1 + 1:b_hi - n1 + 1]
            out[b_lo - lo:b_hi - lo] |= b_mark
            return torch.from_numpy(out).to(mesh.device)
        kmers = mine(ms1.value.view(np.int64), ms2.value.view(np.int64),
                     SENTINEL, np.int64)
        depth = mine(ms1.depth, ms2.depth, 0, np.int32)
        info = mine(ms1.info, ms2.info, 0, np.int32, 0x100)
        rank = torch.arange(lo, hi, dtype=torch.int64, device=mesh.device)
        rank[max(0, total - lo):] = POS_INF
    with profiling.stage("merge.device"):
        out = sharded_merge_step(kmers, depth, info, rank, cap=cap,
                                 mesh=mesh)
        if mesh.any(out[4]):
            raise RuntimeError("sharded merge shard overflow; raise cap")
    with profiling.stage("merge.gather"):
        # the heads lead each rank's columns: gather as many rows as the
        # fullest rank holds, order them by rank on the device, and
        # download each column in its own width
        h = mesh.max(int((out[0] != SENTINEL).sum()))
        got = mesh.all_gather(torch.stack(
            [out[0][:h], out[1][:h].to(torch.int64),
             out[2][:h].to(torch.int64), out[3][:h]], 1)).reshape(-1, 4)
        got = got[got[:, 0] != SENTINEL]
        got = got[torch.argsort(got[:, 3], stable=True)]
        kmers = got[:, 0].cpu().numpy().view(np.uint64)
        depth = got[:, 1].to(torch.int32).cpu().numpy()
        info = got[:, 2].to(torch.uint8).cpu().numpy()
    return kmers, np.minimum(depth, 0xFFFF).astype(np.uint16), info
