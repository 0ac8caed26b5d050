r"""overlap_pairs at modasm's config-5 shape, timed on the card step by
step and beside an earlier version of its kernels.

  config5   9,283 reads of 483 mods (15 kbp / 31) tiling a genome of
            149,730 mods (E. coli K-12's 4,641,652 bp / 31), 95 % of the
            mods copy 1: ~4.48 M hit rows, ~30 rows a copy-1 mod
  tiled     60 reads of 40 mods over 300 (a quick check)

``--baseline SRC.cu`` compiles SRC as it stands (nvcc with the port's
flags) into a library of its own in ``SRC``'s directory, ``_build/``, and
runs the step as the port made it around that source's two launches
(``mz_overlap_count``: h, first, n, krank, cnt, max_group, stream;
``mz_overlap_emit``: xs, js, st, krank, cnt, incl, n, key, rank, agree,
stream): the stable ``torch.sort`` of the rows, the count launch, a
``cumsum`` and one read of the total, the emit launch that writes every
pair row, and the sort and segment reduce of the pair keys.  For example
the source at an earlier commit::

    git show REV:modimizer_tpu_torch/csrc/overlaps.cu > old/overlaps.cu
    python -m modimizer_tpu_torch.probes.probe_overlaps \
        --baseline old/overlaps.cu

Each version is held against ``overlap_pairs_ref``, and so is the current
one with its table's capacity lowered to ``SMALL_CAP`` (the overflow
path); then the whole calls are timed in turns (baseline, current, current,
baseline), CUDA events with the launches queued behind a sleep, and each
call's peak of allocated device memory is read (``max_memory_allocated``
after ``reset_peak_memory_stats``, less what was allocated before).  The
current call's steps are timed apart: step A (the ``torch.sort`` and the
groups launch, and the sort alone), step B (the count pass and the emit
pass), and the overflow path at the lowered capacity.  One JSON line per
shape: each time, the distinct pairs, the pair rows the baseline stores,
the bound (the inputs read once and the distinct pairs written once), the
current call's share of it and its speed-up over the baseline.  A
disagreement exits non-zero.
"""

import argparse
import ctypes
import json
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .. import _build
from ..parallel import overlaps as ov
from . import resolve_device
from ._timing import bound_ms, card_line, nbytes, time_ms

SEED = 17
# name: (reads, mods a read, mods in the genome)
SHAPES = {"config5": (9_283, 15_000 // 31, 4_641_652 // 31),
          "tiled": (60, 40, 300)}
SMALL_CAP = 16              # a table capacity that forces the overflow path


class FakeReadset:
    """What overlap_counts reads of a readset: hits (mod | strand << 31),
    hit_off, and the modset's info and depth."""

    def __init__(self, reads, info, strand):
        h = (np.concatenate(reads).astype(np.uint32) if reads
             else np.zeros(0, np.uint32))
        self.hits = h | (strand.astype(np.uint32) << np.uint32(31))
        self.hit_off = np.concatenate(
            [[0, 0], np.cumsum([len(r) for r in reads])]).astype(np.int64)
        depth = np.bincount(h, minlength=len(info)).astype(np.uint16)
        self.ms = SimpleNamespace(info=info, depth=depth)


def overlap_readset(rng, case, n_reads=60, mods_per_read=40, n_mods=300):
    """Hit rows for the overlap kernel: reads that tile a genome of mods
    (read 0 burned, every other read reversed, 95 % of the mods copy 1,
    0.2 % of the hits repeating the one before: the n_repeat path), or one
    edge: no copy-1 row, groups of one row, a group of more than 64 rows,
    every row of a group on one read."""
    info = (1 + 2 * (rng.random(n_mods + 1) >= 0.95)).astype(np.uint8)
    if case == "no_copy1":
        info[:] = 2
    if case == "singletons":
        reads = [np.arange(1, n_mods + 1)[r::n_reads]
                 for r in range(n_reads)]
    elif case == "big_group":
        reads = [np.array([5, rng.integers(6, n_mods + 1), 5 if r % 7 else 6])
                 for r in range(100)]
    elif case == "one_read":
        reads = [np.array([3, 9, 3, 3, 12, 3, 3]), np.array([9, 12, 3]),
                 np.array([3])]
    else:
        starts = rng.integers(1, n_mods - mods_per_read, n_reads)
        reads = []
        for r, s in enumerate(starts):
            m = np.arange(s, s + mods_per_read)
            dup = np.nonzero(rng.random(len(m)) < 0.002)[0]
            m[dup[dup > 0]] = m[dup[dup > 0] - 1]
            reads.append(m[::-1] if r % 2 else m)
    mod_bit = rng.integers(0, 2, n_mods + 1)
    strand = np.concatenate([mod_bit[r] ^ (i % 2) for i, r in
                             enumerate(reads)]) if reads else np.zeros(0)
    return FakeReadset(reads, info, strand)


def overlap_rows_on(rs, dev):
    """overlap_pairs' inputs for read set ``rs`` on ``dev``, as
    overlap_counts uploads them."""
    return [torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32 if a.dtype == np.uint32 else np.uint8)).to(dev)
        for a in ov.overlap_inputs(rs)[0]]


def shape_rows(name, dev):
    n_reads, per_read, n_mods = SHAPES[name]
    return overlap_rows_on(overlap_readset(
        np.random.default_rng(SEED), name, n_reads=n_reads,
        mods_per_read=per_read, n_mods=n_mods), dev)


def overlap_bytes(rows, n_pairs):
    """The inputs read once and the distinct pairs (four int64) written
    once."""
    return nbytes(*rows) + 32 * n_pairs


def load_baseline(src):
    """Build ``src`` into its own library and declare the interface of the
    count and emit launches."""
    L = _build.build_aside(src)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    L.mz_overlap_count.restype = ctypes.c_int
    L.mz_overlap_count.argtypes = [p, p, i64, p, p, p, p]
    L.mz_overlap_emit.restype = ctypes.c_int
    L.mz_overlap_emit.argtypes = [p, p, p, p, p, p, i64, p, p, p, p]
    return L


def baseline_pair_rows(L, h, xs, js, st, first):
    """Every pair row through the baseline's two launches."""
    n, dev = h.shape[0], h.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    krank = torch.empty(n, dtype=torch.int32, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    mg = torch.zeros(1, dtype=torch.int32, device=dev)
    if L.mz_overlap_count(h.data_ptr(), first.data_ptr(), n,
                          krank.data_ptr(), cnt.data_ptr(), mg.data_ptr(),
                          stream):
        raise RuntimeError("baseline overlap count failed")
    incl = torch.cumsum(cnt, 0)
    total, max_group = torch.stack([incl[-1], mg[0].to(torch.int64)]
                                   ).tolist()
    key = torch.empty(total, dtype=torch.int64, device=dev)
    rank = torch.empty(total, dtype=torch.int64, device=dev)
    agree = torch.empty(total, dtype=torch.uint8, device=dev)
    if total and L.mz_overlap_emit(
            xs.data_ptr(), js.data_ptr(), st.data_ptr(), krank.data_ptr(),
            cnt.data_ptr(), incl.data_ptr(), n, key.data_ptr(),
            rank.data_ptr(), agree.data_ptr(), stream):
        raise RuntimeError("baseline overlap emit failed")
    return key, rank, agree, max(1, max_group)


def baseline_overlap_pairs(L, *rows):
    return ov._overlap_pairs(lambda *srt: baseline_pair_rows(L, *srt),
                             *rows)


def peak_bytes(fn):
    """Device bytes allocated at the peak of one call of ``fn``, above what
    was allocated before it."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def step_times(rows, cap):
    """Device ms of the current call's steps (overlap_join's sequence)."""
    xs, js, hs, strand, is_c1, firstc1 = rows
    n, dev = xs.shape[0], xs.device
    r = (xs, js, ov._u8(strand), ov._u8(firstc1))
    grp, yb, _mg = ov.group_rows(xs, hs, r[2], is_c1)
    g = (grp, yb)
    dcnt = torch.zeros(n, dtype=torch.int32, device=dev)
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    nflag = torch.zeros(1, dtype=torch.int32, device=dev)

    def count():
        dcnt.zero_()
        nflag.zero_()
        ov.join_pass(r, g, cap, dcnt, flags, nflag)

    count()
    incl = torch.cumsum(dcnt, 0)
    total = int(incl[-1])
    out = tuple(torch.empty(total, dtype=torch.int64, device=dev)
                for _ in range(4))
    return {
        "sort_ms": time_ms(lambda: torch.sort(ov.sort_key(hs, is_c1),
                                              stable=True))[0],
        "step_a_ms": time_ms(lambda: ov.group_rows(xs, hs, r[2],
                                                   is_c1))[0],
        "count_ms": time_ms(count)[0],
        "emit_ms": time_ms(lambda: ov.join_pass(r, g, cap, dcnt, incl=incl,
                                                out=out))[0],
        "flagged": int(nflag[0])}


def overflow_times(rows, cap):
    """The overflow path at table capacity ``cap``: its count and emit
    launches' device ms and the reads that took it."""
    xs, js, hs, strand, is_c1, firstc1 = rows
    n, dev = xs.shape[0], xs.device
    r = (xs, js, ov._u8(strand), ov._u8(firstc1))
    grp, yb, _mg = ov.group_rows(xs, hs, r[2], is_c1)
    g = (grp, yb)
    dcnt = torch.zeros(n, dtype=torch.int32, device=dev)
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    nflag = torch.zeros(1, dtype=torch.int32, device=dev)
    ov.join_pass(r, g, cap, dcnt, flags, nflag)
    n_ovf = int(nflag[0])
    if not n_ovf:
        return {"flagged": 0}
    nid = int(xs[-1]) + 1
    blocks = ov.dense_blocks(nid, n_ovf)
    table = torch.empty(2 * nid * blocks, dtype=torch.int64, device=dev)
    ov.dense_pass(r, g, flags, nflag, nid, blocks, table, dcnt)
    incl = torch.cumsum(dcnt, 0)
    total = int(incl[-1])
    out = tuple(torch.empty(total, dtype=torch.int64, device=dev)
                for _ in range(4))
    return {
        "flagged": n_ovf, "blocks": blocks, "nid": nid,
        "count_ms": time_ms(lambda: ov.dense_pass(
            r, g, flags, nflag, nid, blocks, table, dcnt), 5, 1)[0],
        "emit_ms": time_ms(lambda: ov.dense_pass(
            r, g, flags, nflag, nid, blocks, table, dcnt, incl, out),
            5, 1)[0],
        "call_ms": time_ms(lambda: ov.overlap_join(*rows, cap=cap),
                           5, 1)[0]}


def same(got, want):
    return all(torch.equal(a, b) for a, b in zip(got[:4], want[:4])) \
        and tuple(got[4:6]) == tuple(want[4:6])


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_overlaps",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=["config5"])
    ap.add_argument("--baseline", metavar="SRC.cu",
                    help="an earlier overlaps.cu to time beside")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    for n in a.names:
        if n not in SHAPES:
            raise SystemExit("probe_overlaps: unknown shape %r; shapes: %s"
                             % (n, ",".join(SHAPES)))
    dev = resolve_device(device)
    if a.baseline and dev.type != "cuda":
        raise SystemExit("probe_overlaps: --baseline needs the card")
    L = load_baseline(a.baseline) if a.baseline else None
    ok = True
    for name in a.names:
        rows = shape_rows(name, dev)
        want = ov.overlap_pairs_ref(*rows)
        fns = {"current": lambda: ov.overlap_pairs(*rows)}
        if L is not None:
            fns["baseline"] = lambda: baseline_overlap_pairs(L, *rows)
        checks = {who: same(fn(), want) for who, fn in fns.items()}
        line = {"probe": "probe_overlaps", "shape": name,
                "hit_rows": rows[0].numel(), "pairs": want[4],
                "max_group": want[5]}
        if dev.type == "cuda":
            low = ov.overlap_join(*rows, cap=SMALL_CAP)
            checks["current_small_cap"] = same(low, want)
            line["small_cap"] = SMALL_CAP
            line["small_cap_flagged"] = low[6]
        ok &= all(checks.values())
        line["check"] = {who: "match" if c else "DIFF"
                         for who, c in checks.items()}
        if dev.type == "cuda":
            order = ["current", "current"]
            if L is not None:
                order = ["baseline"] + order + ["baseline"]
            times = {who: [] for who in fns}
            for who in order:
                times[who].append(time_ms(fns[who], 10, 2)[0])
            peak = {who: peak_bytes(fn) for who, fn in fns.items()}
            b_ms, b_by = bound_ms(overlap_bytes(rows, want[4]))
            cur = min(times["current"])
            line.update(ms=times, peak_bytes=peak,
                        steps=step_times(rows, ov.TABLE_CAP),
                        overflow=overflow_times(rows, SMALL_CAP),
                        bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / cur,
                        device=torch.cuda.get_device_name(dev),
                        card=card_line())
            if L is not None:
                srt = ov.sort_rows(*rows)
                line["baseline_pair_rows"] = baseline_pair_rows(
                    L, *srt)[0].numel()
                line["speedup"] = min(times["baseline"]) / cur
        else:
            line.update(ms=None, device="cpu", card=None)
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
