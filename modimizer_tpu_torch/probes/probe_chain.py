"""chain_emit (the chaining kernel's offsets form) on bench_chain's seeds,
timed on the card beside an earlier version of its kernel.

  bench    ``scripts/bench_chain.py``'s case at its size: 100,000 reads of
           20-40 seeds (2,951,475), colinear occurrences with 10 % misses
  longest  the longest read of that case alone (R = 1): the serial chain of
           one read's automaton, a launch and its look-back
  copy     ``x.clone()`` of the seed planes ``bench`` reads (five u32 and a
           flag byte a seed): the time of the bytes alone

``--baseline SRC.cu`` compiles SRC as it stands (nvcc with the port's flags)
into a library of its own in ``SRC``'s directory, ``_build/``, and runs its
offsets form: ``mz_chain_emit`` where SRC has it (one launch, as now), else
the interface of the count pass and the emit pass (the earlier
``mz_chain_scan(..., R, out_off, cap, out, counts, overflow, stream)``):
the count pass, ``torch.cumsum``, the emit pass into rows it had sized on
the host, all three timed, no host sync between them.  For example::

    git show REV:modimizer_tpu_torch/csrc/chain.cu > old/chain.cu
    python -m modimizer_tpu_torch.probes.probe_chain --baseline old/chain.cu

``--part`` says that SRC is a part of the kernel (an edited copy that
leaves out a step, as ``.claude/skills/verify/SKILL.md`` shows): it is
timed and not checked.

Each version is held against ``chain_emit_ref`` bit for bit; then they are
timed in turns (baseline, current, current, baseline), CUDA events with the
launches queued behind a sleep.  One JSON line per shape: each time, the
bound (``chain_bytes``: what the one launch must move on these seeds, at
3.35 TB/s), the current kernel's share of it, its speed-up over the
baseline, and the bound by the formula the count-and-emit form was held
to (``chain_bytes_two_pass``), for comparison.  ``--small``: 10,000 reads.
A disagreement exits non-zero.
"""

import argparse
import ctypes
import json
import sys
import types

import numpy as np
import torch

from .. import _build
from ..parallel import chain as ch
from . import resolve_device
from ._timing import bound_ms, card_line, time_ms

SHAPES = ("bench", "longest", "copy")
_M32 = 0xFFFFFFFF
READS = 100_000                 # scripts/bench_chain.py's default size
SMALL_READS = 10_000
SPR = 30


def bench_chain_case(n_reads, spr, n_mods=200000, n_refs=24, seed=1):
    """scripts/bench_chain.py's make_case (:17-42): colinear-ish
    occurrences so that real blocks form, runs of consecutive mods with
    10 % misses.  Returns (ref-like, sidx, spos, seed_off)."""
    rng = np.random.default_rng(seed)
    info = np.zeros(n_mods + 1, np.uint8)
    info[1:] = rng.choice([1, 1, 1, 2, 3], n_mods).astype(np.uint8)
    n_occ = np.where((info & 3) == 2, 2, 1)
    n_occ[0] = 1
    loc = np.concatenate([[0], np.cumsum(n_occ[:-1])]).astype(np.uint32)
    total = int(n_occ.sum())
    rev = (np.arange(total, dtype=np.uint32)
           + rng.integers(-3, 4, total).astype(np.int64)).clip(
               0, total - 1).astype(np.uint32)
    bounds = np.sort(rng.choice(total, n_refs - 1, replace=False))
    rid = np.searchsorted(bounds, np.arange(total),
                          side="right").astype(np.uint32)
    offs = (np.arange(total, dtype=np.uint32) * 13) & 0xFFFFFF
    ns = rng.integers(max(1, spr - 10), spr + 10, n_reads)
    seed_off = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
    S = int(seed_off[-1])
    base = rng.integers(1, n_mods - 200, n_reads)
    within = np.arange(S) - np.repeat(seed_off[:-1], ns)
    sidx = (np.repeat(base, ns) + within // 2).astype(np.uint32)
    sidx[rng.random(S) < 0.1] = 0
    spos = (within * 16).astype(np.int64)
    ref = types.SimpleNamespace(rev=rev, loc=loc, id=rid, offset=offs,
                                ms=types.SimpleNamespace(info=info))
    return ref, sidx, spos, seed_off


def block_loads(la, lb, ia, ib, is1, live, idmap, seed_off):
    """The loads the offsets form makes that depend on the data, by the
    automaton (modmap.c:216-280) stepped over every read at once on the
    host: (block openings, each an idmap entry; copy-2 retries, each an lb
    and an ib).  Arguments as ``parallel/chain.py::seed_planes`` gives them,
    idmap the reference's ids, seed_off int64 [R + 1]."""
    n = np.diff(seed_off)
    R = len(n)
    z = np.zeros(R, np.int64)
    loc0, locN, i0, iN, id0 = z, z, z, z, z
    opens = retries = 0
    idm = np.asarray(idmap, np.int64)

    def s32(x):
        return ((x + (1 << 31)) & _M32) - (1 << 31)

    def brk(loc, rid):
        span = (iN - i0) & _M32
        d_f = s32((locN - loc0 - span) & _M32)
        d_r = s32((loc0 - locN - span) & _M32)
        return ((rid != id0)
                | ((loc0 < locN) & ((loc < locN) | (np.abs(d_f) > 50)))
                | ((loc0 > locN) & ((loc > locN) | (np.abs(d_r) > 50))))
    for t in range(int(n.max()) if R else 0):
        has = n > t
        s = np.where(has, seed_off[:-1] + t, 0)
        lv = has & live[s]
        one = is1[s]
        la_t, ia_t = la[s].astype(np.int64), ia[s].astype(np.int64)
        none = loc0 == 0
        end = none | brk(la_t, ia_t)
        retry = lv & end & ~none & ~one
        loc = np.where(retry, lb[s].astype(np.int64), la_t)
        end = np.where(retry, brk(loc, np.where(retry, ib[s], ia_t)), end)
        upd = lv & end
        opens += int(upd.sum())
        retries += int(retry.sum())
        loc0 = np.where(upd, loc, loc0)
        id0 = np.where(upd, idm[loc], id0)
        i0 = np.where(upd, t, i0)
        locN = np.where(lv, loc, locN)
        iN = np.where(lv, t, iN)
    return opens, retries


def chain_bytes(n_seeds, n_reads, n_records, n_opens, n_retries):
    """What chain_emit's one launch must move: each seed's la, ia, pos and
    flag byte (13 B), lb and ib a copy-2 retry, an idmap entry a block
    opening, the seed offsets read, the record offsets and records
    written."""
    return (n_seeds * 13 + n_retries * 8 + n_opens * 4 + (n_reads + 1) * 16
            + n_records * 28)


def chain_bytes_two_pass(n_seeds, n_reads, n_records, n_live):
    """The formula the count-and-emit form was held to: every seed's five
    planes and flag byte, an idmap entry a live seed, the counts, both
    offsets and the records."""
    return (n_seeds * 21 + (n_reads + 1) * 8 + n_live * 4
            + n_reads * 4 + (n_reads + 1) * 8 + n_records * 28)


def device_seeds(ref, sidx, spos, seed_off, device):
    """chain_emit's arguments on ``device``: (la, lb, ia, ib, flags, pos,
    idmap, seed_off), and the counts its bounds take: {"live_seeds",
    "block_openings", "retries"}."""
    la, lb, ia, ib, is1, live, ps = ch.seed_planes(ref, sidx, spos)
    opens, retries = block_loads(la, lb, ia, ib, is1, live, ref.id,
                                 np.asarray(seed_off, np.int64))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                ).to(device)
    flags = ch.seed_flags(torch.from_numpy(is1), torch.from_numpy(live)
                          ).to(device)
    return ((put(la), put(lb), put(ia), put(ib), flags, put(ps),
             put(np.asarray(ref.id, np.uint32)),
             torch.from_numpy(np.ascontiguousarray(seed_off, np.int64)
                              ).to(device)),
            {"live_seeds": int(live.sum()), "block_openings": opens,
             "retries": retries})


def load_baseline(src):
    """Build ``src`` into its own library and declare its offsets form:
    ``mz_chain_emit`` (one launch, as now) when it has one, else the count
    and emit pass interface of ``mz_chain_scan``."""
    L = _build.build_aside(src)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if hasattr(L, "mz_chain_emit"):
        L.mz_chain_emit.restype = i32
        L.mz_chain_emit.argtypes = [p] * 8 + [i64, p, i64, ctypes.c_uint64,
                                              p, p, p]
        return L
    L.mz_chain_scan.restype = i32
    L.mz_chain_scan.argtypes = [p] * 8 + [i64, p, i32, p, p, p, p]
    return L


def baseline_emit(L, args, rows):
    """The earlier kernel's offsets form: one launch (``mz_chain_emit``) or
    the count pass, cumsum, emit pass into ``rows`` records (the count the
    current kernel found)."""
    la = args[0]
    if hasattr(L, "mz_chain_emit"):
        return current_emit(args, L)
    dev, R = la.device, args[7].numel() - 1
    counts = torch.empty(R, dtype=torch.int32, device=dev)
    rec_off = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    out = torch.empty((rows, ch.F), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in args]
    rc = L.mz_chain_scan(*ptrs, R, rec_off.data_ptr(), 0, None,
                         counts.data_ptr(), None, stream)
    torch.cumsum(counts, 0, out=rec_off[1:])
    rc = rc or L.mz_chain_scan(*ptrs, R, rec_off.data_ptr(), 0,
                               out.data_ptr(), None, None, stream)
    if rc:
        raise RuntimeError("baseline chain_scan: CUDA error %d" % rc)
    return out, rec_off


def current_emit(args, L=None):
    """The current kernel's one launch (or library ``L``'s), its outputs
    allocated as chain_emit allocates them, with no host sync: (all its
    rows, rec_off)."""
    la, R = args[0], args[7].numel() - 1
    rec_off = torch.empty(R + 1, dtype=torch.int64, device=la.device)
    out = torch.empty((la.numel() // 3, ch.F), dtype=torch.int32,
                      device=la.device)
    ch._launch_emit(*args, R, rec_off, out, L)
    return out, rec_off


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_chain",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--baseline", metavar="SRC.cu",
                    help="an earlier chain.cu to time beside")
    ap.add_argument("--part", action="store_true",
                    help="the baseline is a part of the kernel: time it, "
                    "check nothing")
    ap.add_argument("--small", action="store_true",
                    help="10,000 reads")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    names = a.names or list(SHAPES)
    for name in names:
        if name not in SHAPES:
            raise SystemExit("probe_chain: unknown shape %r; shapes: %s"
                             % (name, ",".join(SHAPES)))
    if a.baseline and dev.type != "cuda":
        raise SystemExit("probe_chain: --baseline needs the card")
    if a.part and not a.baseline:
        raise SystemExit("probe_chain: --part needs --baseline")
    L = load_baseline(a.baseline) if a.baseline else None
    ref, sidx, spos, off = bench_chain_case(
        SMALL_READS if a.small else READS, SPR)
    ok = True
    for name in names:
        if name == "longest":
            r = int(np.argmax(np.diff(off)))
            o = off[r:r + 2]
            args, counts = device_seeds(ref, sidx[o[0]:o[1]],
                                        spos[o[0]:o[1]], o - o[0], dev)
        else:
            args, counts = device_seeds(ref, sidx, spos, off, dev)
        R, S = args[7].numel() - 1, args[0].numel()
        line = dict({"probe": "probe_chain", "shape": name, "reads": R,
                     "seeds": S}, **counts)
        n_bytes_old = None
        if name == "copy":
            planes = args[:6]
            fns = {"copy": lambda: tuple(x.clone() for x in planes)}
            line["check"] = "is a copy"
            n_bytes = sum(x.numel() * x.element_size() for x in planes)
        else:
            want = ch.chain_emit_ref(*args)
            fns = {"current": lambda: ch.chain_emit(*args)}
            if dev.type == "cuda":
                # timed: the launch alone, without chain_emit's host sync
                # for the row count
                fns["current"] = lambda: current_emit(args)
            if L is not None:
                fns["baseline"] = lambda: baseline_emit(L, args,
                                                        want[0].shape[0])
            M = int(want[0].shape[0])
            checks = {who: all(torch.equal(x, y) for x, y in
                               zip((got[0][:M], got[1]), want))
                      and got[0].shape[0] >= M
                      for who, got in ((w, fn()) for w, fn in fns.items()
                                       if not (a.part and w == "baseline"))}
            ok &= all(checks.values())
            line.update(records=M, check={who: "match" if c else "DIFF"
                                          for who, c in checks.items()})
            if a.part:
                line["check"]["baseline"] = "not checked (a part)"
            n_bytes = chain_bytes(S, R, M, counts["block_openings"],
                                  counts["retries"])
            n_bytes_old = chain_bytes_two_pass(S, R, M, counts["live_seeds"])
        if dev.type == "cuda":
            order = list(fns)
            order = order + order[::-1]
            times = {who: [] for who in fns}
            for who in order:
                times[who].append(time_ms(fns[who])[0])
            b_ms, b_by = bound_ms(n_bytes)
            cur = min(times["copy" if name == "copy" else "current"])
            line.update(ms=times, bound_ms=b_ms, bound_by=b_by,
                        bound_share=b_ms / cur,
                        device=torch.cuda.get_device_name(dev),
                        card=card_line())
            if n_bytes_old is not None:
                old_ms = bound_ms(n_bytes_old)[0]
                line.update(bound_ms_two_pass=old_ms,
                            bound_share_two_pass=old_ms / cur)
            if "baseline" in times:
                line["speedup"] = min(times["baseline"]) / cur
        else:
            line.update(ms=None, device="cpu", card=None)
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
