r"""minimizer_chunk on one chunk of the minimizer scan, timed on the card
beside an earlier version of its kernel and the nearest PyTorch calls.

  k19w31   one chunk of 2^22 positions and both halos of w - 1 (4,194,368
           at w 31, as ``minimizer_scan`` gives the kernel), uniform random
           bases, k19 w31 (the reference's defaults)
  k16w16   the same at k16 w16
  w255     k16 w255
  w300     k16 w300
  w1000    k16 w1000 (tile path since the kernel's W_TILE is 1024)
  w1100    k16 w1100 (the wide path)
  w16k, w64k, w1m
           k16 at w 2^14, 2^16 and 2^20: segments of w across many of the
           wide path's blocks

The chunk is a middle one: every position live, every start a full window.
``--baseline SRC.cu`` compiles SRC as it stands (nvcc with the port's flags)
into a library of its own in ``SRC``'s directory, ``_build/``, and calls
its ``mz_minimizer_chunk`` (the same C interface; the current kernel's
scratch past its ``mz_minimizer_w_tile()``).  For example the source at an
earlier commit::

    git show REV:modimizer_tpu_torch/csrc/minimizer.cu > old/minimizer.cu
    python -m modimizer_tpu_torch.probes.probe_minimizer --baseline \
        old/minimizer.cu

``--part`` says that SRC is a part of the kernel (an edited copy that
stops early, as ``.claude/skills/verify/SKILL.md`` shows): it is checked
on the hashes and strands alone.

Each version is held against ``minimizer_chunk_ref`` bit for bit; then
they are timed in turns
(baseline, current, unfold, unfold, current, baseline), CUDA events with
the launches queued behind a sleep; the plain version once.  "unfold" is
the nearest PyTorch call: ``unfold(0, w, 1).amin(1)`` of the padded hashes,
then ``.amax(1)`` of those minima, the two window passes alone (no hashing,
masking or emit), to w 2048.  One JSON line per shape: each time, the bound (C/4 B of
packed bases read once; 8 B of hash, 1 B of strand and 1 B of emit written
once a position, at 3.35 TB/s), the current kernel's share of it and its
speed-up over the baseline.  ``--small``: a chunk of 2^15 positions.  A
disagreement exits non-zero.
"""

import argparse
import ctypes
import json
import sys

import torch

from .. import _build
from ..core.seqhash import Seqhash
from ..ops import minimizer as mz
from . import SEED, random_sw, resolve_device
from ._timing import bound_ms, card_line, nbytes, same, time_ms

SHAPES = {"k19w31": (19, 31), "k16w16": (16, 16), "w255": (16, 255),
          "w300": (16, 300), "w1000": (16, 1000), "w1100": (16, 1100),
          "w16k": (16, 1 << 14), "w64k": (16, 1 << 16),
          "w1m": (16, 1 << 20)}
UNFOLD_W = 2048     # wider, unfold's C w reads take seconds
CHUNK = 1 << 22
SMALL_CHUNK = 1 << 15


def chunk_inputs(k, w, C, device):
    """A middle chunk of C positions and its halos: (sw, m_ext, n_win,
    base, Cext) as ``minimizer_scan`` passes them, every position live and
    every start a full window."""
    cext = (C + 2 * (w - 1) + 31) // 32 * 32
    sw = random_sw(cext, k, device)
    return sw, cext, 10 * cext, cext, cext


def load(src):
    """``src`` built into a library of its own, ``mz_minimizer_chunk`` and
    ``mz_minimizer_w_tile`` declared."""
    L = _build.build_aside(src)
    p, i32, i64, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_uint64)
    L.mz_minimizer_chunk.restype = i32
    L.mz_minimizer_chunk.argtypes = [p, i64, i64, i64, i64, i32, i64, u64,
                                     p, p, p, p, p]
    L.mz_minimizer_w_tile.restype = i32
    L.mz_minimizer_w_tile.argtypes = []
    return L


def run_lib(L, sw, m_ext, n_win, base, k, w, factor1, C):
    """``L``'s kernel on the chunk, outputs and scratch allocated as the
    wrapper allocates them."""
    dev = sw.device
    out_h = torch.empty(C, dtype=torch.int64, device=dev)
    out_f = torch.empty(C, dtype=torch.bool, device=dev)
    out_e = torch.empty(C, dtype=torch.bool, device=dev)
    scratch = (torch.empty(mz.wide_scratch(C), dtype=torch.int64,
                           device=dev)
               if w > L.mz_minimizer_w_tile() else None)
    rc = L.mz_minimizer_chunk(
        sw.data_ptr(), C, m_ext, n_win, base, k, w, ctypes.c_uint64(factor1),
        out_h.data_ptr(), out_f.data_ptr(), out_e.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError("minimizer_chunk (%s): CUDA error %d" % (L, rc))
    return out_h, out_f, out_e


def unfold_passes(hh, w):
    """The two window passes with PyTorch calls: the minima of the padded
    hashes, then the maxima of those over the windows that cover each
    position."""
    pad = torch.full((w - 1,), mz.PAD, dtype=torch.int64, device=hh.device)
    a = torch.cat([hh, pad]).unfold(0, w, 1).amin(1)
    return torch.cat([pad * 0, a]).unfold(0, w, 1).amax(1)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_minimizer",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--baseline", metavar="SRC.cu",
                    help="an earlier minimizer.cu to time beside")
    ap.add_argument("--part", action="store_true",
                    help="the baseline is a part of the kernel: check its "
                    "hashes and strands alone")
    ap.add_argument("--small", action="store_true",
                    help="a chunk of 2^15 positions")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    names = a.names or list(SHAPES)
    for name in names:
        if name not in SHAPES:
            raise SystemExit("probe_minimizer: unknown shape %r; shapes: %s"
                             % (name, ",".join(SHAPES)))
    if a.baseline and dev.type != "cuda":
        raise SystemExit("probe_minimizer: --baseline needs the card")
    if a.part and not a.baseline:
        raise SystemExit("probe_minimizer: --part needs --baseline")
    old = load(a.baseline) if a.baseline else None
    ok = True
    for name in names:
        k, w = SHAPES[name]
        sh = Seqhash.create(k, w, SEED)
        sw, m_ext, n_win, base, C = chunk_inputs(
            k, w, SMALL_CHUNK if a.small else CHUNK, dev)
        args = (sw, m_ext, n_win, base)
        kw = dict(k=k, w=w, factor1=sh.factor1, C=C)
        want = mz.minimizer_chunk_ref(*args, **kw)
        fns = {"current": lambda: mz.minimizer_chunk(*args, **kw)}
        if old is not None:
            fns["baseline"] = lambda: run_lib(old, *args, k, w, sh.factor1,
                                              C)
        def held(who):
            """The outputs held against the plain version: a part's emit
            flags are not computed."""
            return 2 if a.part and who == "baseline" else 3
        checks = {who: same(tuple(fn())[:held(who)], tuple(want)[:held(who)])
                  for who, fn in fns.items()}
        ok &= all(checks.values())
        line = {"probe": "probe_minimizer", "shape": name, "k": k, "w": w,
                "positions": C, "path": "tile" if w <= mz.W_TILE else "wide",
                "check": {who: "match" if c else "DIFF"
                          for who, c in checks.items()}}
        if dev.type == "cuda":
            order = ["current", "current"]
            if w <= UNFOLD_W:
                hh = want[0].clone()
                fns["unfold"] = lambda: unfold_passes(hh, w)
                order = ["current", "unfold", "unfold", "current"]
            if "baseline" in fns:
                order = ["baseline"] + order + ["baseline"]
            times = {who: [] for who in fns}
            for who in order:
                times[who].append(time_ms(fns[who])[0])
            plain = time_ms(lambda: mz.minimizer_chunk_ref(*args, **kw),
                            3, 1)[0]
            b_ms, b_by = bound_ms(nbytes(sw[:C // 32 + 1], *want))
            cur = min(times["current"])
            line.update(ms=times, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, bound_share=b_ms / cur,
                        device=torch.cuda.get_device_name(dev),
                        card=card_line())
            if "baseline" in times:
                line["speedup"] = min(times["baseline"]) / cur
        else:
            line.update(ms=None, device="cpu", card=None)
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
