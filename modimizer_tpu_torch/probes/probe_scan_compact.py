r"""scan_compact at the main path's three shapes, timed on the card beside
an earlier version of its source.

  scanner   C = 2^25, k16 w16, k-mers only (no meta stored): the
            streaming scanner's chunk
  u64       C = 2^25, k19 w31, k-mers only: the 64-bit path (the
            reference defaults, which the scanner takes)
  builder   C = 2^22, k16 w16, k-mers and positions: the device count's
            chunk
  noemit    C = 2^25, k16 w = 2^32 + 1, k-mers only: no 32-bit hash but 0
            is a multiple, so almost nothing emits (bo 8): the scan without
            its row stores, a floor under the scanner shape

The inputs are uniform random bases (numpy ``default_rng(42)``) in reads
of 1,000 bp, as ``bench.py`` makes them.  ``--baseline SRC.cu`` compiles
SRC as it stands (nvcc with the port's flags) into a library of its own in
``SRC``'s directory, ``_build/``, and calls its ``mz_scan_compact`` through
the interface the kernel had before it took the emit test's constants:
(sw, vbits, C, k, w, factor1, blk, bo, meta_isf, out_k, out_meta, cnt,
n_emit, overflow, stream); that interface always stores the meta.  For example the source at an earlier commit::

    git show REV:modimizer_tpu_torch/csrc/scan_compact.cu > old/sc.cu
    python -m modimizer_tpu_torch.probes.probe_scan_compact \
        --baseline old/sc.cu

Each version is held against ``scan_compact_ref`` on the shape's inputs;
then they are timed in turns (baseline, current, current, baseline), CUDA
events with the launches queued behind a sleep.  Where the shape stores no
meta, ``current_meta`` times the current kernel storing it too, the
baseline's work.  One JSON line per shape: each time, the bound (bytes read
once and written once at 3.35 TB/s) of the call as the path makes it and
the current kernel's share of it, and ``bound_ms_meta``, the bound with the
meta stores.  A disagreement exits non-zero.
"""

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from .. import _build
from ..core.seqhash import Seqhash
from ..native import lib as native_lib
from ..ops.scan_kernel import kernel_params, scan_compact, scan_compact_ref
from ..ops.seqhash import BLK_COMPACT, scan_bo
from . import DATA_SEED, SEED, random_sw, resolve_device
from ._timing import bound_ms, card_line, nbytes, same, time_ms

# name: (log2 C, k, w, with_meta)
SHAPES = {"scanner": (25, 16, 16, False), "u64": (25, 19, 31, False),
          "builder": (22, 16, 16, True),
          "noemit": (25, 16, (1 << 32) + 1, False)}
READ_LEN = 1000


def shape_inputs(name, C, device):
    """(sw, vbits, scan_compact's keyword arguments) for shape ``name`` at
    C positions: positions without isF as meta, the scanner's bo."""
    _logc, k, w, with_meta = SHAPES[name]
    n = C + k - 1
    offsets = np.arange(0, n + READ_LEN, READ_LEN, dtype=np.int64)
    offsets[-1] = n
    vb = np.empty(C // 64, np.uint64)
    native_lib().pk_valid_words(offsets, len(offsets) - 1, n, k, vb, len(vb))
    kp = kernel_params(Seqhash.create(k, w, SEED))
    args = dict(k=k, w=w, factor1=kp.factor1, C=C, bo=scan_bo(w),
                meta_isf=False, with_meta=with_meta)
    return (random_sw(C, k, device, DATA_SEED),
            torch.from_numpy(vb.view(np.int64)).to(device), args)


def scan_compact_bytes(sw, vbits, C, bo, with_meta, blk=BLK_COMPACT):
    """Bytes read once and written once: sw, vbits, then out_k, out_meta
    (with_meta), cnt, n_emit and overflow."""
    nb = C // blk
    return (nbytes(sw, vbits) + nb * bo * (12 if with_meta else 8)
            + nb * 4 + 8 + 1)


def load_baseline(src):
    """Build ``src`` into its own library and declare the earlier
    interface of ``mz_scan_compact``."""
    L = _build.build_aside(src)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    L.mz_scan_compact.restype = i32
    L.mz_scan_compact.argtypes = [p, p, ctypes.c_int64, i32,
                                  ctypes.c_uint64, ctypes.c_uint64,
                                  i32, i32, i32, p, p, p, p, p, p]
    return L


def baseline_scan_compact(L, sw, vbits, *, k, w, factor1, C, bo, meta_isf,
                          blk=BLK_COMPACT, with_meta=True):
    """scan_compact's outputs from the baseline library, which stores the
    meta whatever ``with_meta`` asks (then returned as None)."""
    dev = sw.device
    nb = C // blk
    out = (torch.empty(nb * bo, dtype=torch.int64, device=dev),
           torch.empty(nb * bo, dtype=torch.int32, device=dev),
           torch.empty(nb, dtype=torch.int32, device=dev),
           torch.zeros((), dtype=torch.int64, device=dev),
           torch.zeros((), dtype=torch.bool, device=dev))
    rc = L.mz_scan_compact(
        sw.data_ptr(), vbits.data_ptr(), C, k, w, factor1, blk, bo,
        int(bool(meta_isf)), *(t.data_ptr() for t in out),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError("baseline scan_compact: CUDA error %d" % rc)
    return out if with_meta else (out[0], None) + out[2:]


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_scan_compact",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(SHAPES))
    ap.add_argument("--baseline", metavar="SRC.cu",
                    help="an earlier scan_compact.cu to time beside")
    ap.add_argument("--small", action="store_true",
                    help="C = 2^15 for every shape (a quick check)")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    for n in a.names:
        if n not in SHAPES:
            raise SystemExit("probe_scan_compact: unknown shape %r; shapes: "
                             "%s" % (n, ",".join(SHAPES)))
    dev = resolve_device(device)
    if a.baseline and dev.type != "cuda":
        raise SystemExit("probe_scan_compact: --baseline needs the card")
    L = load_baseline(a.baseline) if a.baseline else None
    ok = True
    for n in a.names:
        C = 1 << (15 if a.small else SHAPES[n][0])
        sw, vb, args = shape_inputs(n, C, dev)
        want = scan_compact_ref(sw, vb, **args)
        fns = {"current": lambda: scan_compact(sw, vb, **args)}
        if not args["with_meta"]:
            meta_args = dict(args, with_meta=True)
            fns["current_meta"] = lambda: scan_compact(sw, vb, **meta_args)
        if L is not None:
            fns["baseline"] = lambda: baseline_scan_compact(L, sw, vb, **args)
        checks = {who: same(fn(), want) for who, fn in fns.items()
                  if who != "current_meta"}
        if "current_meta" in fns:
            checks["current_meta"] = same(
                fns["current_meta"](), scan_compact_ref(sw, vb, **meta_args))
        ok &= all(checks.values())
        line = {"probe": "probe_scan_compact", "shape": n, "C": C,
                "k": args["k"], "w": args["w"], "bo": args["bo"],
                "with_meta": args["with_meta"],
                "check": {who: "match" if c else "DIFF"
                          for who, c in checks.items()}}
        if dev.type == "cuda":
            mine = [who for who in ("current", "current_meta")
                    if who in fns]
            order = (["baseline"] + mine + mine[::-1] + ["baseline"]
                     if L is not None else mine)
            times = {who: [] for who in fns}
            for who in order:
                times[who].append(time_ms(fns[who])[0])
            b_ms, b_by = bound_ms(scan_compact_bytes(
                sw, vb, C, args["bo"], args["with_meta"]))
            cur = min(times["current"])
            line.update(ms=times, bound_ms=b_ms, bound_by=b_by,
                        bound_share=b_ms / cur,
                        bound_ms_meta=bound_ms(scan_compact_bytes(
                            sw, vb, C, args["bo"], True))[0],
                        device=torch.cuda.get_device_name(dev),
                        card=card_line())
        else:
            line.update(ms=None, device="cpu", card=None)
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
