r"""densify at the scanner's three shapes, timed on the card beside an
earlier version of its step and the nearest PyTorch call.

  scanner   C = 2^25, k16 w16, k-mers only: the streaming scanner's
            ``modutils -a`` chunk
  u64       C = 2^25, k19 w31, k-mers only: the 64-bit path (the
            reference defaults)
  meta      C = 2^25, k16 w16, k-mers and (p << 1) | isF: ``scan_chunk``'s
            form (``scan_stream``, ``modutils -P``)

The rows are ``scan_compact``'s on ``probe_scan_compact``'s inputs (uniform
random bases in reads of 1,000 bp) and ``cap`` is the scanner's.
``--baseline SRC.cu`` compiles SRC as it stands (nvcc with the port's flags)
into a library of its own in ``SRC``'s directory, ``_build/``, and times the
step as the port made it around that kernel, whose ``mz_densify`` takes the
int64 exclusive prefix of the clamped counts and stores the live rows only:
the int64 cast, clamp, cumsum and subtraction of the prefix, ``torch.full``
of the outputs, then the kernel.  For example the source at an earlier
commit::

    git show REV:modimizer_tpu_torch/csrc/densify.cu > old/densify.cu
    python -m modimizer_tpu_torch.probes.probe_densify \
        --baseline old/densify.cu

Each version is held against ``densify_ref`` on the shape's rows; then they
are timed in turns (baseline, current, nearest, nearest, current, baseline),
CUDA events with the launches queued behind a sleep.  "nearest" is
``torch.masked_select`` of the live rows (k-mers, and meta in the meta form),
the mask built outside the timing: no single PyTorch call computes densify,
and this one omits the cap cut and the sentinel pad.  One JSON line per
shape: each time, the bound (the counts in, the live rows in, cap slots out,
read or written once at 3.35 TB/s), the current step's share of it and its
speed-up over the baseline.  A disagreement exits non-zero.
"""

import argparse
import ctypes
import json
import sys

import torch

from .. import _build
from ..core.seqhash import Seqhash
from ..ops.device_scan import _block_bases, densify, densify_ref
from ..ops.scan_kernel import scan_compact
from ..ops.seqhash import ModimizerScanner
from . import SEED, resolve_device
from . import probe_scan_compact as psc
from ._timing import bound_ms, card_line, same, time_ms

# name: (log2 C, k, w, with meta)
SHAPES = {"scanner": (25, 16, 16, False), "u64": (25, 19, 31, False),
          "meta": (25, 16, 16, True)}
_INPUTS = {"scanner": "scanner", "u64": "u64", "meta": "scanner"}


def shape_rows(name, C, device):
    """(out_k, out_meta or None, cnt, bo, cap): scan_compact's rows for
    shape ``name`` at C positions and the scanner's cap."""
    _logc, k, w, with_meta = SHAPES[name]
    sw, vb, args = psc.shape_inputs(_INPUTS[name], C, device)
    args.update(meta_isf=with_meta, with_meta=with_meta)
    out_k, out_meta, cnt, _n, _ovf = scan_compact(sw, vb, **args)
    cap = ModimizerScanner(Seqhash.create(k, w, SEED), chunk=C,
                           device=device).cap
    return out_k, out_meta, cnt, args["bo"], min(cap, out_k.shape[0])


def densify_bytes(cnt, bo, cap, with_meta):
    """Bytes read once and written once: the counts, the live rows (8 B,
    +4 B of meta), cap output slots."""
    row = 12 if with_meta else 8
    return cnt.numel() * 4 + int(cnt.clamp(max=bo).sum()) * row + cap * row


def nearest_call(out_k, out_meta, cnt, bo):
    """torch.masked_select of the live rows, the mask built here."""
    j = torch.arange(bo, dtype=torch.int32, device=cnt.device)
    mask = (j < cnt.clamp(max=bo)[:, None]).view(-1)
    if out_meta is None:
        return lambda: (torch.masked_select(out_k, mask),)
    return lambda: (torch.masked_select(out_k, mask),
                    torch.masked_select(out_meta, mask))


def load_baseline(src):
    """Build ``src`` into its own library and declare the earlier
    interface of ``mz_densify``: (src_k, src_meta, cnt, base, nb, bo, cap,
    dst_k, dst_meta, stream)."""
    L = _build.build_aside(src)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    L.mz_densify.restype = i32
    L.mz_densify.argtypes = [p, p, p, p, i64, i32, i64, p, p, p]
    return L


def baseline_densify(L, out_k, out_meta, cnt, *, bo, cap):
    """The densify step around the baseline kernel: the prefix by PyTorch
    ops, the outputs pre-filled with sentinels, then the launch."""
    dev = out_k.device
    _live, base = _block_bases(cnt, bo)
    dk = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    dm = (None if out_meta is None
          else torch.full((cap,), -1, dtype=torch.int32, device=dev))
    rc = L.mz_densify(out_k.data_ptr(),
                      None if dm is None else out_meta.data_ptr(),
                      cnt.data_ptr(), base.data_ptr(), cnt.shape[0], bo, cap,
                      dk.data_ptr(), None if dm is None else dm.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError("baseline densify: CUDA error %d" % rc)
    return dk, dm


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_densify",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(SHAPES))
    ap.add_argument("--baseline", metavar="SRC.cu",
                    help="an earlier densify.cu to time beside")
    ap.add_argument("--small", action="store_true",
                    help="C = 2^15 for every shape (a quick check)")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    for n in a.names:
        if n not in SHAPES:
            raise SystemExit("probe_densify: unknown shape %r; shapes: %s"
                             % (n, ",".join(SHAPES)))
    dev = resolve_device(device)
    if a.baseline and dev.type != "cuda":
        raise SystemExit("probe_densify: --baseline needs the card")
    L = load_baseline(a.baseline) if a.baseline else None
    ok = True
    for n in a.names:
        C = 1 << (15 if a.small else SHAPES[n][0])
        out_k, out_meta, cnt, bo, cap = shape_rows(n, C, dev)
        args = dict(bo=bo, cap=cap)
        want = densify_ref(out_k, out_meta, cnt, **args)
        fns = {"current": lambda: densify(out_k, out_meta, cnt, **args)}
        if L is not None:
            fns["baseline"] = lambda: baseline_densify(L, out_k, out_meta,
                                                       cnt, **args)
        checks = {who: same(fn(), want) for who, fn in fns.items()}
        ok &= all(checks.values())
        live = int(cnt.clamp(max=bo).sum())
        line = {"probe": "probe_densify", "shape": n, "C": C,
                "k": SHAPES[n][1], "w": SHAPES[n][2], "bo": bo, "cap": cap,
                "nb": cnt.shape[0], "live_rows": live,
                "with_meta": out_meta is not None,
                "check": {who: "match" if c else "DIFF"
                          for who, c in checks.items()}}
        if dev.type == "cuda":
            fns["nearest"] = nearest_call(out_k, out_meta, cnt, bo)
            order = ["current", "nearest", "nearest", "current"]
            if L is not None:
                order = ["baseline"] + order + ["baseline"]
            times = {who: [] for who in fns}
            for who in order:
                times[who].append(time_ms(fns[who])[0])
            b_ms, b_by = bound_ms(densify_bytes(cnt, bo, cap,
                                                out_meta is not None))
            cur = min(times["current"])
            line.update(ms=times, bound_ms=b_ms, bound_by=b_by,
                        bound_share=b_ms / cur,
                        nearest="torch.masked_select of the live rows, "
                        "mask built beforehand: omits the cap cut and the "
                        "sentinel pad",
                        device=torch.cuda.get_device_name(dev),
                        card=card_line())
            if L is not None:
                line["speedup"] = min(times["baseline"]) / cur
        else:
            line.update(ms=None, device="cpu", card=None)
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
