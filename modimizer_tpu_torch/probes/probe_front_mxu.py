"""Port of ``scripts/probe_front_mxu.py``: the k = 16 front without its
hash, with it, and with the hash partials from tensor-core products.

  nohash : funnel + a trivial emit rule ((kf ^ kr) & 15 == 0): the front's
           floor without multiplies (``front_planes`` "nohash").
  mul16  : funnel + both strands' hashes (``front_planes`` "full"; on the
           card one IMAD.HI + IMAD per hash, not the TPU's 16-bit limbs).
           mul16 - nohash is the multiply bill.
  mxu    : the hash partials of both strands from u8 x u8 -> s32 MMAs of
           byte limbs and a u32 carry chain (``front_mma``).

Each kernel is held against its plain version on the same streams before
it is timed.  ``--baseline SRC.cu`` compiles SRC as it stands (nvcc with the
port's flags) into a library of its own in ``SRC``'s directory, ``_build/``,
and launches its ``mz_front_mma`` (the same C interface) with 8 blocks an
SM, the grid the wrapper gave the earlier 8-warp kernel; ``mxu`` then also
prints a line of the two kernels timed in turns (baseline, current,
current, baseline), each first held against ``front_mma_ref``::

    git show REV:modimizer_tpu_torch/csrc/front_mma.cu > old/front_mma.cu
    python -m modimizer_tpu_torch.probes.probe_front_mxu 24 4096 mxu \
        --baseline old/front_mma.cu

Usage: python -m modimizer_tpu_torch.probes.probe_front_mxu
       [C_log2] [MJ] [variants] [--baseline SRC.cu]
"""

import argparse
import ctypes
import json
import sys

import torch

from .. import _build
from ..core.seqhash import Seqhash
from ..ops.front_kernel import front_planes, front_planes_ref
from ..ops.front_mma import front_mma, front_mma_ref, launch
from . import SEED, front_inputs, resolve_device, variants
from ._timing import bound_ms, card_line, nbytes, report, same, time_ms

K, W = 16, 16
PORTED = ("nohash", "mul16", "mxu")
BASELINE_BLOCKS_PER_SM = 8


def load_baseline(src):
    """Build ``src`` into its own library; its ``mz_front_mma`` has the
    current interface."""
    L = _build.build_aside(src)
    L.mz_front_mma.restype = ctypes.c_int
    L.mz_front_mma.argtypes = _build.lib().mz_front_mma.argtypes
    return L


def in_turns(L, streams, factor1, w, C, dev):
    """The baseline and current kernels, each held against front_mma_ref,
    then timed baseline, current, current, baseline; returns (ok, line)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    NJ = C // 16
    args = dict(factor1=factor1, w=w)
    fns = {"baseline": lambda: launch(
               L, *streams, NJ, nblocks=BASELINE_BLOCKS_PER_SM * sms, **args),
           "current": lambda: front_mma(*streams, **args)}
    want = front_mma_ref(*streams, **args)
    checks = {who: same(fn(), want) for who, fn in fns.items()}
    times = {who: [] for who in fns}
    for who in ("baseline", "current", "current", "baseline"):
        times[who].append(time_ms(fns[who])[0])
    b_ms, b_by = bound_ms(nbytes(*streams, *want), 384 * C)
    cur, old = min(times["current"]), min(times["baseline"])
    return all(checks.values()), {
        "probe": "probe_front_mxu", "variant": "mxu", "turns": True, "C": C,
        "k": K, "w": w, "check": {who: "match" if c else "DIFF"
                                  for who, c in checks.items()},
        "ms": times, "speedup": old / cur, "bound_ms": b_ms,
        "bound_by": b_by, "bound_share": b_ms / cur,
        "baseline_bound_share": b_ms / old,
        "device": torch.cuda.get_device_name(dev), "card": card_line()}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_front_mxu",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("C_log2", nargs="?", type=int, default=24)
    ap.add_argument("MJ", nargs="?", type=int, default=4096)
    ap.add_argument("variants", nargs="?", default=",".join(PORTED))
    ap.add_argument("--baseline", metavar="SRC.cu",
                    help="an earlier front_mma.cu to time beside mxu")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    names = variants(a.variants, PORTED, "probe_front_mxu")
    dev = resolve_device(device)
    if a.baseline and dev.type != "cuda":
        raise SystemExit("probe_front_mxu: --baseline needs the card")
    L = load_baseline(a.baseline) if a.baseline else None
    C, _sw, streams = front_inputs(a.C_log2, dev, K, a.MJ)
    factor1 = Seqhash.create(K, W, SEED).factor1
    ok = True
    for v in names:
        base = {"probe": "probe_front_mxu", "variant": v, "C": C,
                "mj": a.MJ, "k": K, "w": W}
        if v == "mxu":
            args = dict(factor1=factor1, w=W)
            fn, plain = front_mma, front_mma_ref
        else:
            args = dict(factor1=factor1, w=W, mj=a.MJ,
                        variant="nohash" if v == "nohash" else "full")
            fn, plain = front_planes, front_planes_ref
        # front_mma: a [24, 8] int8 limb product a position
        ok &= report(dict(base, kernel=fn.__name__),
                     lambda: fn(*streams, **args),
                     lambda: plain(*streams, **args), device=dev, work=C,
                     reads=streams, int8_ops=384 * C if v == "mxu" else 0)
        if v == "mxu" and L is not None:
            good, line = in_turns(L, streams, factor1, W, C, dev)
            ok &= good
            print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
