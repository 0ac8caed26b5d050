"""Port of ``scripts/probe_pallas_front.py``: the k = 16 front as one
elementwise kernel, its emit count alone and its planes, beside the plain
PyTorch front on the same card.

  count   : the ``front_reduce`` kernel counting emits (``timing_kernel``).
  planes  : the ``front_planes`` kernel writing the (k-mer, emit) planes
            (``plane_kernel``).
  front32 : the plain PyTorch front (``front_planes_ref``) writing the same
            planes on the card: the counterpart of the script's XLA front.

Each kernel is held against the plain version on the same streams before
it is timed.  ``--baseline SRC.cu`` (a ``front_planes.cu`` from before
csrc/front_reduce.cu, as in ``probe_pallas_parts``) also prints ``count``
timed in turns with that source's kernel at C and 2C, warm and with a cold
L2, with both kernels' two-point fits.

Usage: python -m modimizer_tpu_torch.probes.probe_pallas_front [C_log2] [MJ]
       [--baseline SRC.cu]
"""

import argparse
import json
import sys

from ..core.seqhash import Seqhash
from ..ops.front_kernel import front_planes, front_planes_ref
from . import SEED, front_inputs, resolve_device
from ._timing import report
from .probe_pallas_parts import baseline_library, turns

K, W = 16, 16


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_pallas_front",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("C_log2", nargs="?", type=int, default=24)
    ap.add_argument("MJ", nargs="?", type=int, default=4096)
    ap.add_argument("--baseline", metavar="SRC.cu",
                    help="an earlier front_planes.cu to time beside count")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    L = baseline_library(a.baseline, dev, "probe_pallas_front")
    C, _sw, streams = front_inputs(a.C_log2, dev, K, a.MJ)
    factor1 = Seqhash.create(K, W, SEED).factor1
    base = {"probe": "probe_pallas_front", "C": C, "mj": a.MJ, "k": K,
            "w": W}
    ok = True
    for name, variant, kernel in (("count", "count", "front_reduce"),
                                  ("planes", "full", "front_planes")):
        args = dict(factor1=factor1, w=W, variant=variant, mj=a.MJ)
        ok &= report(dict(base, variant=name, kernel=kernel),
                     lambda: front_planes(*streams, **args),
                     lambda: front_planes_ref(*streams, **args),
                     device=dev, work=C, reads=streams)
        if name == "count" and L is not None:
            if variant in L.variants:
                good, line = turns(L, "probe_pallas_front", variant,
                                   a.C_log2, a.MJ, dev)
                ok &= good
            else:
                line = dict(base, variant=name, turns=False,
                            reason="the baseline has no count")
            print(json.dumps(line), flush=True)
    args = dict(factor1=factor1, w=W, variant="full", mj=a.MJ)
    report(dict(base, variant="front32", kernel=None),
           lambda: front_planes_ref(*streams, **args), None, device=dev,
           work=C, reps=3, check=False)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
