"""Port of ``scripts/probe_pallas_front.py``: the k = 16 front as one
elementwise kernel, its emit count alone and its planes, beside the plain
PyTorch front on the same card.

  count   : the ``front_planes`` kernel counting emits (``timing_kernel``).
  planes  : the ``front_planes`` kernel writing the (k-mer, emit) planes
            (``plane_kernel``).
  front32 : the plain PyTorch front (``front_planes_ref``) writing the same
            planes on the card: the counterpart of the script's XLA front.

Each kernel is held against the plain version on the same streams before
it is timed.

Usage: python -m modimizer_tpu_torch.probes.probe_pallas_front [C_log2] [MJ]
"""

import argparse
import sys

from ..core.seqhash import Seqhash
from ..ops.front_kernel import front_planes, front_planes_ref
from . import SEED, front_inputs, resolve_device
from ._timing import report

K, W = 16, 16


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_pallas_front",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("C_log2", nargs="?", type=int, default=24)
    ap.add_argument("MJ", nargs="?", type=int, default=4096)
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    C, _sw, streams = front_inputs(a.C_log2, dev, K, a.MJ)
    factor1 = Seqhash.create(K, W, SEED).factor1
    base = {"probe": "probe_pallas_front", "C": C, "mj": a.MJ, "k": K,
            "w": W}
    ok = True
    for name, variant in (("count", "count"), ("planes", "full")):
        args = dict(factor1=factor1, w=W, variant=variant, mj=a.MJ)
        ok &= report(dict(base, variant=name, kernel="front_planes"),
                     lambda: front_planes(*streams, **args),
                     lambda: front_planes_ref(*streams, **args),
                     device=dev, work=C, reads=streams)
    args = dict(factor1=factor1, w=W, variant="full", mj=a.MJ)
    report(dict(base, variant="front32", kernel=None),
           lambda: front_planes_ref(*streams, **args), None, device=dev,
           work=C, reps=3, check=False)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
