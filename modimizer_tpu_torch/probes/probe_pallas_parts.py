"""Port of ``scripts/probe_pallas_parts.py``: the k = 16 front with one
piece ablated at a time, to show where its time goes on the card.

  full   : the front, writing the (k-mer u32, emit i8) planes: the baseline.
  noin   : the same compute, with the streams made in the kernel from the
           block's lane iota: no input reads.
  noout  : the same compute and reads; the only output is an [8, 128]
           accumulator of (km & 0xFFFF) + 65536 emit: no plane stores.
  kmonly : the k-mer plane alone (emit ? km : ~km).
  emonly : the emit plane alone (emit & km != 0).

Every variant is the ``front_planes`` kernel, held against its plain
version on the same streams before it is timed.

Usage: python -m modimizer_tpu_torch.probes.probe_pallas_parts
       [C_log2] [MJ] [variants]
"""

import argparse
import sys

from ..core.seqhash import Seqhash
from ..ops.front_kernel import front_planes, front_planes_ref
from . import SEED, front_inputs, resolve_device, variants
from ._timing import report

K, W = 16, 16
PORTED = ("full", "noin", "noout", "kmonly", "emonly")


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_pallas_parts",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("C_log2", nargs="?", type=int, default=24)
    ap.add_argument("MJ", nargs="?", type=int, default=4096)
    ap.add_argument("variants", nargs="?", default=",".join(PORTED))
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    names = variants(a.variants, PORTED, "probe_pallas_parts")
    dev = resolve_device(device)
    C, _sw, streams = front_inputs(a.C_log2, dev, K, a.MJ)
    factor1 = Seqhash.create(K, W, SEED).factor1
    ok = True
    for v in names:
        args = dict(factor1=factor1, w=W, variant=v, mj=a.MJ)
        ok &= report({"probe": "probe_pallas_parts", "variant": v,
                      "kernel": "front_planes", "C": C, "mj": a.MJ, "k": K,
                      "w": W},
                     lambda: front_planes(*streams, **args),
                     lambda: front_planes_ref(*streams, **args),
                     device=dev, work=C,
                     reads=() if v == "noin" else streams)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
