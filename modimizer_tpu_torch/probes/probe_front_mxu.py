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
it is timed.

Usage: python -m modimizer_tpu_torch.probes.probe_front_mxu
       [C_log2] [MJ] [variants]
"""

import argparse
import sys

from ..core.seqhash import Seqhash
from ..ops.front_kernel import front_planes, front_planes_ref
from ..ops.front_mma import front_mma, front_mma_ref
from . import SEED, front_inputs, resolve_device, variants
from ._timing import report

K, W = 16, 16
PORTED = ("nohash", "mul16", "mxu")


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_front_mxu",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("C_log2", nargs="?", type=int, default=24)
    ap.add_argument("MJ", nargs="?", type=int, default=4096)
    ap.add_argument("variants", nargs="?", default=",".join(PORTED))
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    names = variants(a.variants, PORTED, "probe_front_mxu")
    dev = resolve_device(device)
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
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
