"""Port of ``scripts/probe_mosaic_prims.py``: the compaction primitives,
one kernel each, on the script's inputs for C = 2^24 positions.

  tala16     per-lane gather of 8 of 16 rows, x and idx u32 [16, C/16]
             (``arange`` and ``arange * 7``)
  roll       12 roll-and-add stages along 4096-wide blocks of u32
             [16, C/16] (``arange``)
  cumsum128  row prefix sums of i8 [C/128, 128] ones, by tensor-core
             products against the upper triangle
  dot16      one-hot compaction of C/1024 blocks of 1024 positions: ranks
             ``arange % 117`` (ranks >= 112 land nowhere), cols i8 ones
             [C/1024, 1024, 8].  The script built one grid step's inputs
             and ran 16 steps over them; here they cover the C positions
             it meant.

Each kernel is held against its plain version on the same inputs before it
is timed; a disagreement exits non-zero.  At the default C the times are
ms per 2^24.

Usage: python -m modimizer_tpu_torch.probes.probe_mosaic_prims
           [--log2c 24] [tala16 roll cumsum128 dot16]
"""

import argparse
import sys

import torch

from ..ops.front_kernel import M32, u32_as_i32
from ..ops.mosaic_prims import (DOT_BLK, DOT_NC, cumsum128,
                                cumsum128_ref, dot16, dot16_ref, roll12,
                                roll12_ref, tala16, tala16_ref)
from . import resolve_device
from ._timing import report

NAMES = ("tala16", "roll", "cumsum128", "dot16")
KERNEL = {"tala16": "tala16", "roll": "roll12", "cumsum128": "cumsum128",
          "dot16": "dot16"}


def inputs(name, C, device):
    """The script's inputs for probe ``name`` at C positions."""
    NJ = C // 16
    ar = torch.arange(16 * NJ, dtype=torch.int64, device=device)
    if name == "tala16":
        return (u32_as_i32(ar).view(16, NJ),
                u32_as_i32((ar * 7) & M32).view(16, NJ))
    if name == "roll":
        return (u32_as_i32(ar).view(16, NJ),)
    if name == "cumsum128":
        return (torch.ones((C // 128, 128), dtype=torch.int8, device=device),)
    nb = C // DOT_BLK
    rank = (torch.arange(nb * DOT_BLK, dtype=torch.int32, device=device)
            % 117).view(nb, DOT_BLK)
    return rank, torch.ones((nb, DOT_BLK, DOT_NC), dtype=torch.int8,
                            device=device)


FUNCS = {"tala16": (tala16, tala16_ref), "roll": (roll12, roll12_ref),
         "cumsum128": (cumsum128, cumsum128_ref), "dot16": (dot16, dot16_ref)}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_mosaic_prims",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(NAMES))
    ap.add_argument("--log2c", type=int, default=24,
                    help="positions C = 2^LOG2C (16..28; default 24)")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    for n in a.names:
        if n not in NAMES:
            raise SystemExit("probe_mosaic_prims: unknown probe %r; ported: "
                             "%s" % (n, ",".join(NAMES)))
    if not 16 <= a.log2c <= 28:     # roll's 4096-wide blocks need C >= 2^16
        raise SystemExit("probe_mosaic_prims: --log2c %d outside [16, 28]"
                         % a.log2c)
    dev = resolve_device(device)
    C = 1 << a.log2c
    ok = True
    for n in a.names:
        args = inputs(n, C, dev)
        fn, plain = FUNCS[n]
        ok &= report({"probe": "probe_mosaic_prims", "variant": n,
                      "kernel": KERNEL[n], "C": C,
                      "shapes": [list(t.shape) for t in args]},
                     lambda: (fn(*args),), lambda: (plain(*args),),
                     device=dev, work=C)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
