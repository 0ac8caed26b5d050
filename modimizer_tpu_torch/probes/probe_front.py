"""Port of ``scripts/probe_front.py``: the scan front's micro-ops, one
kernel each, over u32 [8, 128, 1024] (8 tiles of 128 x 1024).

  copy, static16 (a constant rotate), dyn (the funnel's variable shift, at
  its last phase a rotate by 30), mul10 (ten dependent multiply-adds),
  iota (adds 16 (col * 128 + row))

Each is the ``front_ops`` kernel, held against its plain version on the
same input before it is timed.  As the script's grid visited every tile 16
times (r = 0 .. 15) and kept the last, the kernel runs each element's body
16 times, r a runtime value, each pass fed by the one before.

Usage: python -m modimizer_tpu_torch.probes.probe_front [names ...]
"""

import argparse
import sys

import numpy as np
import torch

from ..ops.front_ops import OPS, front_ops, front_ops_ref
from . import resolve_device
from ._timing import report

T, LANES, R = 8, 128, 1024


def tiles(device):
    """The script's input: u32 [T, 128, 1024] from numpy default_rng(0)."""
    x = np.random.default_rng(0).integers(0, 2 ** 32, (T, LANES, R),
                                          dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_front",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(OPS))
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    for n in a.names:
        if n not in OPS:
            raise SystemExit("probe_front: unknown op %r; ported: %s"
                             % (n, ",".join(OPS)))
    dev = resolve_device(device)
    x = tiles(dev)
    ok = True
    for n in a.names:
        ok &= report({"probe": "probe_front", "variant": n,
                      "kernel": "front_ops", "shape": list(x.shape)},
                     lambda: (front_ops(x, n),),
                     lambda: (front_ops_ref(x, n),), device=dev,
                     work=x.numel(), unit="melem_s", reads=(x,))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
