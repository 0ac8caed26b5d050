"""The scan-front probes on PyTorch and CUDA: where the scan's time goes.

Ports of the JAX package's ``scripts/probe_*.py`` that time the k = 16 u32
front and its ablations (``probe_pallas_parts``, ``probe_pallas_front``,
``probe_chain_time``, ``probe_front_mxu``), its micro-ops
(``probe_front``) and the compaction primitives (``probe_mosaic_prims``).
Each is a module with ``main(argv=None, device=None)``
that takes the script's positional arguments and variant names, holds each
kernel against its plain version on the same inputs, times both on the card
and prints one JSON line per variant::

    python -m modimizer_tpu_torch.probes.probe_pallas_parts 24 4096 full,noin

``device=None`` means the CUDA card (and raises without one); ``"cpu"`` runs
the plain versions and times nothing, as the CPU tests do.
"""

import numpy as np
import torch

from .. import require_cuda
from ..ops.front_kernel import make_streams

SEED = 17              # the scripts' Seqhash seed
DATA_SEED = 42         # the scripts' numpy default_rng seed for the bases


def resolve_device(device):
    return require_cuda() if device is None else torch.device(device)


def random_sw(C: int, k: int, device, seed: int = DATA_SEED):
    """The scripts' input: C + k - 1 uniform bases from numpy
    default_rng(seed), packed 2 bits a base, big-endian per 64-bit word,
    into C/32 + 2 words (native ``pk_pack2``, not the JAX packer), as an
    int64 tensor on ``device``."""
    from modimizer_tpu.native import lib as native_lib
    n = C + k - 1
    codes = np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)
    sw = np.empty(C // 32 + 2, np.uint64)
    native_lib().pk_pack2(codes, n, sw, len(sw))
    return torch.from_numpy(sw.view(np.int64)).to(device)


def front_inputs(C_log2: int, device, k: int = 16, mj: int = 128):
    """(C, sw, (pa, pb, za, zb)) for a chunk of C = 2^C_log2 positions, in
    blocks of mj words (a multiple of 128 that divides C/16)."""
    if not 11 <= C_log2 <= 30:
        raise SystemExit("C_log2=%d outside [11, 30]" % C_log2)
    C = 1 << C_log2
    if mj <= 0 or mj % 128 or (C // 16) % mj:
        raise SystemExit("MJ=%d is not a multiple of 128 that divides "
                         "C/16 = %d" % (mj, C // 16))
    sw = random_sw(C, k, device)
    return C, sw, make_streams(sw, C // 16)


def variants(arg: str, ported, probe: str, unported=()):
    """The comma-separated variant list, in order.  A name the port carries
    not raises SystemExit (a non-zero exit), never a silent skip."""
    names = [v for v in arg.split(",") if v]
    for v in names:
        if v in unported:
            raise SystemExit(
                "%s: %r is a TPU-only backend, which the port does not "
                "carry (ROADMAP.md: \"Do not port the losing TPU-only "
                "backends\"); ported: %s" % (probe, v, ",".join(ported)))
        if v not in ported:
            raise SystemExit("%s: unknown variant %r; ported: %s"
                             % (probe, v, ",".join(ported)))
    return names
