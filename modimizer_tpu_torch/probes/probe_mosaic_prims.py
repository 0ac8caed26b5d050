"""Port of ``scripts/probe_mosaic_prims.py``: the compaction primitives,
one kernel each, on the script's inputs for C = 2^24 positions.

  tala16     per-lane gather of 8 of 16 rows, x and idx u32 [16, C/16]
             (``arange`` and ``arange * 7``)
  roll       12 roll-and-add stages along 4096-wide blocks of u32
             [16, C/16] (``arange``)
  cumsum128  row prefix sums of i8 [C/128, 128] ones, by tensor-core
             products against the upper triangle
  dot16      compaction of C/1024 blocks of 1024 positions (the script's
             one-hot product; a segment sum on the card): ranks ``arange %
             117`` (ranks >= 112 land nowhere), cols i8 ones [C/1024, 1024,
             8].  The script built one grid step's inputs and ran 16 steps
             over them; here they cover the C positions it meant.

Each kernel is held against its plain version on the same inputs before it
is timed; a disagreement exits non-zero.  At the default C the times are
ms per 2^24.

``--baseline SRC.cu`` compiles SRC as it stands (nvcc with the port's
flags) into a library of its own in ``SRC``'s directory, ``_build/``, and
calls its ``mz_dot16`` and ``mz_roll12`` (the same C interface): ``dot16``
and ``roll`` then also print a line of the two kernels timed in turns
(baseline, current, current, baseline), each first held against its plain
version, and ``dot16`` one more on ranks as a compaction gives them
(``run_ranks``)::

    git show REV:modimizer_tpu_torch/csrc/mosaic_prims.cu > old/mp.cu
    python -m modimizer_tpu_torch.probes.probe_mosaic_prims dot16 roll \
        --baseline old/mp.cu

Usage: python -m modimizer_tpu_torch.probes.probe_mosaic_prims
           [--log2c 24] [tala16 roll cumsum128 dot16] [--baseline SRC.cu]
"""

import argparse
import ctypes
import json
import sys

import torch

from .. import _build
from ..ops.front_kernel import M32, u32_as_i32
from ..ops.mosaic_prims import (CS_W, DOT_BLK, DOT_BO, DOT_NC, TALA_OUT,
                                cumsum128, cumsum128_ref, dot16, dot16_ref,
                                roll12, roll12_ref, tala16, tala16_ref)
from . import resolve_device
from ._timing import bound_ms, card_line, nbytes, report, time_ms

NAMES = ("tala16", "roll", "cumsum128", "dot16")
KERNEL = {"tala16": "tala16", "roll": "roll12", "cumsum128": "cumsum128",
          "dot16": "dot16"}
RUN_SEED = 17


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


def reads(name, args):
    """The inputs probe ``name``'s function reads: tala16 only the first 8
    of idx's 16 rows."""
    return (args[0], args[1][:TALA_OUT]) if name == "tala16" else args


def run_ranks(nb, device, seed=RUN_SEED):
    """dot16's inputs as a compaction gives them: in each 1024-position
    block the exclusive cumsum of a random 1-in-8 emit mask, -1 where a
    position does not emit; cols random signed i8."""
    g = torch.Generator(device=device).manual_seed(seed)
    emit = torch.rand((nb, DOT_BLK), generator=g, device=device) < 0.125
    rank = torch.cumsum(emit, 1, dtype=torch.int32) - emit.to(torch.int32)
    cols = torch.randint(-128, 128, (nb, DOT_BLK, DOT_NC), generator=g,
                         device=device, dtype=torch.int8)
    return torch.where(emit, rank, -1), cols


def int8_ops(name, args):
    """int8 tensor-core operations of the kernels built on them:
    cumsum128's [128 x 128] triangle a row.  dot16 issues none: the TPU's
    one-hot product is a segment sum into a shared-memory table on the
    card."""
    if name == "cumsum128":
        return args[0].shape[0] * CS_W * CS_W * 2
    return 0


FUNCS = {"tala16": (tala16, tala16_ref), "roll": (roll12, roll12_ref),
         "cumsum128": (cumsum128, cumsum128_ref), "dot16": (dot16, dot16_ref)}


def load_baseline(src):
    """Build ``src`` into its own library; its ``mz_dot16`` and
    ``mz_roll12`` have the current interface."""
    L = _build.build_aside(src)
    for name in ("mz_dot16", "mz_roll12"):
        getattr(L, name).restype = ctypes.c_int
        getattr(L, name).argtypes = getattr(_build.lib(), name).argtypes
    return L


def launch_aside(L, name, args):
    """The baseline library's ``mz_<name>`` (dot16 or roll12) on args, into
    a new output."""
    if name == "dot16":
        rank, cols = args
        out = torch.empty((rank.shape[0], DOT_BO, DOT_NC), dtype=torch.int32,
                          device=rank.device)
        cargs = (rank.data_ptr(), cols.data_ptr(), rank.shape[0])
    else:
        (x,) = args
        out = torch.empty_like(x)
        cargs = (x.data_ptr(), x.shape[0], x.shape[1])
    rc = getattr(L, "mz_" + name)(
        *cargs, out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    if rc:
        raise RuntimeError("baseline %s: CUDA error %d" % (name, rc))
    return out


def in_turns(L, n, args, C, dev, ranks):
    """The baseline and current kernels of probe ``n``, each held against
    its plain version, then timed baseline, current, current, baseline;
    returns (ok, line)."""
    fn, plain = FUNCS[n]
    fns = {"baseline": lambda: launch_aside(L, KERNEL[n], args),
           "current": lambda: fn(*args)}
    want = plain(*args)
    checks = {who: bool(torch.equal(f(), want)) for who, f in fns.items()}
    times = {who: [] for who in fns}
    for who in ("baseline", "current", "current", "baseline"):
        times[who].append(time_ms(fns[who])[0])
    b_ms, b_by = bound_ms(nbytes(*reads(n, args), want), int8_ops(n, args))
    cur, old = min(times["current"]), min(times["baseline"])
    return all(checks.values()), {
        "probe": "probe_mosaic_prims", "variant": n, "kernel": KERNEL[n],
        "turns": True, "ranks": ranks, "C": C,
        "check": {who: "match" if c else "DIFF" for who, c in checks.items()},
        "ms": times, "speedup": old / cur, "bound_ms": b_ms,
        "bound_by": b_by, "bound_share": b_ms / cur,
        "baseline_bound_share": b_ms / old,
        "device": torch.cuda.get_device_name(dev), "card": card_line()}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_mosaic_prims",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(NAMES))
    ap.add_argument("--log2c", type=int, default=24,
                    help="positions C = 2^LOG2C (16..28; default 24)")
    ap.add_argument("--baseline", metavar="SRC.cu",
                    help="an earlier mosaic_prims.cu to time dot16 and "
                    "roll beside")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    for n in a.names:
        if n not in NAMES:
            raise SystemExit("probe_mosaic_prims: unknown probe %r; ported: "
                             "%s" % (n, ",".join(NAMES)))
    if not 16 <= a.log2c <= 28:     # roll's 4096-wide blocks need C >= 2^16
        raise SystemExit("probe_mosaic_prims: --log2c %d outside [16, 28]"
                         % a.log2c)
    dev = resolve_device(device)
    if a.baseline and dev.type != "cuda":
        raise SystemExit("probe_mosaic_prims: --baseline needs the card")
    L = load_baseline(a.baseline) if a.baseline else None
    C = 1 << a.log2c
    ok = True
    for n in a.names:
        args = inputs(n, C, dev)
        fn, plain = FUNCS[n]
        ok &= report({"probe": "probe_mosaic_prims", "variant": n,
                      "kernel": KERNEL[n], "C": C,
                      "shapes": [list(t.shape) for t in args]},
                     lambda: (fn(*args),), lambda: (plain(*args),),
                     device=dev, work=C, reads=reads(n, args),
                     int8_ops=int8_ops(n, args))
        if L is None or n not in ("dot16", "roll"):
            continue
        turns = [(args, "probe")]
        if n == "dot16":
            turns.append((run_ranks(C // DOT_BLK, dev), "runs"))
        for targs, ranks in turns:
            good, line = in_turns(L, n, targs, C, dev, ranks)
            ok &= good
            print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
