"""Port of ``scripts/probe_pallas_parts.py``: the k = 16 front with one
piece ablated at a time, to show where its time goes on the card.

  full   : the front, writing the (k-mer u32, emit i8) planes: the baseline.
  noin   : the same compute, with the streams made in the kernel from the
           block's lane iota: no input reads.
  noout  : the same compute and reads; the only output is an [8, 128]
           accumulator of (km & 0xFFFF) + 65536 emit: no plane stores.
  kmonly : the k-mer plane alone (emit ? km : ~km).
  emonly : the emit plane alone (emit & km != 0).

``noout`` is the ``front_reduce`` kernel, the others the ``front_planes``
kernel; each is held against its plain version on the same streams before
it is timed, ``emonly`` and ``noout`` also with a cold L2; on the card
``emonly`` is followed by a ``copy`` line: ``x.clone()`` of C bytes, which
moves the bytes ``emonly`` moves, warm and cold.  ``--baseline
SRC.cu`` compiles SRC as it stands (nvcc with the port's flags) into a
library of its own in ``SRC``'s directory, ``_build/``, and launches its
``mz_front_planes`` with the interface its source declares: with an ``acc``
output (before csrc/front_reduce.cu: ``noout`` and ``count``, on that
wrapper's grid), or without (``emonly``; on emit_grid's blocks when the
library has ``mz_front_emit_blocks_per_sm``, else on the quad map's grid).
``noout`` and ``emonly`` then also print a line of the two kernels timed in
turns (baseline, current, current, baseline), warm and with a cold L2, at C
and 2C, each held against ``front_planes_ref`` before and after, with each
kernel's two-point fit (ms per 2^24 positions, and the fixed ms)::

    git show REV:modimizer_tpu_torch/csrc/front_planes.cu > old/fp.cu
    python -m modimizer_tpu_torch.probes.probe_pallas_parts 24 4096 emonly \
        --baseline old/fp.cu

Usage: python -m modimizer_tpu_torch.probes.probe_pallas_parts
       [C_log2] [MJ] [variants] [--baseline SRC.cu]
"""

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import torch

from .. import _build
from ..core.seqhash import Seqhash
from ..ops.front_kernel import (OUTPUTS, REDUCE_VARIANTS, VARIANTS,
                                emit_grid, front_planes, front_planes_ref)
from . import SEED, front_inputs, resolve_device, variants
from ._timing import bound_ms, card_line, nbytes, report, same, time_ms

K, W = 16, 16
PORTED = ("full", "noin", "noout", "kmonly", "emonly")
# the variants also timed with a cold L2, and in turns with a --baseline
TURNS = ("noout", "emonly")
# the quad map's grid: 512 threads a block, at most 4 blocks an SM
BASELINE_THREADS, BASELINE_BLOCKS_PER_SM = 512, 4


def load_front_baseline(src):
    """Build ``src`` into its own library, with the interface its source
    declares: ``mz_front_planes`` with the ``acc`` output (before
    csrc/front_reduce.cu; ``L.variants`` noout and count) or without it
    (the planes variants)."""
    sig = re.search(r"int mz_front_planes\(([^)]*)\)", Path(src).read_text())
    if sig is None:
        raise SystemExit("%s declares no mz_front_planes" % src)
    acc = "acc" in sig.group(1)
    L = _build.build_aside(src)
    p = ctypes.c_void_p
    L.mz_front_planes.restype = ctypes.c_int
    L.mz_front_planes.argtypes = [
        p, p, p, p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_uint32, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        p, p] + [p] * acc + [  # km, em (, acc)
        p]                     # stream
    L.acc = acc
    L.variants = REDUCE_VARIANTS if acc else tuple(
        v for v in VARIANTS if v not in REDUCE_VARIANTS)
    if hasattr(L, "mz_front_emit_blocks_per_sm"):
        L.mz_front_emit_blocks_per_sm.argtypes = [p]
    return L


def baseline_grid(L, NJ, variant, dev):
    """The baseline's blocks: emit_grid's for emonly when the library has
    its occupancy entry, else the quad map's."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if variant == "emonly" and hasattr(L, "mz_front_emit_blocks_per_sm"):
        n = ctypes.c_int(0)
        if L.mz_front_emit_blocks_per_sm(ctypes.byref(n)) or n.value < 1:
            raise RuntimeError("baseline front_planes: no emonly occupancy")
        return emit_grid(NJ, n.value, sms)
    return min(-(-4 * NJ // BASELINE_THREADS), BASELINE_BLOCKS_PER_SM * sms)


def launch_front_baseline(L, streams, *, factor1, w, variant, mj):
    """The baseline library's ``variant`` into new outputs, as the current
    wrapper returns them."""
    NJ = streams[0].shape[0]
    dev = streams[0].device
    if variant not in L.variants:
        raise ValueError("baseline front_planes has no %s" % variant)
    if L.acc:
        out = {"acc": torch.empty((8, 128) if variant == "noout" else (),
                                  dtype=torch.int64, device=dev)}
        ptrs = [None, None, out["acc"].data_ptr()]
    else:
        shapes = {"km": torch.int32, "em": torch.int8}
        out = {n: torch.empty(16 * NJ, dtype=shapes[n], device=dev)
               for n in OUTPUTS[variant]}
        ptrs = [out[n].data_ptr() if n in out else None for n in shapes]
    rc = L.mz_front_planes(
        *(t.data_ptr() for t in streams), NJ, VARIANTS.index(variant),
        ctypes.c_uint64(factor1), ctypes.c_uint32(w - 1), mj, 0,
        baseline_grid(L, NJ, variant, dev), *ptrs,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError("baseline front_planes: CUDA error %d" % rc)
    return tuple(out[n] for n in OUTPUTS[variant])


def turns(L, probe, variant, C_log2, mj, dev):
    """The baseline and current kernels of ``variant`` at C = 2^C_log2 and
    2C on the probes' inputs, each held against front_planes_ref, then
    timed baseline, current, current, baseline, warm and then with a cold
    L2, then held again (the launches in between must leave no residue);
    with the fit t = fixed + C / 2^24 * per_2^24 of each from its best
    times at the two sizes.  Returns (ok, line)."""
    factor1 = Seqhash.create(K, W, SEED).factor1
    args = dict(factor1=factor1, w=W, variant=variant, mj=mj)
    ok, sizes = True, {}
    for c in (C_log2, C_log2 + 1):
        C, _sw, st = front_inputs(c, dev, K, mj)
        fns = {"baseline": lambda: launch_front_baseline(L, st, **args),
               "current": lambda: front_planes(*st, **args)}
        want = front_planes_ref(*st, **args)
        checks = {who: same(fn(), want) for who, fn in fns.items()}
        ok &= all(checks.values())
        times = {cold: {who: [] for who in fns} for cold in ("ms", "cold_ms")}
        for cold in times:
            for who in ("baseline", "current", "current", "baseline"):
                times[cold][who].append(
                    time_ms(fns[who], cold=cold == "cold_ms")[0])
        after = {who: same(fn(), want) for who, fn in fns.items()}
        ok &= all(after.values())
        b_ms, b_by = bound_ms(nbytes(*st, *want))
        sizes[C] = {"check": {who: "match" if m else "DIFF"
                              for who, m in checks.items()},
                    "check_after": {who: "match" if m else "DIFF"
                                    for who, m in after.items()},
                    "bound_ms": b_ms, "bound_by": b_by}
        for key, t in times.items():
            cur, old = min(t["current"]), min(t["baseline"])
            pre = "" if key == "ms" else "cold_"
            sizes[C].update({key: t, pre + "speedup": old / cur,
                             pre + "bound_share": b_ms / cur,
                             pre + "baseline_bound_share": b_ms / old})
    (c1, s1), (c2, s2) = sizes.items()
    fit = {}
    for key in ("ms", "cold_ms"):
        for who in ("baseline", "current"):
            t1, t2 = min(s1[key][who]), min(s2[key][who])
            per = (t2 - t1) / (c2 - c1) * (1 << 24)
            fit[("" if key == "ms" else "cold_") + who] = {
                "ms_per_2^24": per, "fixed_ms": t1 - per * c1 / (1 << 24)}
    return ok, {"probe": probe, "variant": variant, "turns": True, "k": K,
                "w": W, "mj": mj, "sizes": sizes, "fit": fit,
                "device": torch.cuda.get_device_name(dev),
                "card": card_line()}


def baseline_library(src, dev, probe):
    """The --baseline library, or None; it needs the card."""
    if src and dev.type != "cuda":
        raise SystemExit("%s: --baseline needs the card" % probe)
    return load_front_baseline(src) if src else None


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_pallas_parts",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("C_log2", nargs="?", type=int, default=24)
    ap.add_argument("MJ", nargs="?", type=int, default=4096)
    ap.add_argument("variants", nargs="?", default=",".join(PORTED))
    ap.add_argument("--baseline", metavar="SRC.cu",
                    help="an earlier front_planes.cu to time beside "
                    "noout or emonly")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    names = variants(a.variants, PORTED, "probe_pallas_parts")
    dev = resolve_device(device)
    L = baseline_library(a.baseline, dev, "probe_pallas_parts")
    C, _sw, streams = front_inputs(a.C_log2, dev, K, a.MJ)
    factor1 = Seqhash.create(K, W, SEED).factor1
    ok = True
    for v in names:
        args = dict(factor1=factor1, w=W, variant=v, mj=a.MJ)
        ok &= report({"probe": "probe_pallas_parts", "variant": v,
                      "kernel": ("front_reduce" if v == "noout"
                                 else "front_planes"),
                      "C": C, "mj": a.MJ, "k": K, "w": W},
                     lambda: front_planes(*streams, **args),
                     lambda: front_planes_ref(*streams, **args),
                     device=dev, work=C, cold=v in TURNS,
                     reads=() if v == "noin" else streams)
        if v in TURNS and L is not None:
            if v not in L.variants:
                print(json.dumps({"probe": "probe_pallas_parts",
                                  "variant": v, "turns": False,
                                  "reason": "the baseline has no %s" % v}),
                      flush=True)
                continue
            good, line = turns(L, "probe_pallas_parts", v, a.C_log2, a.MJ,
                               dev)
            ok &= good
            print(json.dumps(line), flush=True)
    if "emonly" in names and dev.type == "cuda":
        # a yardstick on the card: a copy moves emonly's bytes (C read, C
        # written) with no arithmetic
        x = torch.empty(C, dtype=torch.int8, device=dev)
        report({"probe": "probe_pallas_parts", "variant": "copy",
                "kernel": None, "library": "x.clone() of C int8",
                "C": C}, lambda: (x.clone(),), None, device=dev, work=C,
               check=False, reads=(x,), cold=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
