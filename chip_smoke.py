#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels from
this checkout, holds each against its plain PyTorch version, drives the
port's ``modutils -a`` at full size through both of its device paths (the
device count of the builder, and the streaming scanner) and checks each .mod
against the native host path byte for byte, profiles both paths (stage
timers, the card's busy time and idle share), then runs the scan-front and
compaction-primitive probes on the card.

    python3 chip_smoke.py                 # every phase, one CUDA card
    python3 chip_smoke.py --phases env,build,kernels --small
    python3 chip_smoke.py --phases env,build,kernels,probes

Prints one JSON line per phase, then a ``{"kernels": [...]}`` line (each
kernel with its launches on the main path, its error against its plain
version, its time, its plain version's, its bound and, where one PyTorch
call computes the same function, that call's time), the card's ``name,
power.limit`` line from nvidia-smi, and last ``{"ok": true, "device":
{...}}``.  Exits non-zero, without that last line, when CUDA is absent, the
port cannot be imported (e.g. this file alone in a directory), a kernel
fails to build or launch, or any check disagrees.  Imports nothing of JAX
and nothing of the JAX package: the host path it checks against is the
port's own native host scan.
"""

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "build", "kernels", "main", "overflow", "profile",
          "probes")
KW_PAIRS = [(16, 16), (11, 10), (13, 31), (19, 31), (24, 16), (31, 31)]
# the emit test's edges on both k-mer widths: w = 1 (every position emits)
# and w = 2^32 + 1 (a 32-bit hash is a multiple only when it is 0)
KW_EDGES = [(16, 1), (19, 1), (16, (1 << 32) + 1), (19, (1 << 32) + 1)]
BLK_SIZES = (128, 4096)      # besides BLK_COMPACT
# scan_compact's (meta_isf, with_meta): positions (the builder), (p << 1) |
# isF (scan_stream), k-mers only (the scanner's modutils -a)
META_MODES = ((False, True), (True, True), (False, False))
SEED = 17
# what modutils -a launches on each path: the builder's device count (inputs
# of 2^25 bases or more), and the streaming scanner
PATH_KERNELS = {"builder": ("scan_compact",),
                "scanner": ("scan_compact", "densify")}
PROBE_KERNELS = ("front_planes", "front_mma", "front_ops", "tala16", "dot16",
                 "roll12", "cumsum128")
FRONT_KERNELS, MOSAIC_KERNELS = PROBE_KERNELS[:3], PROBE_KERNELS[3:]
FRONT_W = (2, 16, 64)


def say(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit("chip_smoke FAILED: " + msg)


@contextlib.contextmanager
def environ(**values):
    """os.environ with ``values`` set, restored on exit."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs

def random_chunk(rng, C, k, poly_a=False):
    """(sw, vbits) int64 CUDA tensors for one chunk of C positions: random
    bases (or all A) packed by the native packer, read-boundary validity
    from random read lengths."""
    import numpy as np
    import torch
    from modimizer_tpu_torch.native import lib as native_lib
    n = C + k - 1
    codes = (np.zeros(n, np.uint8) if poly_a
             else rng.integers(0, 4, n).astype(np.uint8))
    sw = np.empty(C // 32 + 2, np.uint64)
    native_lib().pk_pack2(codes, n, sw, len(sw))
    if poly_a:
        offsets = np.array([0, n], np.int64)
    else:
        lens = rng.integers(50, 2000, n // 50 + 2)
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        offsets = offsets[:np.searchsorted(offsets, n) + 1]
        offsets[-1] = n
    vb = np.empty(C // 64, np.uint64)
    native_lib().pk_valid_words(offsets, len(offsets) - 1, n, k, vb, len(vb))
    dev = torch.device("cuda")
    return (torch.from_numpy(sw.view(np.int64)).to(dev),
            torch.from_numpy(vb.view(np.int64)).to(dev))


def max_abs_err(pairs):
    """0 when every pair is bit-identical, else the largest |a - b|; a pair
    of absent outputs (None) agrees."""
    import torch
    err = 0.0
    for a, b in pairs:
        if a is None or b is None:
            if a is not b:
                return float("inf")
            continue
        if a.shape != b.shape:
            return float("inf")
        if not torch.equal(a, b):
            d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
            err = max(err, float(d), 1.0)
    return err


# ---------------------------------------------------------------- phases

def phase_env():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail("compute capability %s, want (9, 0) (Hopper)" % (cap,))
    from modimizer_tpu_torch._build import _nvcc
    nv = subprocess.run([_nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    say({"phase": "env", "nvidia_smi": nvidia_smi_line(),
         "torch": torch.__version__, "torch_cuda": torch.version.cuda,
         "nvcc": nv[-1], "capability": list(cap),
         "device_count": torch.cuda.device_count()})


def phase_build():
    """The CUDA kernels (one nvcc a source, then a link) and the port's
    native host library (g++), each timed."""
    from modimizer_tpu_torch import _build, native
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    t1 = time.perf_counter()
    native.lib()
    say({"phase": "build", "seconds": round(t1 - t0, 3),
         "native_seconds": round(time.perf_counter() - t1, 3),
         "library": os.path.relpath(so, HERE),
         "sources": [os.path.relpath(s, HERE) for s in _build.sources()]})


def phase_kernels(small, report):
    """Each kernel against its plain version on the card, bit for bit."""
    import numpy as np
    import torch
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.ops.device_scan import densify, densify_ref
    from modimizer_tpu_torch.ops.scan_kernel import (kernel_params,
                                                     scan_compact,
                                                     scan_compact_ref)
    from modimizer_tpu_torch.ops.consts import BLK_COMPACT, scan_bo
    from modimizer_tpu_torch.ops.seqhash import ModimizerScanner
    rng = np.random.default_rng(SEED)
    sizes = [1 << 15] if small else [1 << 15, 1 << 25]
    errs = {"scan_compact": 0.0, "densify": 0.0}
    n_cases = n_densify = 0

    def check_scan(sw, vb, kp, C, bo, meta_isf, tag, blk=BLK_COMPACT,
                   with_meta=True):
        nonlocal n_cases
        args = dict(k=kp.k, w=kp.w, factor1=kp.factor1, C=C, bo=bo,
                    meta_isf=meta_isf, blk=blk, with_meta=with_meta)
        got = scan_compact(sw, vb, **args)
        want = scan_compact_ref(sw, vb, **args)
        torch.cuda.synchronize()
        e = max_abs_err(zip(got, want))
        errs["scan_compact"] = max(errs["scan_compact"], e)
        n_cases += 1
        if e:
            fail("scan_compact != scan_compact_ref at %s" % tag)
        return got

    def check_densify(rows, bo, cap, tag):
        nonlocal n_densify
        out_k, out_meta, cnt = rows[0], rows[1], rows[2]
        for meta in (None, out_meta)[:1 if out_meta is None else 2]:
            got = densify(out_k, meta, cnt, bo=bo, cap=cap)
            want = densify_ref(out_k, meta, cnt, bo=bo, cap=cap)
            torch.cuda.synchronize()
            pairs = [(got[0], want[0])]
            if meta is not None:
                pairs.append((got[1], want[1]))
            e = max_abs_err(pairs)
            errs["densify"] = max(errs["densify"], e)
            n_densify += 1
            if e:
                fail("densify != densify_ref at %s meta=%s"
                     % (tag, meta is not None))

    # (k, w, blk) cases: the six pairs, the emit test's edges, and k16 w16 /
    # k19 w31 in compaction blocks of 128 and 4096 positions
    cases = ([(k, w, BLK_COMPACT) for k, w in KW_PAIRS + KW_EDGES]
             + [(k, w, blk) for blk in BLK_SIZES
                for k, w in ((16, 16), (19, 31))])
    for C in sizes:
        for k, w, blk in cases:
            sh = Seqhash.create(k, w, SEED)
            kp = kernel_params(sh)
            sw, vb = random_chunk(rng, C, k)
            bo = scan_bo(w, blk)
            cap = min((C // blk) * bo,
                      ModimizerScanner(sh, chunk=C, device="cuda").cap)
            for meta_isf, with_meta in META_MODES:
                tag = "C=2^%d k=%d w=%d blk=%d meta_isf=%s with_meta=%s" % (
                    C.bit_length() - 1, k, w, blk, meta_isf, with_meta)
                rows = check_scan(sw, vb, kp, C, bo, meta_isf, tag, blk,
                                  with_meta)
                check_densify(rows, bo, cap, tag)
    # poly-A: k-mer 0 hashes to 0, every position emits, every block
    # overflows bo
    C = sizes[-1]
    sh = Seqhash.create(16, 16, SEED)
    kp = kernel_params(sh)
    sw, vb = random_chunk(rng, C, 16, poly_a=True)
    bo = scan_bo(16)
    rows = check_scan(sw, vb, kp, C, bo, False, "poly-A")
    if not bool(rows[4]) or int((rows[2] > bo).sum()) != rows[2].numel():
        fail("poly-A chunk did not overflow every block")
    check_densify(rows, bo, C // 4, "poly-A")
    # densify's edges at the largest size, k16 w16 with (p << 1) | isF: a
    # chunk with no live row, a cap below the live rows, and the scanner's
    # wide retry (bo x 4, cap x 4); blk 128 at 2^25 (262,144 blocks, 1,024
    # tiles) is among the cases above
    scanner = ModimizerScanner(sh, chunk=C, device="cuda")
    sw, vb = random_chunk(rng, C, 16)
    rows = check_scan(sw, torch.zeros_like(vb), kp, C, bo, True, "empty")
    if int(rows[2].sum()):
        fail("a chunk with no valid position emitted")
    check_densify(rows, bo, scanner.cap, "empty chunk")
    rows = check_scan(sw, vb, kp, C, bo, True, "cap cut")
    live = int(rows[2].clamp(max=bo).sum())
    check_densify(rows, bo, live // 2 + 1, "cap cut at %d of %d rows"
                  % (live // 2 + 1, live))
    wide_bo, wide_cap = scanner._wide()
    rows = check_scan(sw, vb, kp, C, wide_bo, True, "wide retry")
    check_densify(rows, wide_bo, wide_cap, "wide retry bo=%d cap=%d"
                  % (wide_bo, wide_cap))
    say({"phase": "kernels", "cases": n_cases, "densify_cases": n_densify,
         "sizes": sizes, "kwb": cases, "max_abs_err": errs})
    time_scan_kernels(small, report, errs)
    check_front_kernels(small, rng, report)
    check_mosaic_kernels(small, rng, report)


def time_scan_kernels(small, report, errs):
    """scan_compact at probe_scan_compact's shapes (the scanner's chunk of
    2^25 at k16 w16 and at k19 w31, the builder's 2^22 at k16 w16, and a w
    that never emits; 2^15 with --small), each beside its plain version and
    its bound; densify at probe_densify's shapes (the scanner's rows at k16
    w16 and k19 w31, k-mers only, and the meta form), each beside its plain
    version, its bound and torch.masked_select of the live rows."""
    import torch
    from modimizer_tpu_torch.ops.device_scan import densify, densify_ref
    from modimizer_tpu_torch.ops.scan_kernel import (scan_compact,
                                                     scan_compact_ref)
    from modimizer_tpu_torch.probes import probe_densify as pd
    from modimizer_tpu_torch.probes import probe_scan_compact as psc
    from modimizer_tpu_torch.probes._timing import bound_ms
    from modimizer_tpu_torch.probes._timing import time_ms as device_ms
    dev = torch.device("cuda")
    shapes = {}
    for name, (logc, k, w, _with_meta) in psc.SHAPES.items():
        C = 1 << (15 if small else logc)
        sw, vb, args = psc.shape_inputs(name, C, dev)
        # device time with the launches queued ahead
        ms = device_ms(lambda: scan_compact(sw, vb, **args), 20)[0]
        plain = device_ms(lambda: scan_compact_ref(sw, vb, **args), 3, 1)[0]
        b_ms, b_by = bound_ms(psc.scan_compact_bytes(
            sw, vb, C, args["bo"], args["with_meta"]))
        shapes[name] = {"C": C, "k": k, "w": w, "bo": args["bo"],
                        "with_meta": args["with_meta"], "ms": ms,
                        "plain_ms": plain, "bound_ms": b_ms,
                        "bound_by": b_by, "bound_share": b_ms / ms}
    d_shapes = {}
    for name, (logc, k, w, with_meta) in pd.SHAPES.items():
        C = 1 << (15 if small else logc)
        out_k, out_meta, cnt, bo, cap = pd.shape_rows(name, C, dev)
        d_ms = device_ms(lambda: densify(out_k, out_meta, cnt, bo=bo,
                                         cap=cap), 20)[0]
        d_plain = device_ms(lambda: densify_ref(out_k, out_meta, cnt, bo=bo,
                                                cap=cap), 3, 1)[0]
        d_near = device_ms(pd.nearest_call(out_k, out_meta, cnt, bo), 20)[0]
        b_ms, b_by = bound_ms(pd.densify_bytes(cnt, bo, cap, with_meta))
        d_shapes[name] = {"C": C, "k": k, "w": w, "bo": bo, "cap": cap,
                          "with_meta": with_meta, "ms": d_ms,
                          "plain_ms": d_plain, "nearest_ms": d_near,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bound_share": b_ms / d_ms}
    main = shapes["scanner"]
    report["scan_compact"].update(
        max_abs_err=errs["scan_compact"], ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], bound_share=main["bound_share"],
        library_ms=None, library="none: no PyTorch call hashes, tests and "
        "compacts k-mers", timed="scanner: C=2^%d k16 w16 kmers only"
        % (main["C"].bit_length() - 1), shapes=shapes)
    d = d_shapes["scanner"]
    report["densify"].update(
        max_abs_err=errs["densify"], ms=d["ms"], plain_ms=d["plain_ms"],
        bound_ms=d["bound_ms"], bound_by=d["bound_by"],
        bound_share=d["bound_share"], library_ms=None,
        library="none: no single PyTorch call computes densify",
        nearest_call="torch.masked_select of the live rows, mask built "
        "beforehand: omits the cap cut and the sentinel pad",
        nearest_ms=d["nearest_ms"], timed="scanner's rows at C=2^%d k16 "
        "w16, kmers only" % (d["C"].bit_length() - 1), shapes=d_shapes)
    say({"phase": "kernel_times", "scan_compact": shapes,
         "densify": d_shapes, "card": nvidia_smi_line()})


def check_front_kernels(small, rng, report):
    """The probe kernels against their plain versions on the card, bit for
    bit: every front_planes variant and front_mma at C = 2^15 and 2^24 for
    each w in FRONT_W, every front_ops op on C elements after each number
    of passes, 1 to 16 (one kernel instance each); then each timed beside
    its plain version at the probes' default shapes, the front_ops copy in
    turns with x.clone()."""
    import numpy as np
    import torch
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.ops.front_kernel import (VARIANTS, front_planes,
                                                      front_planes_ref,
                                                      make_streams)
    from modimizer_tpu_torch.ops.front_mma import front_mma, front_mma_ref
    from modimizer_tpu_torch.ops.front_ops import (OPS, R_LAST, front_ops,
                                                   front_ops_ref)
    from modimizer_tpu_torch.probes._timing import bound_ms, nbytes
    from modimizer_tpu_torch.probes._timing import time_ms as device_ms
    sizes = [1 << 15] if small else [1 << 15, 1 << 24]
    errs = dict.fromkeys(FRONT_KERNELS, 0.0)
    n_cases = 0

    def check(name, got, want, tag):
        nonlocal n_cases
        torch.cuda.synchronize()
        e = max_abs_err(zip(got, want))
        errs[name] = max(errs[name], e)
        n_cases += 1
        if e:
            fail("%s != its plain version at %s" % (name, tag))

    for C in sizes:
        NJ = C // 16
        st = make_streams(random_chunk(rng, C, 16)[0], NJ)
        for w in FRONT_W:
            f1 = Seqhash.create(16, w, SEED).factor1
            tag = "C=2^%d w=%d" % (C.bit_length() - 1, w)
            for v in VARIANTS:
                args = dict(factor1=f1, w=w, variant=v, mj=min(4096, NJ),
                            seed=w if v == "noin" else 0)
                check("front_planes", front_planes(*st, **args),
                      front_planes_ref(*st, **args), tag + " " + v)
            check("front_mma", front_mma(*st, factor1=f1, w=w),
                  front_mma_ref(*st, factor1=f1, w=w), tag)
        x = torch.from_numpy(rng.integers(0, 2 ** 32, C, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).cuda()
        x = x.view(max(1, C >> 17), 128, -1)
        for op in OPS:
            for r in range(R_LAST + 1):
                check("front_ops", (front_ops(x, op, r),),
                      (front_ops_ref(x, op, r),),
                      "%s %s r=%d" % (tuple(x.shape), op, r))
    say({"phase": "front_kernels", "cases": n_cases, "sizes": sizes,
         "w": list(FRONT_W), "variants": list(VARIANTS), "ops": list(OPS),
         "max_abs_err": errs})

    # times at the probes' default shapes: C = 2^24 (k16 w16, "full"), and
    # u32 [8, 128, 1024] for the micro-ops (each op, 16 passes as the
    # script's grid; the copy, which one PyTorch call computes, in turns
    # with x.clone(): clone, copy, copy, clone)
    C = sizes[-1]
    f1 = Seqhash.create(16, 16, SEED).factor1
    st = make_streams(random_chunk(rng, C, 16)[0], C // 16)
    full = dict(factor1=f1, w=16, variant="full", mj=min(4096, C // 16))
    x = torch.from_numpy(rng.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64)
                         .astype(np.uint32).view(np.int32)).cuda()
    x = x.view(8, 128, 1024)
    # device time with the launches queued ahead (the wrappers' host time
    # exceeds these kernels' at the probes' sizes)
    turns = {"clone": [], "copy": []}
    for who in ("clone", "copy", "copy", "clone"):
        fn = ((lambda: x.clone()) if who == "clone"
              else (lambda: front_ops(x, "copy")))
        turns[who].append(device_ms(fn, 20)[0])
    ops_ms = {op: device_ms(lambda: front_ops(x, op), 20)[0]
              for op in OPS if op != "copy"}
    t = {"front_planes": (
            device_ms(lambda: front_planes(*st, **full), 20)[0],
            device_ms(lambda: front_planes_ref(*st, **full), 3, 1)[0]),
         "front_mma": (
            device_ms(lambda: front_mma(*st, factor1=f1, w=16), 20)[0],
            device_ms(lambda: front_mma_ref(*st, factor1=f1, w=16), 3, 1)[0]),
         "front_ops": (min(turns["copy"]),
                       device_ms(lambda: front_ops_ref(x, "copy"), 3, 1)[0])}
    # the planes in, km (int32) and em (int8) out; front_mma's [24, 8] limb
    # product is 384 int8 operations a position
    io = nbytes(*st, *front_planes(*st, **full))
    bounds = {"front_planes": bound_ms(io),
              "front_mma": bound_ms(io, 384 * C),
              "front_ops": bound_ms(2 * nbytes(x))}
    library = {"front_planes": (None, "none: no PyTorch call hashes "
                                "k-mers"),
               "front_mma": (None, "none: no PyTorch call hashes k-mers "
                             "(PyTorch has no integer matmul on CUDA)"),
               "front_ops": (min(turns["clone"]),
                             "x.clone(), in turns with the copy")}
    timed = {"front_planes": "C=2^%d k16 w16 full" % (C.bit_length() - 1),
             "front_mma": "C=2^%d k16 w16" % (C.bit_length() - 1),
             "front_ops": "copy r=0..15 on u32 [8, 128, 1024]"}
    for name, (ms, plain_ms) in t.items():
        report[name].update(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                            bound_ms=bounds[name][0],
                            bound_by=bounds[name][1],
                            bound_share=bounds[name][0] / ms,
                            library_ms=library[name][0],
                            library=library[name][1], timed=timed[name])
    report["front_ops"].update(ops_ms=ops_ms, turns_ms=turns)
    say({"phase": "front_kernel_times", "timed": timed,
         "ms": {n: v[0] for n, v in t.items()}, "front_ops_ms": ops_ms,
         "copy_clone_turns_ms": turns,
         "plain_ms": {n: v[1] for n, v in t.items()},
         "card": nvidia_smi_line()})


def check_mosaic_kernels(small, rng, report):
    """The compaction-primitive kernels against their plain versions on the
    card, bit for bit: random u32 and both signs of i8, ranks from -16 to
    127 (those >= 112 land nowhere), at C = 2^16 and 2^24 positions; then
    each timed beside its plain version on the probe's inputs at 2^24."""
    import numpy as np
    import torch
    from modimizer_tpu_torch.ops import mosaic_prims as mp
    from modimizer_tpu_torch.probes import probe_mosaic_prims
    from modimizer_tpu_torch.probes._timing import bound_ms, nbytes
    from modimizer_tpu_torch.probes._timing import time_ms as device_ms
    sizes = [1 << 16] if small else [1 << 16, 1 << 24]
    errs = dict.fromkeys(MOSAIC_KERNELS, 0.0)
    n_cases = 0

    def put(a):
        return torch.from_numpy(a).cuda()

    for C in sizes:
        u32 = rng.integers(0, 2 ** 32, (2, 16, C // 16), dtype=np.uint64)
        x, idx = (put(a.astype(np.uint32).view(np.int32)) for a in u32)
        e = put(rng.integers(-128, 128, (C // 128, 128)).astype(np.int8))
        nb = C // 1024
        rank = put(rng.integers(-16, 128, (nb, 1024)).astype(np.int32))
        cols = put(rng.integers(-128, 128, (nb, 1024, 8)).astype(np.int8))
        for name, args in (("tala16", (x, idx)), ("roll12", (x,)),
                           ("cumsum128", (e,)), ("dot16", (rank, cols))):
            got = getattr(mp, name)(*args)
            want = getattr(mp, name + "_ref")(*args)
            torch.cuda.synchronize()
            err = max_abs_err([(got, want)])
            errs[name] = max(errs[name], err)
            n_cases += 1
            if err:
                fail("%s != its plain version at C=2^%d"
                     % (name, C.bit_length() - 1))
    say({"phase": "mosaic_kernels", "cases": n_cases, "sizes": sizes,
         "max_abs_err": errs})

    C = sizes[-1]
    probe = {k: v for v, k in probe_mosaic_prims.KERNEL.items()}
    t = {}
    for name in MOSAIC_KERNELS:
        args = probe_mosaic_prims.inputs(probe[name], C, torch.device("cuda"))
        fn, plain = getattr(mp, name), getattr(mp, name + "_ref")
        lib_fn, lib_name = mosaic_library_call(name, args)
        t[name] = (device_ms(lambda: fn(*args), 20)[0],
                   device_ms(lambda: plain(*args), 3, 1)[0],
                   None if lib_fn is None else device_ms(lib_fn, 20)[0])
        b_ms, b_by = bound_ms(
            nbytes(*probe_mosaic_prims.reads(probe[name], args), fn(*args)),
            probe_mosaic_prims.int8_ops(probe[name], args))
        report[name].update(max_abs_err=errs[name], ms=t[name][0],
                            plain_ms=t[name][1], bound_ms=b_ms,
                            bound_by=b_by, bound_share=b_ms / t[name][0],
                            library_ms=t[name][2], library=lib_name,
                            timed="C=2^%d, the probe's inputs"
                            % (C.bit_length() - 1))
    say({"phase": "mosaic_kernel_times", "C": C,
         "ms": {n: v[0] for n, v in t.items()},
         "plain_ms": {n: v[1] for n, v in t.items()},
         "library_ms": {n: v[2] for n, v in t.items()},
         "card": nvidia_smi_line()})


def mosaic_library_call(name, args):
    """(one PyTorch call that computes the kernel's function on the same
    inputs, its description), or (None, why there is none).  Index
    preparation happens here, outside the timed call."""
    import torch
    from modimizer_tpu_torch.ops import mosaic_prims as mp
    if name == "tala16":
        x, idx = args
        rows = (idx[:mp.TALA_OUT] & 15).to(torch.int64)
        return (lambda: torch.gather(x, 0, rows),
                "torch.gather(x, 0, idx[:8] & 15), index cast beforehand")
    if name == "cumsum128":
        return (lambda: torch.cumsum(args[0], 1, dtype=torch.int32),
                "torch.cumsum(e, 1, dtype=int32)")
    if name == "dot16":
        rank, cols = args
        nb = rank.shape[0]
        keep = (rank >= 0) & (rank < mp.DOT_BO)
        blk = torch.arange(nb, dtype=torch.int64, device=rank.device)[:, None]
        dest = (blk * mp.DOT_BO + rank.to(torch.int64))[keep]
        vals = cols[keep].to(torch.int32)
        out = torch.zeros(nb * mp.DOT_BO, mp.DOT_NC, dtype=torch.int32,
                          device=rank.device)
        return (lambda: out.index_add_(0, dest, vals),
                "out.index_add_(0, slot, cols), slots and int32 cols "
                "prepared beforehand")
    return None, "none: twelve roll-and-add stages are twelve calls"


def write_reads(path, n_reads, read_len, seed):
    """bench.py's synthetic read set: uniform ACGT, numpy default_rng."""
    import numpy as np
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for s in range(0, n_reads, 10_000):
            n = min(10_000, n_reads - s)
            arr = bases[rng.integers(0, 4, size=(n, read_len))]
            rows = []
            for i in range(n):
                rows.append(b">r%d\n" % (s + i))
                rows.append(arr[i].tobytes())
                rows.append(b"\n")
            f.write(b"".join(rows))


_ADDED = re.compile(r"^added \d+ sequences total length (\d+) total hashes "
                    r"\d+, new max \d+$", re.M)


def run_port(argv, launches, path):
    """The port's modutils in this process on the card, on ``path``
    ("builder": the device count; "scanner": the streaming scanner, with the
    device-count threshold above any input): (stdout, wall s, scanner,
    builders: one per -a input).  Launch counts are zeroed just before and
    read just after; every kernel of the path must have run, and the path
    must be the one asked for."""
    import torch
    from modimizer_tpu_torch import _build
    from modimizer_tpu_torch.cli import modutils as port_cli
    out = io.StringIO()
    builders = []
    threshold = port_cli.DEVICE_COUNT_THRESHOLD
    if path == "scanner":
        port_cli.DEVICE_COUNT_THRESHOLD = 1 << 62
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            scanner = port_cli.run(argv, device=torch.device("cuda"),
                                   builders=builders)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        port_cli.DEVICE_COUNT_THRESHOLD = threshold
    counts = {n: _build.LAUNCHES[n] for n in PATH_KERNELS[path]}
    if not all(counts.values()):
        fail("%s: a kernel was never launched: %s" % (argv, counts))
    if scanner is None or not builders:
        fail("%s: no scan command ran" % argv)
    if path == "builder":
        if (any(b is None or b.device.type != "cuda" for b in builders)
                or _build.LAUNCHES["densify"]):
            fail("%s: the input was not counted on the card" % argv)
    elif (any(b is not None for b in builders) or not scanner.used_device
          or scanner.n_fallback):
        fail("%s: the scan left the device or the scanner (n_fallback=%s)"
             % (argv, scanner.n_fallback))
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    return out.getvalue(), wall, scanner, builders


def run_host(argv):
    """The port's modutils on its native host scan (MODIMIZER_SCAN=host, no
    device), in this process like run_port, so that neither wall time
    counts an import; the CPU tests hold this path byte for byte against
    the JAX CLI's host path: (stdout, wall)."""
    from modimizer_tpu_torch.cli import modutils as port_cli
    out = io.StringIO()
    t0 = time.perf_counter()
    with environ(MODIMIZER_SCAN="host"), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        scanner = port_cli.run(argv)
    wall = time.perf_counter() - t0
    if scanner is None or scanner.device is not None or scanner.used_device:
        fail("%s: the host path did not run on the host" % argv)
    return out.getvalue(), wall


def run_cases(work, fa, params, tag, launches, paths):
    """modutils -c <params> -a fa on the host path, then through the port
    (on the card) on each of ``paths``: timed without -w (parse + scan +
    table replay, the build rate), then again with -w; .mod bytes and
    'added' lines must agree with the host path's."""
    host_mod = os.path.join(work, tag + ".host.mod")
    argv = ["-c"] + [str(p) for p in params] + ["-a", fa]
    host_out, host_s = run_host(argv)
    host_w_out, host_w_s = run_host(argv + ["-w", host_mod])
    with open(host_mod, "rb") as f:
        host_bytes = f.read()
    for path in paths:
        port_mod = os.path.join(work, "%s.%s.mod" % (tag, path))
        port_out, port_s, scanner, builders = run_port(argv, launches, path)
        port_w_out, port_w_s, _, _ = run_port(argv + ["-w", port_mod],
                                              launches, path)
        lines = [[m.group(0) for m in _ADDED.finditer(o)]
                 for o in (port_out, port_w_out, host_out, host_w_out)]
        if not lines[0] or any(x != lines[0] for x in lines):
            fail("%s %s: 'added' lines differ: %r" % (tag, path, lines))
        with open(port_mod, "rb") as f:
            same = f.read() == host_bytes
        if not same:
            fail("%s %s: port .mod differs from the host path's"
                 % (tag, path))
        m = re.match(r"added (\d+) sequences total length (\d+)",
                     lines[0][0])
        kpos = int(m.group(2)) - (params[1] - 1) * int(m.group(1))
        b = builders[0]
        detail = ({"n_compact": b.n_compact, "n_replay": b.n_replay,
                   "S": b.S, "bo": b.bo, "chunk": b.chunk} if b is not None
                  else {"n_wide": scanner.n_wide,
                        "n_fallback": scanner.n_fallback})
        say({"phase": "main", "case": tag, "path": path,
             "params": list(params), "added": lines[0][0],
             "mod_identical": same, "kmer_positions": kpos,
             "port_build_s": port_s, "port_mpos_s": kpos / port_s / 1e6,
             "host_build_s": host_s, "host_mpos_s": kpos / host_s / 1e6,
             "port_with_write_s": port_w_s, "host_with_write_s": host_w_s,
             **detail, "launches": dict(launches),
             "card": nvidia_smi_line()})
        os.unlink(port_mod)


@contextlib.contextmanager
def main_sizes(small):
    """With --small, 2 Mbp is below 2^25: lower the device-count threshold
    so that the builder path runs too."""
    from modimizer_tpu_torch.cli import modutils as port_cli
    if not small:
        yield
        return
    threshold = port_cli.DEVICE_COUNT_THRESHOLD
    port_cli.DEVICE_COUNT_THRESHOLD = 1 << 20
    try:
        yield
    finally:
        port_cli.DEVICE_COUNT_THRESHOLD = threshold


def phase_main(small, work, launches):
    with main_sizes(small):
        run_main(small, work, launches)


def run_main(small, work, launches):
    n200 = 2_000 if small else 200_000
    n20 = 2_000 if small else 20_000
    fa = os.path.join(work, "reads200.fa")
    write_reads(fa, n200, 1000, 42)
    run_cases(work, fa, (26, 16, 16, 17), "k16w16", launches,
              ("builder", "scanner"))
    fa20 = os.path.join(work, "reads20.fa")
    write_reads(fa20, n20, 1000, 43)
    run_cases(work, fa20, (26, 19, 31, 17), "k19w31", launches,
              ("builder",) if small else ("scanner",))
    check_imports()


def check_imports():
    """Nothing of JAX and nothing of the JAX package was imported."""
    bad = [m for m in sys.modules
           if m == "jax" or m.startswith("jax.") or m == "modimizer_tpu"
           or m.startswith("modimizer_tpu.")]
    if bad:
        fail("imported %s" % bad[:5])


def phase_overflow():
    """A 220 bp poly-A run overflows its block: the wide device retry
    absorbs it without the host rescan, and rows match the host path.  A
    3,000 bp poly-A read overflows the builder's blocks (k16 w16 and k19
    w31): it replays the chunks at a wider bo, and its count is the
    sequential build's."""
    import numpy as np
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.ops.seqhash import (ModimizerScanner,
                                                 first_encounter_unique)
    sh = Seqhash.create(16, 16, SEED)
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 1 << 15).astype(np.uint8)
    codes[5000:5000 + 220] = 0
    offsets = np.array([0, len(codes)], np.int64)
    host = ModimizerScanner(sh, host=True)
    dev = ModimizerScanner(sh, chunk=1 << 14, device="cuda", host=False)
    same_k = np.array_equal(dev.scan_kmers(codes, offsets),
                            host.scan_kmers(codes, offsets))
    dev2 = ModimizerScanner(sh, chunk=1 << 14, device="cuda", host=False)
    got = dev2.scan_stream(codes, offsets)
    want = host.scan_stream(codes, offsets)
    same_s = all(np.array_equal(a, b) for a, b in zip(got, want))
    tiers = (dev.n_wide, dev.n_fallback, dev2.n_wide, dev2.n_fallback)
    say({"phase": "overflow", "kmers_identical": same_k,
         "stream_identical": same_s, "n_wide": [tiers[0], tiers[2]],
         "n_fallback": [tiers[1], tiers[3]]})
    if not (same_k and same_s):
        fail("overflow chunk rows differ from the host path")
    if not (tiers[0] > 0 and tiers[2] > 0 and tiers[1] == tiers[3] == 0):
        fail("poly-A run did not take the wide retry alone: %s" % (tiers,))

    from modimizer_tpu_torch.parallel.sharded import ShardedModsetBuilder
    lens = rng.integers(100, 1000, 200)
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    seqs[60] = np.zeros(3000, np.uint8)
    codes = np.concatenate(seqs)
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in seqs])])
    # k16 w16 (32-bit k-mers) and k19 w31 (64-bit k-mers)
    for k, w in ((16, 16), (19, 31)):
        sh = Seqhash.create(k, w, SEED)
        host = ModimizerScanner(sh, host=True)
        b = ShardedModsetBuilder(sh, "cuda", chunk_per_dev=1 << 14,
                                 state_size=1 << 12, max_buffer_rows=1 << 14)
        bo0 = b.bo
        b.feed_stream(codes, offsets)
        ks, ds = b.finalize()
        kmers = host.scan_stream(codes, offsets)[0]
        uniq, counts = first_encounter_unique(kmers)
        same_b = (np.array_equal(ks, uniq) and np.array_equal(ds, counts)
                  and b.total_emitted == len(kmers))
        say({"phase": "overflow", "case": "builder k%d w%d" % (k, w),
             "count_identical": same_b, "n_replay": b.n_replay,
             "bo": [bo0, b.bo], "S": b.S, "n_compact": b.n_compact})
        if not same_b:
            fail("builder k%d w%d: count differs from the sequential "
                 "build's" % (k, w))
        if not (b.n_replay > 0 and b.bo > bo0):
            fail("builder k%d w%d: poly-A read did not make it replay "
                 "wider" % (k, w))


def device_busy(prof):
    """(busy ms, top rows, the port's kernels) of a torch.profiler run: the
    union of the card's kernel, copy and set intervals, the device time by
    name, and [ms, launches] of each kernel of PATH_KERNELS.  Only the
    device-side events count: the host op rows that launched them carry the
    same time again."""
    from torch.autograd import DeviceType
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        fail("profile: torch.profiler recorded no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in ev)
    busy, (lo, hi) = 0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > hi:
            busy, lo, hi = busy + hi - lo, s0, e0
        else:
            hi = max(hi, e0)
    busy += hi - lo
    by_name = {}
    for e in ev:
        t, n = by_name.get(e.name, (0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    ours = {}
    for k in set(PATH_KERNELS["scanner"]):
        # densify is two kernels (densify_tiles_kernel, densify_rows_kernel)
        pat = re.compile(r"\b%s\w*_kernel\b" % k)
        rows = [v for name, v in by_name.items() if pat.search(name)]
        ours[k] = [sum(t for t, _ in rows) / 1e3, sum(n for _, n in rows)]
    return (busy / 1e3, [[name[:60], t / 1e3, n] for name, (t, n) in top],
            ours)


def phase_profile(small, work):
    """Where the 200 Mbp k16 w16 build's time goes on each device path,
    warm: the stage timers (the accumulators MODIMIZER_STAGES=1 turns on)
    over runs in turns builder, scanner, scanner, builder; then one run of
    each path under torch.profiler: the card's busy time and its idle share
    of the command's wall time, with the top device rows."""
    import torch
    from modimizer_tpu_torch.utils import profiling
    fa = os.path.join(work, "reads200.fa")
    if not os.path.exists(fa):
        write_reads(fa, 2_000 if small else 200_000, 1000, 42)
    argv = ["-c", "26", "16", "16", "17", "-a", fa]
    enabled = profiling._enabled
    profiling._enabled = True
    try:
        with main_sizes(small):
            for path in ("builder", "scanner"):
                run_port(argv, {}, path)                # warm-up
            for path in ("builder", "scanner", "scanner", "builder"):
                profiling._stages.clear()
                _, wall, _, _ = run_port(argv, {}, path)
                say({"phase": "profile", "path": path, "wall_s": wall,
                     "stages_s": {k: v[0] for k, v in
                                  sorted(profiling._stages.items())},
                     "card": nvidia_smi_line()})
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            for path in ("builder", "scanner"):
                with torch.profiler.profile(activities=acts) as prof:
                    _, wall, _, _ = run_port(argv, {}, path)
                busy_ms, top, ours = device_busy(prof)
                say({"phase": "profile", "path": path,
                     "profiled_wall_s": wall, "device_busy_ms": busy_ms,
                     "idle_share": 1 - busy_ms / 1e3 / wall,
                     "kernel_device_ms": ours, "top_device_ms": top,
                     "card": nvidia_smi_line()})
    finally:
        profiling._enabled = enabled
        profiling._stages.clear()


def phase_probes(small, launches):
    """Each probe entry point in this process on the card, at the scripts'
    C = 2^24 and the main path's chunk C = 2^25 (2^15 with --small); each
    checks its kernels against their plain versions and prints one JSON
    line per variant.  The probe kernels' launch counts are zeroed just
    before and read just after."""
    import torch
    from modimizer_tpu_torch import _build
    from modimizer_tpu_torch.probes import (probe_chain_time, probe_front,
                                            probe_front_mxu,
                                            probe_mosaic_prims,
                                            probe_pallas_front,
                                            probe_pallas_parts)
    dev = torch.device("cuda")
    runs = []
    for c in ([15] if small else [24, 25]):
        mj = str(min(4096, (1 << c) // 16))
        runs += [(probe_pallas_parts, [str(c), mj]),
                 (probe_pallas_front, [str(c), mj]),
                 (probe_front_mxu, [str(c), mj]),
                 (probe_chain_time, [str(c), "3", "20", "--mj", mj])]
    runs.append((probe_front, []))
    runs.append((probe_mosaic_prims, ["--log2c", "16" if small else "24"]))
    _build.reset_launches()
    t0 = time.perf_counter()
    for mod, argv in runs:
        name = mod.__name__.rsplit(".", 1)[1]
        if mod.main(argv, device=dev) != 0:
            fail("%s %s: a kernel disagrees with its plain version"
                 % (name, argv))
    torch.cuda.synchronize()
    counts = {n: _build.LAUNCHES[n] for n in PROBE_KERNELS}
    if not all(counts.values()):
        fail("probes: a kernel was never launched: %s" % counts)
    launches.update(counts)
    say({"phase": "probes", "runs": [[m.__name__.rsplit(".", 1)[1], a]
                                     for m, a in runs],
         "seconds": time.perf_counter() - t0, "launches": counts,
         "card": nvidia_smi_line()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s" % ",".join(PHASES))
    ap.add_argument("--small", action="store_true",
                    help="small sizes only (a quick build-and-check run)")
    a = ap.parse_args(argv)
    phases = a.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    import modimizer_tpu_torch  # noqa: F401  (fails outside a checkout)

    report = {
        "scan_compact": {
            "name": "scan_compact", "route": "cuda",
            "source": "modimizer_tpu_torch/csrc/scan_compact.cu",
            "replaces": "modimizer_tpu/ops/scan_kernel.py:199",
            "also_replaces": ["modimizer_tpu/ops/scan_kernel_mxu.py:236",
                              "modimizer_tpu/parallel/sharded.py:845",
                              "modimizer_tpu/parallel/sharded.py:695"]},
        "densify": {
            "name": "densify", "route": "cuda",
            "source": "modimizer_tpu_torch/csrc/densify.cu",
            "replaces": "modimizer_tpu/ops/device_scan.py:183"},
        "front_planes": {
            "name": "front_planes", "route": "cuda",
            "source": "modimizer_tpu_torch/csrc/front_planes.cu",
            "replaces": "scripts/probe_chain_time.py:142",
            "also_replaces": ["scripts/probe_pallas_parts.py:175",
                              "scripts/probe_pallas_parts.py:183",
                              "scripts/probe_pallas_parts.py:191",
                              "scripts/probe_pallas_parts.py:199",
                              "scripts/probe_pallas_parts.py:211",
                              "scripts/probe_pallas_front.py:134",
                              "scripts/probe_front_mxu.py:200"]},
        "front_mma": {
            "name": "front_mma", "route": "cuda",
            "source": "modimizer_tpu_torch/csrc/front_mma.cu",
            "replaces": "scripts/probe_front_mxu.py:212"},
        "front_ops": {
            "name": "front_ops", "route": "cuda",
            "source": "modimizer_tpu_torch/csrc/front_ops.cu",
            "replaces": "scripts/probe_front.py:36"},
    }
    for name, line in (("tala16", 68), ("dot16", 103), ("roll12", 136),
                       ("cumsum128", 165)):
        report[name] = {"name": name, "route": "cuda",
                        "source": "modimizer_tpu_torch/csrc/mosaic_prims.cu",
                        "replaces": "scripts/probe_mosaic_prims.py:%d" % line}
    launches = {}
    work = os.path.join(HERE, "chip_smoke_work")
    try:
        if "env" in phases:
            phase_env()
        if "build" in phases:
            phase_build()
        if "kernels" in phases:
            phase_kernels(a.small, report)
        if "main" in phases:
            os.makedirs(work, exist_ok=True)
            phase_main(a.small, work, launches)
        if "overflow" in phases:
            phase_overflow()
        if "profile" in phases:
            os.makedirs(work, exist_ok=True)
            phase_profile(a.small, work)
        if "probes" in phases:
            phase_probes(a.small, launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name, n in launches.items():
        report[name]["launches"] = n
    check_imports()
    say({"kernels": list(report.values())})
    print(nvidia_smi_line(), flush=True)
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
