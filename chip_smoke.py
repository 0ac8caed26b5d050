#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels from
this checkout, holds each against its plain PyTorch version, drives the
port's ``modutils -a`` at full size through both of its device paths (the
device count of the builder, and the streaming scanner) and checks each .mod
against the native host path byte for byte, profiles both paths (stage
timers, the card's busy time and idle share), runs ``modmap``, ``modasm``
and ``modrep`` on the card at BASELINE configs 3 and 5 and an rDNA read set
against the port's host path, runs the scan-front and
compaction-primitive probes on the card, then the mesh paths through a
world-size-1 NCCL group (``sharded``: the routing and merge kernels, the
sharded merge of two real-size modsets against the native merge, the mesh
lookup table, the routed builder and a snapshot), the all-window
minimizer scan of a 64 Mbp sequence (``minimizer``), colinear chaining on
the chaining benchmark's seeds and on config 3's (``chain``), and the
multi-process build, ``modutils`` and config 3's ``modmap`` under torchrun
(``multihost``).

    python3 chip_smoke.py                 # every phase, one CUDA card
    python3 chip_smoke.py --phases env,build,kernels --small
    python3 chip_smoke.py --phases env,build,kernels,probes
    python3 chip_smoke.py --phases env,build,apps
    python3 chip_smoke.py --phases env,build,sharded
    python3 chip_smoke.py --phases env,build,minimizer,chain,multihost

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
PHASES = ("env", "build", "kernels", "main", "overflow", "profile", "apps",
          "probes", "sharded", "minimizer", "chain", "multihost")
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
                "scanner": ("scan_compact", "densify"),
                "modmap": ("scan_compact", "densify", "find_sorted"),
                "modasm": ("scan_compact", "densify", "overlap_groups",
                           "overlap_join"),
                "modrep": ("scan_compact", "densify"),
                "merge": ("route_rows", "merge_reduce")}
# kernels a path launches only on some inputs, counted and reported but not
# required: overlaps.cu's overflow path, for a read with more distinct
# partners than the join's table holds
PATH_MAY = {"modasm": ("overlap_dense",)}
# the C entry points whose launches make up one line of the kernels report
ENTRIES = {"overlap_pairs": ("overlap_groups", "overlap_join",
                             "overlap_dense")}
PROBE_KERNELS = ("front_planes", "front_reduce", "front_mma", "front_ops",
                 "tala16", "dot16", "roll12", "cumsum128")
FRONT_KERNELS, MOSAIC_KERNELS = PROBE_KERNELS[:4], PROBE_KERNELS[4:]
FRONT_W = (2, 16, 64)
# front_mma's tails, in words: half of one block's 256, and a block and
# a half; front_reduce's blocks with idle threads (128 and 384 of a
# block's 1,024 threads busy)
MMA_TAIL_NJ = (128, 384)
REDUCE_TAIL_NJ = (128, 384)
# front_reduce with many words a thread (2^23 words, ~62 a thread on 132
# SMs)
REDUCE_WIDE_C = 1 << 27


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

def random_chunk(rng, C, k, poly_a=False, poly_t=False):
    """(sw, vbits) int64 CUDA tensors for one chunk of C positions: random
    bases (or all A, or all T) packed by the native packer, read-boundary
    validity from random read lengths (one read for all A or all T)."""
    import numpy as np
    import torch
    from modimizer_tpu_torch.native import lib as native_lib
    n = C + k - 1
    codes = (np.full(n, 3 if poly_t else 0, np.uint8) if poly_a or poly_t
             else rng.integers(0, 4, n).astype(np.uint8))
    sw = np.empty(C // 32 + 2, np.uint64)
    native_lib().pk_pack2(codes, n, sw, len(sw))
    if poly_a or poly_t:
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
    check_lookup_kernel(small, rng, report)
    check_overlap_kernel(small, rng, report)


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
    bit: every front_planes and front_reduce variant and front_mma at C =
    2^15 and 2^24 for each w in FRONT_W, front_mma also at NJ = 128 and 384
    words (blocks with idle warps), front_reduce and front_planes' emonly
    also at NJ = 128 and 384 (blocks with idle threads) and on a poly-A
    chunk (every position emits; emonly: no k-mer but 0, so em is all 0),
    emonly also on a poly-T chunk (em all 0) and on four independent random
    streams (pb is not pa shifted by a word), front_reduce also at C = 2^27
    (many words a thread), three calls in a row and calls alternated on two
    streams (its scratch left zero for the next), every front_ops op on C
    elements after each number of passes, 1 to 16 (one kernel instance
    each); then each timed beside its plain version at the probes' default
    shapes, every front_planes variant at 2^24 with its bound, the
    front_ops copy in turns with x.clone()."""
    import numpy as np
    import torch
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.ops.front_kernel import (REDUCE_VARIANTS,
                                                      VARIANTS, front_planes,
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
    reduce_cases, emit_cases = [], []

    def check(name, got, want, tag):
        nonlocal n_cases
        torch.cuda.synchronize()
        e = max_abs_err(zip(got, want))
        errs[name] = max(errs[name], e)
        n_cases += 1
        if e:
            fail("%s != its plain version at %s" % (name, tag))

    def kernel_of(v):
        return "front_reduce" if v in REDUCE_VARIANTS else "front_planes"

    def check_reduce(st, tag, ws=FRONT_W, mj=128):
        for w in ws:
            f1 = Seqhash.create(16, w, SEED).factor1
            for v in REDUCE_VARIANTS:
                args = dict(factor1=f1, w=w, variant=v, mj=mj)
                check("front_reduce", front_planes(*st, **args),
                      front_planes_ref(*st, **args),
                      "%s w=%d %s" % (tag, w, v))
        reduce_cases.append(tag)

    def check_emit(st, tag):
        """emonly on st; returns its em's sum (poly chunks: 0)."""
        n = 0
        for w in FRONT_W:
            args = dict(factor1=Seqhash.create(16, w, SEED).factor1, w=w,
                        variant="emonly", mj=128)
            got = front_planes(*st, **args)
            check("front_planes", got, front_planes_ref(*st, **args),
                  "%s w=%d emonly" % (tag, w))
            n += int(got[0].sum())
        emit_cases.append(tag)
        return n

    for C in sizes:
        NJ = C // 16
        st = make_streams(random_chunk(rng, C, 16)[0], NJ)
        for w in FRONT_W:
            f1 = Seqhash.create(16, w, SEED).factor1
            tag = "C=2^%d w=%d" % (C.bit_length() - 1, w)
            for v in VARIANTS:
                args = dict(factor1=f1, w=w, variant=v, mj=min(4096, NJ),
                            seed=w if v == "noin" else 0)
                check(kernel_of(v), front_planes(*st, **args),
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
    for NJ in MMA_TAIL_NJ:
        st = make_streams(random_chunk(rng, 16 * NJ, 16)[0], NJ)
        for w in FRONT_W:
            f1 = Seqhash.create(16, w, SEED).factor1
            check("front_mma", front_mma(*st, factor1=f1, w=w),
                  front_mma_ref(*st, factor1=f1, w=w),
                  "NJ=%d w=%d" % (NJ, w))
    for NJ in REDUCE_TAIL_NJ:
        st = make_streams(random_chunk(rng, 16 * NJ, 16)[0], NJ)
        check_reduce(st, "NJ=%d" % NJ)
        check_emit(st, "NJ=%d" % NJ)
    C = REDUCE_WIDE_C
    check_reduce(make_streams(random_chunk(rng, C, 16)[0], C // 16),
                 "C=2^%d" % (C.bit_length() - 1), ws=(16,), mj=4096)
    C = sizes[-1]
    c_tag = "C=2^%d" % (C.bit_length() - 1)
    for poly in ("poly_a", "poly_t"):
        st = make_streams(random_chunk(rng, C, 16, **{poly: True})[0],
                          C // 16)
        if poly == "poly_a":
            check_reduce(st, "poly-A " + c_tag, mj=min(4096, C // 16))
        # every position emits and its k-mer is 0: em must be all 0
        n_emit = front_planes(*st, factor1=Seqhash.create(16, 16, SEED)
                              .factor1, w=16, variant="count", mj=128)[0]
        if int(n_emit) != C or check_emit(st, poly + " " + c_tag):
            fail("%s: %d emits of %d, or an em byte set" % (poly,
                                                            int(n_emit), C))
    # four independent streams: a kernel that took pb[j] for pa[j + 1]
    # would agree with the plain version on make_streams' streams
    st = tuple(torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, C // 16,
                                             dtype=np.int64)
                                .astype(np.int32)).cuda() for _ in range(4))
    check_emit(st, "independent " + c_tag)
    # the scratch each launch leaves zero for the next: three calls in a
    # row, then calls alternated on two streams (each its own scratch)
    st = make_streams(random_chunk(rng, C, 16)[0], C // 16)
    f1 = Seqhash.create(16, 16, SEED).factor1
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for v in REDUCE_VARIANTS:
        args = dict(factor1=f1, w=16, variant=v, mj=min(4096, C // 16))
        want = front_planes_ref(*st, **args)
        outs = [front_planes(*st, **args) for _ in range(3)]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        for i in range(4):
            with torch.cuda.stream(streams[i % 2]):
                outs.append(front_planes(*st, **args))
        for i, got in enumerate(outs):
            check("front_reduce", got, want,
                  "%s call %d %s" % (v, i, "in a row" if i < 3
                                     else "stream %d" % ((i - 3) % 2)))
    reduce_cases += ["3 calls in a row", "4 calls on 2 streams"]
    say({"phase": "front_kernels", "cases": n_cases, "sizes": sizes,
         "w": list(FRONT_W), "variants": list(VARIANTS), "ops": list(OPS),
         "front_mma_tail_nj": list(MMA_TAIL_NJ),
         "front_reduce_cases": reduce_cases,
         "front_planes_emonly_cases": emit_cases, "max_abs_err": errs})

    # times at the probes' default shapes: C = 2^24 (k16 w16, "full"), and
    # u32 [8, 128, 1024] for the micro-ops (each op, 16 passes as the
    # script's grid; the copy, which one PyTorch call computes, in turns
    # with x.clone(): clone, copy, copy, clone)
    C = sizes[-1]
    f1 = Seqhash.create(16, 16, SEED).factor1
    st = make_streams(random_chunk(rng, C, 16)[0], C // 16)
    full = dict(factor1=f1, w=16, variant="full", mj=min(4096, C // 16))
    red = {v: dict(full, variant=v) for v in REDUCE_VARIANTS}
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
    red_t = {v: (device_ms(lambda: front_planes(*st, **a), 20)[0],
                 device_ms(lambda: front_planes_ref(*st, **a), 3, 1)[0])
             for v, a in red.items()}
    # every planes variant: its time and its bound (noin reads nothing)
    pl_ms, pl_bound = {}, {}
    for v in VARIANTS:
        if v in REDUCE_VARIANTS:
            continue
        a = dict(full, variant=v)
        pl_ms[v] = device_ms(lambda: front_planes(*st, **a), 20)[0]
        pl_bound[v] = bound_ms(nbytes(*(() if v == "noin" else st),
                                      *front_planes(*st, **a)))[0]
    t = {"front_planes": (
            pl_ms["full"],
            device_ms(lambda: front_planes_ref(*st, **full), 3, 1)[0]),
         "front_mma": (
            device_ms(lambda: front_mma(*st, factor1=f1, w=16), 20)[0],
            device_ms(lambda: front_mma_ref(*st, factor1=f1, w=16), 3, 1)[0]),
         "front_reduce": red_t["noout"],
         "front_ops": (min(turns["copy"]),
                       device_ms(lambda: front_ops_ref(x, "copy"), 3, 1)[0])}
    # the planes in, km (int32) and em (int8) out; front_mma's [24, 8] limb
    # product is 384 int8 operations a position; front_reduce reads the
    # streams and writes noout's [8, 128] int64
    io = nbytes(*st, *front_planes(*st, **full))
    bounds = {"front_planes": bound_ms(io),
              "front_reduce": bound_ms(nbytes(*st) + 8 * 128 * 8),
              "front_mma": bound_ms(io, 384 * C),
              "front_ops": bound_ms(2 * nbytes(x))}
    library = {"front_planes": (None, "none: no PyTorch call hashes "
                                "k-mers"),
               "front_reduce": (None, "none: no PyTorch call hashes "
                                "k-mers"),
               "front_mma": (None, "none: no PyTorch call hashes k-mers "
                             "(PyTorch has no integer matmul on CUDA)"),
               "front_ops": (min(turns["clone"]),
                             "x.clone(), in turns with the copy")}
    timed = {"front_planes": "C=2^%d k16 w16 full" % (C.bit_length() - 1),
             "front_reduce": "C=2^%d k16 w16 noout" % (C.bit_length() - 1),
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
    report["front_reduce"].update(
        ms_by_variant={v: m[0] for v, m in red_t.items()},
        plain_ms_by_variant={v: m[1] for v, m in red_t.items()})
    report["front_planes"].update(
        ms_by_variant=pl_ms, bound_ms_by_variant=pl_bound,
        bound_share_by_variant={v: pl_bound[v] / m for v, m in pl_ms.items()},
        card=nvidia_smi_line())
    say({"phase": "front_kernel_times", "timed": timed,
         "ms": {n: v[0] for n, v in t.items()}, "front_ops_ms": ops_ms,
         "front_reduce_ms": {v: m[0] for v, m in red_t.items()},
         "front_planes_ms": pl_ms,
         "copy_clone_turns_ms": turns,
         "plain_ms": {n: v[1] for n, v in t.items()},
         "card": nvidia_smi_line()})


def check_mosaic_kernels(small, rng, report):
    """The compaction-primitive kernels against their plain versions on the
    card, bit for bit: random u32 and both signs of i8, ranks from -16 to
    127 (those >= 112 land nowhere), at C = 2^16 and 2^24 positions; dot16
    also at nb = 1, 3, 133 blocks and on ranks as a compaction gives them
    (``probe_mosaic_prims.run_ranks``) at each C, roll12 also at block-row
    counts that are no multiple of its warps a block (R = 1 with NJ = 4096,
    R = 3 with NJ = 8192); then each timed beside its plain version on the
    probe's inputs at 2^24."""
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

    def random_dot16(nb):
        return (put(rng.integers(-16, 128, (nb, 1024)).astype(np.int32)),
                put(rng.integers(-128, 128, (nb, 1024, 8)).astype(np.int8)))

    def random_u32(shape):
        return put(rng.integers(0, 2 ** 32, shape, dtype=np.uint64)
                   .astype(np.uint32).view(np.int32))

    cases, added = [], []
    for C in sizes:
        x, idx = random_u32((16, C // 16)), random_u32((16, C // 16))
        e = put(rng.integers(-128, 128, (C // 128, 128)).astype(np.int8))
        tag = "C=2^%d" % (C.bit_length() - 1)
        cases += [("tala16", (x, idx), tag), ("roll12", (x,), tag),
                  ("cumsum128", (e,), tag),
                  ("dot16", random_dot16(C // 1024), tag)]
        added.append(("dot16", probe_mosaic_prims.run_ranks(
            C // 1024, torch.device("cuda"), seed=C), tag + " run ranks"))
    added += [("dot16", random_dot16(nb), "nb=%d" % nb) for nb in (1, 3, 133)]
    added += [("roll12", (random_u32((r, nj)),), "R=%d NJ=%d" % (r, nj))
              for r, nj in ((1, 4096), (3, 8192))]
    for name, args, tag in cases + added:
        got = getattr(mp, name)(*args)
        want = getattr(mp, name + "_ref")(*args)
        torch.cuda.synchronize()
        err = max_abs_err([(got, want)])
        errs[name] = max(errs[name], err)
        n_cases += 1
        if err:
            fail("%s != its plain version at %s" % (name, tag))
    say({"phase": "mosaic_kernels", "cases": n_cases, "sizes": sizes,
         "added_cases": [[n, tag] for n, _a, tag in added],
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


# BASELINE config 3 (modmap): one reference of GRCh38 chr20's length, 3,000
# query reads of 10 kbp sampled from it; config 5 (modasm): E. coli K-12
# MG1655's length at 30x in 15 kbp reads; modrep: the human rDNA unit's
# length (GenBank KY962518), 200 reads of two units.  All uniform ACGT from
# numpy seeds.
CONFIG3 = {"ref_len": 64_444_167, "n_reads": 3_000, "read_len": 10_000,
           "sub": 0.01, "rc_every": 3, "k": 24, "w": 31}
CONFIG5 = {"genome_len": 4_641_652, "n_reads": 9_283, "read_len": 15_000,
           "sub": 0.001, "rc_every": 2, "k": 19, "w": 31}
RDNA = {"unit_len": 44_838, "n_reads": 200, "units": 2, "sub": 0.01,
        "rc_every": 3, "junk_len": 3_000}
# --small: config 5's 100 reads (1.5 Mbp) are above the 2^20 bases at which
# main_sizes sends modutils -a to the builder
SMALL = {"ref_len": 400_000, "genome_len": 200_000, "n_reads": 100,
         "unit_len": 4_000}


def lookup_edge(rng, case, dev):
    """(keys, vals, queries) on ``dev`` for one edge of the search: one key,
    the top level full (TOP keys) and one past it, two levels above the
    keys, duplicate keys (the lower bound's id), keys with the sign bit;
    the queries hit every node's first key, its neighbours and random
    values, with -1, 0 and the int64 extremes; "unaligned" is a key column
    that does not start on 16 bytes (the kernel's 8-byte loads)."""
    import numpy as np
    import torch
    from modimizer_tpu_torch.parallel.lookup import FAN, TOP
    n = {"n1": 1, "top": TOP, "top+1": TOP + 1, "two_levels": FAN * TOP + 1,
         "dups": 50_000, "sign_bit": 20_000, "unaligned": 50_001}[case]
    keys = np.sort(rng.integers(-(1 << 62), 1 << 62, n) if case == "sign_bit"
                   else rng.integers(0, 1 << 48, n))
    if case == "dups":
        keys = np.sort(np.repeat(keys[::5], 5)[:n])
    vals = rng.integers(1, 1 << 31, n).astype(np.int32)
    q = np.concatenate([keys[rng.integers(0, n, 3000)], keys[::FAN],
                        keys[::FAN] - 1, keys[::FAN] + 1, keys[-3:] + 1,
                        rng.integers(-(1 << 63), 1 << 62, 2000),
                        np.array([-1, 0, (1 << 63) - 1, -(1 << 63)])])
    keys, vals, q = (torch.from_numpy(a.astype(t)).to(dev) for a, t in
                     ((keys, np.int64), (vals, np.int32), (q, np.int64)))
    if case == "unaligned":     # a view 8 bytes into its storage
        keys, vals = keys[1:], vals[1:]
    return keys, vals, q


def check_lookup_kernel(small, rng, report):
    """find_sorted against its plain version on the card, bit for bit: a
    small table, the config-3 shape (the reference's emits ~ 64.4 M / 31
    keys, the queries' ~ 30 M / 31), an empty query (no launch), an empty
    table, the all-ones query, and the search's edges (lookup_edge); then
    timed at the config-3 shape in turns with the library route, beside its
    plain version, the index build and the same queries sorted."""
    import torch
    from modimizer_tpu_torch import _build
    from modimizer_tpu_torch.parallel.lookup import (find_sorted,
                                                     find_sorted_ref,
                                                     search_index)
    from modimizer_tpu_torch.probes._timing import bound_ms
    from modimizer_tpu_torch.probes._timing import time_ms as device_ms
    from modimizer_tpu_torch.probes.probe_lookup import (SHAPES, library_route,
                                                         lookup_bytes,
                                                         lookup_inputs)
    dev = torch.device("cuda")
    full = SHAPES["config3"]
    shapes = [(5_000, 3_000)] + ([] if small else [full])
    cases = [("random", s) for s in shapes + [(5_000, 0), (0, 3_000)]]
    cases += [(e, None) for e in ("n1", "top", "top+1", "two_levels", "dups",
                                  "sign_bit", "unaligned")]
    err, lines = 0.0, []
    for case, shape in cases:
        keys, vals, q = (lookup_inputs(rng, *shape, dev) if shape
                         else lookup_edge(rng, case, dev))
        index = search_index(keys)
        before = _build.LAUNCHES["find_sorted"]
        got = find_sorted(keys, vals, q, index)
        want = find_sorted_ref(keys, vals, q)
        torch.cuda.synchronize()
        e = max_abs_err([(got, want)])
        err = max(err, e)
        launched = _build.LAUNCHES["find_sorted"] - before
        lines.append({"case": case, "n": keys.numel(), "nq": q.numel(),
                      "index": index.numel(), "launched": launched,
                      "hits": int((got != 0).sum())})
        if e or launched != (1 if q.numel() else 0) or (
                case != "sign_bit" and int(got[q == -1].sum())):
            fail("find_sorted != find_sorted_ref at %s n=%d nq=%d"
                 % (case, keys.numel(), q.numel()))
    n, nq = shapes[-1]
    keys, vals, q = lookup_inputs(rng, n, nq, dev)
    index = search_index(keys)
    turns = {"library": [], "kernel": []}
    for who in ("library", "kernel", "kernel", "library"):
        turns[who].append(device_ms(
            (lambda: library_route(keys, vals, q)) if who == "library"
            else (lambda: find_sorted(keys, vals, q, index)), 20)[0])
    ms = min(turns["kernel"])
    plain = device_ms(lambda: find_sorted_ref(keys, vals, q), 3, 1)[0]
    index_ms = device_ms(lambda: search_index(keys), 20)[0]
    # the same queries in ascending order: a warp's lanes share lines
    qs = torch.sort(q).values
    sorted_ms = device_ms(lambda: find_sorted(keys, vals, qs, index), 20)[0]
    hits = int((find_sorted(keys, vals, q, index) != 0).sum())
    b_ms, b_by = bound_ms(lookup_bytes(keys, q, hits))
    report["find_sorted"].update(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, bound_share=b_ms / ms,
        library_ms=min(turns["library"]),
        library="torch.searchsorted + clamp + gather + compare + "
        "torch.where, in turns with the kernel", sorted_queries_ms=sorted_ms,
        index_build_ms=index_ms,
        timed="n=%d keys, nq=%d queries (%d hits)" % (n, nq, hits))
    say({"phase": "lookup_kernel", "cases": lines, "max_abs_err": err,
         "n": n, "nq": nq, "index": index.numel(), "turns_ms": turns,
         "plain_ms": plain, "index_build_ms": index_ms,
         "sorted_queries_ms": sorted_ms, "bound_ms": b_ms,
         "card": nvidia_smi_line()})


def check_overlap_kernel(small, rng, report):
    """overlap_pairs against its plain version on the card, bit for bit, on
    a small read set, the config-5 shape (9,283 reads of 15 kbp / 31 = 483
    mods over the genome's 4,641,652 / 31 mods: ~4.5 M hit rows, ~30 rows a
    group), the edges, and with the table's capacity lowered so that reads
    take the overflow path; then timed at the config-5 shape: the whole
    call, its plain version, its steps (A: the sort and the groups launch;
    B: the count and emit passes; the overflow path at the lowered
    capacity) and its peak of allocated device memory."""
    import torch
    from modimizer_tpu_torch import _build
    from modimizer_tpu_torch.parallel.overlaps import (
        overlap_join, overlap_pairs, overlap_pairs_ref)
    from modimizer_tpu_torch.probes import probe_overlaps as po
    from modimizer_tpu_torch.probes._timing import bound_ms
    from modimizer_tpu_torch.probes._timing import time_ms as device_ms
    dev = torch.device("cuda")
    n_reads, per_read, n_mods = po.SHAPES["config5"]
    full = {"n_reads": n_reads, "mods_per_read": per_read,
            "n_mods": n_mods}
    cases = [("tiled", {}, None)] + ([] if small else [
        ("config5", full, None)]) + [
        (e, {}, None) for e in ("no_copy1", "singletons", "big_group",
                                "one_read")] + [
        ("tiled", {}, 4), ("big_group", {}, 1)] + ([] if small else [
            ("config5", full, po.SMALL_CAP)])
    err, lines = 0.0, []
    for case, kw, cap in cases:
        rows = po.overlap_rows_on(po.overlap_readset(rng, case, **kw), dev)
        before = dict(_build.LAUNCHES)
        if cap is None:
            got = overlap_pairs(*rows) + (None,)
        else:
            got = overlap_join(*rows, cap=cap)
        want = overlap_pairs_ref(*rows)
        torch.cuda.synchronize()
        e = max_abs_err(zip(got[:4], want[:4]))
        err = max(err, e)
        launched = {n: _build.LAUNCHES[n] - before[n]
                    for n in ENTRIES["overlap_pairs"]}
        line = {"case": case, "cap": cap, "hit_rows": rows[0].numel(),
                "pairs": got[4], "max_group": got[5], "flagged": got[6],
                "launched": launched}
        lines.append(line)
        if e or got[4:6] != want[4:]:
            fail("overlap_pairs != its plain version at %s cap %s"
                 % (case, cap))
        # a call: the groups launch, the join's count pass and its emit
        # pass when there are pairs; the overflow path's two when a read
        # was flagged (the default cap flags none of these cases)
        passes = 1 + (got[4] > 0) if rows[0].numel() else 0
        if launched != {"overlap_groups": min(1, passes),
                        "overlap_join": passes,
                        "overlap_dense": passes if got[6] else 0}:
            fail("overlap_pairs launched %s at %s cap %s"
                 % (launched, case, cap))
        if case == "big_group" and got[5] <= 64:
            fail("the big group has %d rows" % got[5])
        if cap is not None and not got[6]:
            fail("no read took the overflow path at %s cap %d" % (case, cap))
    name = "tiled" if small else "config5"
    rows = po.shape_rows(name, dev)
    want = overlap_pairs_ref(*rows)
    call_ms = device_ms(lambda: overlap_pairs(*rows), 10, 2)[0]
    plain = device_ms(lambda: overlap_pairs_ref(*rows), 3, 1)[0]
    steps = po.step_times(rows, po.ov.TABLE_CAP)
    over = po.overflow_times(rows, po.SMALL_CAP)
    peak = po.peak_bytes(lambda: overlap_pairs(*rows))
    plain_peak = po.peak_bytes(lambda: overlap_pairs_ref(*rows))
    b_ms, b_by = bound_ms(po.overlap_bytes(rows, want[4]))
    report["overlap_pairs"].update(
        max_abs_err=err, ms=call_ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, bound_share=b_ms / call_ms, library_ms=None,
        library="none: no one PyTorch call joins and reduces the pairs",
        steps=steps, overflow=over, peak_bytes=peak,
        plain_peak_bytes=plain_peak,
        timed="%s: %d hit rows, %d pairs" % (name, rows[0].numel(),
                                             want[4]))
    say({"phase": "overlap_kernel", "cases": lines, "max_abs_err": err,
         "timed": name, "hit_rows": rows[0].numel(), "pairs": want[4],
         "max_group": want[5], "call_ms": call_ms, "plain_ms": plain,
         "steps": steps, "overflow": over, "peak_bytes": peak,
         "plain_peak_bytes": plain_peak, "bound_ms": b_ms,
         "card": nvidia_smi_line()})


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


_ACGT = b"ACGT"


def write_fasta(path, records):
    """(name, 2-bit codes) records as FASTA, one line a sequence."""
    import numpy as np
    bases = np.frombuffer(_ACGT, np.uint8)
    with open(path, "wb") as f:
        for name, codes in records:
            f.write(b">%s\n" % name.encode())
            f.write(bases[codes].tobytes())
            f.write(b"\n")


def sampled_reads(rng, genome, n, length, sub, rc_every):
    """n reads of ``length`` at uniform starts in ``genome`` (codes), a
    fraction ``sub`` of their bases drawn anew, every ``rc_every``-th
    reverse-complemented."""
    import numpy as np
    for i, s in enumerate(rng.integers(0, len(genome) - length + 1, n)):
        r = genome[s:s + length].copy()
        m = rng.random(length) < sub
        r[m] = rng.integers(0, 4, int(m.sum()))
        if i % rc_every == rc_every - 1:
            r = 3 - r[::-1]
        yield "r%d" % i, np.ascontiguousarray(r, np.uint8)


# resource usage: whole lines, and the tail of modrep's "read ... good:" line
_TIMING = re.compile(r"user\t[^\n]*")


@contextlib.contextmanager
def recorded_scanners():
    """Every ModimizerScanner made inside the block, for its counters."""
    from modimizer_tpu_torch.ops.seqhash import ModimizerScanner
    made = []
    init = ModimizerScanner.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    ModimizerScanner.__init__ = record
    try:
        yield made
    finally:
        ModimizerScanner.__init__ = init


def run_app(tool, argv, work, tag, device=None, env=None):
    """``tool``'s main(argv) in this process, stdout and stderr to files
    (the native engines write to the file descriptors): (stdout and
    stderr with the timing lines dropped, wall s, the scanners made, the
    stage timers' seconds)."""
    import importlib
    import torch
    from modimizer_tpu_torch.utils import profiling
    main = importlib.import_module("modimizer_tpu_torch.cli." + tool).main
    out_p = os.path.join(work, tag + ".out")
    err_p = os.path.join(work, tag + ".err")
    kw = {} if device is None else {"device": device}
    enabled, profiling._enabled = profiling._enabled, True
    profiling._stages.clear()
    try:
        with environ(**(env or {})), recorded_scanners() as made, \
                open(out_p, "w") as out, open(err_p, "w") as err, \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            main([str(a) for a in argv], **kw)
            if device is not None:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stages = {k: v[0] for k, v in sorted(profiling._stages.items())}
    finally:
        profiling._enabled = enabled
        profiling._stages.clear()
    texts = []
    for p in (out_p, err_p):
        with open(p) as f:
            texts.append(_TIMING.sub("", f.read()))
        os.unlink(p)
    return texts[0], texts[1], wall, made, stages


def app_case(tool, argv, work, tag, launches, path_kernels=None, files=(),
             host_env=None, compare_stderr=False):
    """``tool`` on the card and on the port's host path.  On the card the
    kernels of ``path_kernels`` (default PATH_KERNELS[tool]) are counted
    from 0 and must each launch, and every scan must stay on the card; on
    the builder path the count replaces the scan, so no scanner scans and
    densify must not launch.  stdout (and stderr), and each file of
    ``files``, must be byte-identical; ``argv`` and ``files`` name the
    path's own files with a {path} field ("card" or "host")."""
    import torch
    from modimizer_tpu_torch import _build
    kernels = PATH_KERNELS[path_kernels or tool]
    counted = kernels + PATH_MAY.get(path_kernels or tool, ())
    paths = {}
    for path in ("host", "card"):
        args = [str(a).format(path=path) for a in argv]
        if path == "card":
            _build.reset_launches()
            out, err, wall, made, stages = run_app(
                tool, args, work, tag, device=torch.device("cuda"))
            counts = {n: _build.LAUNCHES[n] for n in counted}
            if not all(counts[n] for n in kernels):
                fail("%s: a kernel was never launched: %s" % (tag, counts))
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            scans = [s for s in made if s.used_device]
            if path_kernels == "builder":
                if scans or _build.LAUNCHES["densify"]:
                    fail("%s: the input was not counted on the card" % tag)
            elif not scans or any(s.device.type != "cuda" for s in scans):
                fail("%s: no scan ran on the card" % tag)
            if any(s.n_fallback for s in made):
                fail("%s: a chunk fell back to the host rescan (%s)"
                     % (tag, [s.n_fallback for s in made]))
            # the card's files are named .card.: compare as the host's
            for a, b in zip(args, (str(a).format(path="host")
                                   for a in argv)):
                if a != b:
                    out, err = out.replace(a, b), err.replace(a, b)
        else:
            out, err, wall, made, stages = run_app(
                tool, args, work, tag + ".host",
                env=dict({"MODIMIZER_SCAN": "host"}, **(host_env or {})))
            counts = {}
            if not made or any(s.device is not None or s.used_device
                               for s in made):
                fail("%s: the host path did not scan on the host" % tag)
        paths[path] = (out, err, wall, counts,
                       sum(s.n_wide for s in made), len(made), stages)
    (ho, he, hs, _, _, _, h_st), (co, ce, cs, counts, n_wide, n_scans,
                                  c_st) = paths["host"], paths["card"]
    same = co == ho and (ce == he or not compare_stderr)
    for stem in files:
        with open(stem.format(path="card"), "rb") as a, \
                open(stem.format(path="host"), "rb") as b:
            same = same and a.read() == b.read()
    if not same or not co:
        fail("%s: the card's output differs from the host path's" % tag)
    say({"phase": "apps", "case": tag, "argv": [str(a) for a in argv],
         "identical": same, "stdout_bytes": len(co), "files": len(files),
         "card_s": cs, "host_s": hs, "launches": counts, "scans": n_scans,
         "n_wide": n_wide, "n_fallback": 0, "card_stages_s": c_st,
         "host_stages_s": h_st, "card": nvidia_smi_line()})
    return co


def config3_argv(small, work, rng=None):
    """modmap's argv on config 3, its reference and reads written to
    ``work`` from ``rng``; with no ``rng``, only if they are not there
    yet, and from ``default_rng(SEED)`` (the same draws as in ``apps``)."""
    import numpy as np
    c3 = dict(CONFIG3, **({"ref_len": SMALL["ref_len"], "n_reads":
                          SMALL["n_reads"]} if small else {}))
    ref_fa, reads = (os.path.join(work, n) for n in ("ref.fa",
                                                     "map_reads.fa"))
    if rng is not None or not (os.path.exists(ref_fa)
                               and os.path.exists(reads)):
        rng = np.random.default_rng(SEED) if rng is None else rng
        t0 = time.perf_counter()
        ref = rng.integers(0, 4, c3["ref_len"]).astype(np.uint8)
        write_fasta(ref_fa, [("chr20", ref)])
        write_fasta(reads, sampled_reads(rng, ref, c3["n_reads"],
                                         c3["read_len"], c3["sub"],
                                         c3["rc_every"]))
        del ref
        say({"phase": "apps", "data": "config3", "seconds":
             time.perf_counter() - t0, **c3})
    return ["-K", c3["k"], "-W", c3["w"], "-f", ref_fa, "-q", reads]


def phase_apps(small, work, launches):
    """modmap, modasm and modrep through their main(argv, device=cuda), each
    against the port's host path (MODIMIZER_SCAN=host, and
    MODIMIZER_OVERLAPS=host for modasm) in this process: config 3
    (modmap -K 24 -W 31 -f ref -q reads), config 5 (the port's modutils
    builds the modset on the card's builder path, then modasm -S -b -c -S
    -o2 100 -u) and the rDNA read set (modrep -R -s1 -s2 -s3).  Every kernel
    of each path must launch, every scan stay on the card, and stdout and
    each written file be byte-identical."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    f = os.path.join
    app_case("modmap", config3_argv(small, work, rng), work, "modmap.config3",
             launches)

    # config 5: modset on the builder path, then modasm
    c5 = dict(CONFIG5, **({"genome_len": SMALL["genome_len"], "n_reads":
                          SMALL["n_reads"]} if small else {}))
    t0 = time.perf_counter()
    genome = rng.integers(0, 4, c5["genome_len"]).astype(np.uint8)
    reads = f(work, "asm_reads.fa")
    write_fasta(reads, sampled_reads(rng, genome, c5["n_reads"],
                                     c5["read_len"], c5["sub"],
                                     c5["rc_every"]))
    del genome
    say({"phase": "apps", "data": "config5", "seconds":
         time.perf_counter() - t0, **c5})
    xmod = f(work, "X.{path}.mod")
    with main_sizes(small):
        app_case("modutils", ["-c", 24, c5["k"], c5["w"], 17, "-a", reads,
                              "-s", 10, 45, 75, "-w", xmod], work,
                 "modutils.config5", launches, path_kernels="builder",
                 files=(xmod,))
    # small inputs hold fewer than 2^20 hits: the size rule would pick the
    # host walk, so the device phase 1 is asked for
    asm_env = {"MODIMIZER_OVERLAPS": "device"} if small else {}
    with environ(**asm_env):
        out = app_case("modasm", ["-m", f(work, "X.card.mod"), "-f", reads,
                                  "-S", "-b", "-c", "-S", "-o2", 100, "-u"],
                       work, "modasm.config5", launches,
                       host_env={"MODIMIZER_OVERLAPS": "host"})
    m = re.search(r"^RS (\d+) mod hits", out, re.M)
    say({"phase": "apps", "case": "modasm.config5", "mod_hits":
         int(m.group(1)) if m else None,
         "device_overlaps_by_rule": not small})

    # rDNA: modrep
    t0 = time.perf_counter()
    unit = rng.integers(0, 4, SMALL["unit_len"] if small
                        else RDNA["unit_len"]).astype(np.uint8)
    write_fasta(f(work, "unit.fa"), [("unit", unit)])
    rreads = list(sampled_reads(rng, np.tile(unit, RDNA["units"]),
                                RDNA["n_reads"], len(unit) * RDNA["units"],
                                RDNA["sub"], RDNA["rc_every"]))
    rreads.append(("junk", rng.integers(0, 4, RDNA["junk_len"]).astype(
        np.uint8)))
    write_fasta(f(work, "rep_reads.fa"), rreads)
    say({"phase": "apps", "data": "rdna", "seconds":
         time.perf_counter() - t0, "unit_len": len(unit), **RDNA})
    for stem in ("unit", "rep_reads"):
        app_case("modutils", ["-c", 20, 16, 16, 17, "-a", f(work, stem +
                                                             ".fa"),
                              "-w", f(work, stem + ".{path}.mod")], work,
                 "modutils.%s" % stem, launches, path_kernels="scanner",
                 files=(f(work, stem + ".{path}.mod"),))
    app_case("modrep", ["-R", f(work, "unit.fa"), f(work, "unit.{path}.mod")]
             + [a for mode in ("-s1", "-s2", "-s3") for a in
                (mode, f(work, "rep_reads.fa"),
                 f(work, "rep_reads.{path}.mod"))],
             work, "modrep.rdna", launches, compare_stderr=True)
    check_imports()


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


# ---------------------------------------------------------------- sharded

MERGE_READS = 200_000        # A: bench.py's reads, default_rng(42)
ROUTE_N = (1, 2, 3, 4, 8)
ROUTE_TIMED_N = (1, 2, 4, 8)
ROUTE_CHUNK = 1 << 22        # the builder's chunk_per_dev


def bench_codes(n_reads, read_len, seed):
    """bench.py's reads as 2-bit codes (the draws of ``write_reads``):
    (codes, offsets)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    parts = [rng.integers(0, 4, size=(min(10_000, n_reads - s), read_len))
             .astype(np.uint8).reshape(-1)
             for s in range(0, n_reads, 10_000)]
    return (np.concatenate(parts),
            np.arange(0, n_reads * read_len + 1, read_len, dtype=np.int64))


def count_modset(sh, codes, offsets, bits, rng):
    """The port's one-device count of a stream on the card, as a Modset
    with random copy numbers and flag bits in info (as tests/
    test_sharded.py's merge test sets them)."""
    import numpy as np
    from modimizer_tpu_torch.core.modset import Modset
    from modimizer_tpu_torch.parallel.sharded import ShardedModsetBuilder
    b = ShardedModsetBuilder(sh, "cuda")
    b.feed_stream(codes, offsets)
    ms = Modset(sh, bits)
    ms.add_batch(*b.finalize())
    ms.info[1:ms.max + 1] = rng.integers(0, 64, ms.max).astype(np.uint8)
    return ms


def merge_rows(ms_a, ms_b):
    """The sharded merge's rows at n = 1 (A's, then B's with info bit 8),
    on the card: (k-mers, depth, info, rank)."""
    import numpy as np
    import torch
    na, nb = ms_a.max, ms_b.max
    cols = (np.concatenate([ms_a.value[1:na + 1], ms_b.value[1:nb + 1]])
            .view(np.int64),
            np.concatenate([ms_a.depth[1:na + 1], ms_b.depth[1:nb + 1]])
            .astype(np.int32),
            np.concatenate([ms_a.info[1:na + 1].astype(np.int32),
                            ms_b.info[1:nb + 1].astype(np.int32) | 0x100]),
            np.arange(na + nb, dtype=np.int64))
    return tuple(torch.from_numpy(c).cuda() for c in cols)


def merge_edges(rows, na, rng):
    """merge_reduce's inputs on the edges, from A's first rows (unique
    k-mers): every row A-only, every row B-only, every k-mer in both,
    depths that saturate, flag bits in info; each sorted by k-mer with B's
    row first as often as A's."""
    import torch
    m = min(na, 1 << 20)
    k, d, i = rows[0][:m], rows[1][:m], rows[2][:m] & 0xFF
    g = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    r = torch.arange(m, dtype=torch.int64, device="cuda")
    cases = {"a_only": (k, d, i, r), "b_only": (k, d, i | 0x100, r + m),
             "both": (torch.cat([k, k]), torch.cat([d, d]),
                      torch.cat([i, (i + 1) | 0x100]), torch.cat([r, r + m])),
             "saturate": (torch.cat([k, k]), torch.full((2 * m,), 0xFFF0,
                                                         dtype=torch.int32,
                                                         device="cuda"),
                          torch.cat([i, i | 0x100]), torch.cat([r, r + m])),
             "flags": (torch.cat([k, k[::2]]), torch.cat([d, d[::2]]),
                       torch.cat([i | 0xFC, (i[::2] | 0xFC) | 0x100]),
                       torch.cat([r, r[::2] + m]))}
    out = {}
    for name, (ck, cd, ci, cr) in cases.items():
        shuf = torch.randperm(ck.numel(), generator=g, device="cuda")
        ck, cd, ci, cr = ck[shuf], cd[shuf], ci[shuf], cr[shuf]
        o = torch.sort(ck, stable=True).indices
        out[name] = (ck[o], cd[o].contiguous(), ci[o].contiguous(), cr[o])
    return out


def library_merge(k, d, i, r):
    """The reduction with library calls: torch.unique_consecutive of the
    sorted k-mers (and the rows' count), then scatter_reduce of depth
    (sum), rank (min) and info (max)."""
    import torch
    uniq, inv, cnt = torch.unique_consecutive(k, return_inverse=True,
                                              return_counts=True)
    nh = uniq.numel()
    dsum = torch.zeros(nh, dtype=torch.int64, device=k.device)
    dsum.scatter_reduce_(0, inv, d.to(torch.int64), "sum")
    rmin = torch.full((nh,), 1 << 62, dtype=torch.int64, device=k.device)
    rmin.scatter_reduce_(0, inv, r, "amin")
    imax = torch.zeros(nh, dtype=torch.int64, device=k.device)
    imax.scatter_reduce_(0, inv, i.to(torch.int64), "amax")
    return uniq, dsum.clamp_(max=0xFFFF), rmin, imax, cnt


def route_edges(rows, ck, base, sh, rng):
    """route_rows' edge cases, each (tag, k-mers, n, cap, mode, args): N =
    0, 1 and a tile less one, a tile and a tile more one (every seventh row
    a sentinel) in each mode at n = 1, 3 and 8; every row a sentinel; every
    row to one owner at n = 8 (merge mode on the merge's rows, lookup mode
    on one repeated query)."""
    import torch
    from modimizer_tpu_torch.ops.route import TILE_ROWS, owners
    hkw = dict(k=sh.k, w=sh.w, factor1=sh.factor1)
    out = []

    def case(tag, km, n, mode, pos=None):
        kw = {} if mode == "merge" else dict(hkw)
        own = owners(km, n, mode, **kw)
        if mode != "lookup":
            own = own[km != -1]
        cap = max(1, int(torch.bincount(own, minlength=n).max())
                  if own.numel() else 1)
        if mode == "builder":
            kw.update(pos=pos, base=base)
        out.append((tag, km, n, cap, mode, kw))

    for mode in ("builder", "merge", "lookup"):
        T = TILE_ROWS[mode]
        for N in (0, 1, T - 1, T, T + 1):
            km = rows[:N].clone()
            km[::7] = -1
            pos = torch.from_numpy(rng.integers(-1, 1 << 31, N).astype(
                "int32")).cuda()
            for n in (1, 3, 8):
                case("N=%d" % N, km, n, mode, pos)
        N = 3 * T + 5
        pos = torch.from_numpy(rng.integers(-1, 1 << 31, N).astype(
            "int32")).cuda()
        case("all sentinel", torch.full((N,), -1, dtype=torch.int64,
                                        device="cuda"), 4, mode, pos)
    case("one owner", (rows & ~7) | 5, 8, "merge")
    case("one owner", ck[:1].expand(ck.numel()).contiguous(), 8, "lookup")
    return out


def check_route_merge(rng, rows, na, chunk_rows, sh, cap_builder, report):
    """route_rows and merge_reduce against their plain versions on the card,
    bit for bit: every mode at each n in ROUTE_N, at the builder's route
    size (one chunk of scan_compact rows) and at the merge size (the
    merge's rows), each with cap = its largest owner's rows (full, no
    overflow) and at n = 4 with half of that (overflow); route_rows' edges
    (route_edges), two calls in a row and calls alternated on two streams
    (its scratch's sequence numbers); merge_reduce on the merge's rows and
    on its edges; then route_rows timed at the merge's shape (n in
    ROUTE_TIMED_N), in builder mode on the chunk and in lookup mode on
    config 3's queries, and merge_reduce at the merge's shape, each in
    turns with its library route."""
    import torch
    from modimizer_tpu_torch import _build
    from modimizer_tpu_torch.ops.merge import merge_reduce, merge_reduce_ref
    from modimizer_tpu_torch.ops.route import (MODES, TILE_ROWS, owners,
                                               route_rows, route_rows_ref)
    from modimizer_tpu_torch.probes._timing import bound_ms, nbytes
    from modimizer_tpu_torch.probes._timing import time_ms as device_ms
    from modimizer_tpu_torch.probes.probe_route import (library_route,
                                                        route_bytes,
                                                        shape_rows)
    L = _build.lib()
    for mode, rows_a_tile in TILE_ROWS.items():
        if L.mz_route_tile_rows(MODES[mode]) != rows_a_tile:
            fail("route_rows: ops/route.py's TILE_ROWS[%r] = %d, the "
                 "kernel's %d" % (mode, rows_a_tile,
                                  L.mz_route_tile_rows(MODES[mode])))
    kmers = rows[0]
    ck, cp, base = chunk_rows
    hkw = dict(k=sh.k, w=sh.w, factor1=sh.factor1)
    lines, err = [], 0.0

    def held(tag, got, want, n, cap, mode):
        nonlocal err
        e = max_abs_err(zip(got, want))
        err = max(err, e)
        lines.append([tag, mode, n, cap, bool(got.overflow)])
        if e:
            fail("route_rows != route_rows_ref at %s %s n=%d cap=%d"
                 % (tag, mode, n, cap))

    before = _build.LAUNCHES["route_rows"]
    for size, km, pos, b0 in (("builder", ck, cp, base),
                              ("merge", kmers, None, 0)):
        N = km.numel()
        if pos is None:
            pos = torch.from_numpy(rng.integers(-1, 1 << 31, N).astype(
                "int32")).cuda()
        for mode in ("builder", "merge", "lookup"):
            kw = {} if mode == "merge" else dict(hkw)
            for n, over in [(n, False) for n in ROUTE_N] + [(4, True)]:
                own = owners(km, n, mode, **kw)
                if mode != "lookup":
                    own = own[km != -1]
                top = int(torch.bincount(own, minlength=n).max())
                cap = max(1, top // 2 if over else top)
                args = dict(kw, pos=pos, base=b0) if mode == "builder" \
                    else kw
                got = route_rows(km, n, cap, mode, **args)
                want = route_rows_ref(km, n, cap, mode, **args)
                torch.cuda.synchronize()
                held(size, got, want, n, cap, mode)
                if bool(got.overflow) != over:
                    fail("route_rows: overflow %s at %s %s n=%d cap=%d"
                         % (bool(got.overflow), size, mode, n, cap))
    for tag, km, n, cap, mode, kw in route_edges(kmers, ck, base, sh, rng):
        got = route_rows(km, n, cap, mode, **kw)
        torch.cuda.synchronize()
        held(tag, got, route_rows_ref(km, n, cap, mode, **kw), n, cap, mode)
    # two calls in a row, then calls alternated on two streams with no wait
    # between: no call may take another's scratch flags as ready
    x, y = kmers[:1 << 22], ck
    in_a_row = [(x, 4), (y, 3)]
    alternated = [(y, 3), (x, 4), (x, 8), (y, 3)]
    caps = {(km.numel(), n): int(torch.bincount(
        owners(km[km != -1], n, "merge"), minlength=n).max())
        for km, n in in_a_row + alternated}
    got = [route_rows(km, n, caps[km.numel(), n], "merge")
           for km, n in in_a_row]
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for i, (km, n) in enumerate(alternated):
        with torch.cuda.stream(streams[i % 2]):
            got.append(route_rows(km, n, caps[km.numel(), n], "merge"))
    torch.cuda.synchronize()
    for i, ((km, n), g) in enumerate(zip(in_a_row + alternated, got)):
        cap = caps[km.numel(), n]
        held("in a row" if i < len(in_a_row) else "two streams", g,
             route_rows_ref(km, n, cap, "merge"), n, cap, "merge")
    if _build.LAUNCHES["route_rows"] - before != len(lines):
        fail("route_rows: %d launches for %d calls"
             % (_build.LAUNCHES["route_rows"] - before, len(lines)))
    o = torch.sort(kmers, stable=True).indices
    merged = tuple(c[o].contiguous() for c in rows)
    mcases = dict(merge_edges(rows, na, rng), rows=merged)
    for name, (k, d, i, r) in mcases.items():
        got = merge_reduce(k, d, i, r, kmers.numel())
        want = merge_reduce_ref(k, d, i, r, kmers.numel())
        torch.cuda.synchronize()
        e = max_abs_err(zip(got, want))
        err = max(err, e)
        lines.append(["merge_reduce", name, k.numel(), int(got[4])])
        if e:
            fail("merge_reduce != merge_reduce_ref on %s" % name)
    # times: route_rows at the merge's shape for each n (cap = the fullest
    # owner's rows), on the builder's chunk and on config 3's queries, each
    # in turns with the library route; merge_reduce at the merge's shape
    N = kmers.numel()
    q = shape_rows("lookup", False, "cuda")[0]
    shapes = [("merge n=%d" % n, kmers, n, int(torch.bincount(
        owners(kmers, n, "merge"), minlength=n).max()), "merge", {})
        for n in ROUTE_TIMED_N]
    shapes += [("builder chunk", ck, 1, cap_builder, "builder",
                dict(hkw, pos=cp, base=base)),
               ("lookup config3", q, 1, q.numel(), "lookup", hkw)]
    route_t = {}
    for tag, km, n, cap, mode, kw in shapes:
        t = {"kernel": [], "library": []}
        for who in ("kernel", "library", "library", "kernel"):
            fn = route_rows if who == "kernel" else library_route
            t[who].append(device_ms(lambda: fn(km, n, cap, mode, **kw),
                                    20)[0])
        b_ms, b_by = bound_ms(route_bytes(km.numel(), n, cap, mode))
        route_t[tag] = dict(rows=km.numel(), n=n, cap=cap,
                            ms=min(t["kernel"]),
                            library_ms=min(t["library"]), bound_ms=b_ms,
                            bound_by=b_by,
                            bound_share=b_ms / min(t["kernel"]), turns=t)
    t = {}
    for who, fn in (("merge", lambda: merge_reduce(*merged, N)),
                    ("merge_lib", lambda: library_merge(*merged)),
                    ("merge", lambda: merge_reduce(*merged, N)),
                    ("merge_lib", lambda: library_merge(*merged))):
        t.setdefault(who, []).append(device_ms(fn, 20)[0])
    t["route_plain"] = device_ms(
        lambda: route_rows_ref(kmers, 1, N, "merge"), 3, 1)[0]
    t["merge_plain"] = device_ms(lambda: merge_reduce_ref(*merged, N),
                                 3, 1)[0]
    card = nvidia_smi_line()
    m1 = route_t["merge n=1"]
    mout = merge_reduce(*merged, N)
    mb_ms, mb_by = bound_ms(nbytes(*merged, *mout))
    report["route_rows"].update(
        max_abs_err=err, ms=m1["ms"], plain_ms=t["route_plain"],
        bound_ms=m1["bound_ms"], bound_by=m1["bound_by"],
        bound_share=m1["bound_share"], library_ms=m1["library_ms"],
        library="owners + stable torch.sort of the owner keys + "
        "searchsorted + gather (probe_route.library_route), in turns with "
        "the kernel",
        by_shape={k: {f: v[f] for f in ("rows", "n", "cap", "ms",
                                        "bound_ms", "bound_share",
                                        "library_ms")}
                  for k, v in route_t.items()},
        timed="merge mode, n=1, %d rows; by_shape: merge mode at n in %s, "
        "builder mode on one chunk of 2^22 positions, lookup mode on "
        "config 3's queries" % (N, list(ROUTE_TIMED_N)), card=card)
    report["merge_reduce"].update(
        max_abs_err=err, ms=min(t["merge"]), plain_ms=t["merge_plain"],
        bound_ms=mb_ms, bound_by=mb_by, bound_share=mb_ms / min(t["merge"]),
        library_ms=min(t["merge_lib"]),
        library="torch.unique_consecutive + scatter_reduce (depth sum, "
        "rank min, info max), in turns with the kernel",
        timed="%d received rows, %d heads, out_len %d"
        % (merged[0].numel(), int(mout[4]), N), card=card)
    say({"phase": "sharded_kernels", "cases": lines, "max_abs_err": err,
         "route_ms": route_t, "turns_ms": t, "merge_bound_ms": mb_ms,
         "card": card})


def phase_sharded(small, work, launches, report):
    """The mesh paths through a world-size-1 NCCL group: the kernels held
    against their plain versions (check_route_merge), ``sharded_merge`` of
    two real-size modsets byte-identical to the native merge (the main
    path: launch counts zeroed just before and read just after), the mesh
    ``DeviceTable`` against the one-device table on config 3's shape, the
    routed builder against the one-device one, and a snapshot saved and
    restored through the group.  Under torchrun (WORLD_SIZE > 1, one
    process a card) the same mesh paths at that world size, without the
    kernel checks."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from modimizer_tpu_torch import _build
    from modimizer_tpu_torch.core.modset import Modset
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.ops.scan_kernel import scan_compact
    from modimizer_tpu_torch.parallel.lookup import DeviceTable
    from modimizer_tpu_torch.parallel.mesh import build_mesh
    from modimizer_tpu_torch.parallel.sharded import (ShardedModsetBuilder,
                                                      sharded_merge)
    from modimizer_tpu_torch.probes.probe_lookup import SHAPES
    from modimizer_tpu_torch.utils import profiling
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl",
                                timeout=datetime.timedelta(seconds=300))
    rng = np.random.default_rng(SEED)
    sh = Seqhash.create(16, 16, SEED)
    n_reads = 2_000 if small else MERGE_READS
    shared = n_reads // 4    # B: A's first quarter, then as many new reads
    t0 = time.perf_counter()
    codes, offsets = bench_codes(n_reads, 1000, 42)
    ms_a = count_modset(sh, codes, offsets, 26, rng)
    new, _ = bench_codes(shared, 1000, 43)
    codes_b = np.concatenate([codes[:shared * 1000], new])
    offs_b = np.arange(0, len(codes_b) + 1, 1000, dtype=np.int64)
    ms_b = count_modset(sh, codes_b, offs_b, 26, rng)
    setup_s = time.perf_counter() - t0
    if world == 1:
        sw, vb = random_chunk(rng, ROUTE_CHUNK, sh.k)
        b1 = ShardedModsetBuilder(sh, "cuda", state_size=16)
        ck, cp, _c, _n, _o = scan_compact(sw, vb, k=sh.k, w=sh.w,
                                          factor1=sh.factor1, C=ROUTE_CHUNK,
                                          bo=b1.bo, meta_isf=False)
        check_route_merge(rng, merge_rows(ms_a, ms_b), ms_a.max,
                          (ck, cp, 5 << 33), sh, b1.cap, report)
        init = os.path.join(work, "nccl_init")
        dist.init_process_group("nccl", init_method="file://" + init,
                                world_size=1, rank=0)
    try:
        mesh = build_mesh(group=dist.group.WORLD)
        if (mesh.n, mesh.device.type) != (world, "cuda"):
            fail("sharded: the mesh is %d ranks on %s"
                 % (mesh.n, mesh.device))
        mesh.barrier()          # NCCL makes its communicator here
        # the main path: the sharded merge, then again, warm, with the
        # stage timers on
        _build.reset_launches()
        t1 = time.perf_counter()
        mk, md, mi = sharded_merge(ms_a, ms_b, mesh)
        torch.cuda.synchronize()
        merge_s = [time.perf_counter() - t1]
        counts = {n: _build.LAUNCHES[n] for n in PATH_KERNELS["merge"]}
        if not all(counts.values()):
            fail("sharded_merge: a kernel was never launched: %s" % counts)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        enabled, profiling._enabled = profiling._enabled, True
        profiling._stages.clear()
        try:
            t1 = time.perf_counter()
            again = sharded_merge(ms_a, ms_b, mesh)
            merge_s.append(time.perf_counter() - t1)
            merge_stages = {k: v[0] for k, v in
                            sorted(profiling._stages.items())}
        finally:
            profiling._enabled = enabled
            profiling._stages.clear()
        if not all(np.array_equal(a, b) for a, b in zip(again,
                                                        (mk, md, mi))):
            fail("sharded_merge: two calls differ")
        na, nb = ms_a.max, ms_b.max
        t1 = time.perf_counter()
        if not ms_a.merge(ms_b):
            fail("native merge refused the modsets")
        native_s = time.perf_counter() - t1
        ms_c = Modset(sh, 26)
        ms_c.add_batch(mk, np.zeros(len(mk), np.uint32))
        ms_c.depth[1:ms_c.max + 1] = md
        ms_c.info[1:ms_c.max + 1] = mi
        same_merge = ms_c.to_bytes() == ms_a.to_bytes()
        if not same_merge:
            fail("sharded_merge differs from the native merge")
        # the mesh DeviceTable on config 3's shape
        n_keys, nq = (5_000, 3_000) if small else SHAPES["config3"]
        keys = ms_a.value[1:min(ms_a.max, n_keys) + 1]
        ids = np.arange(1, len(keys) + 1, dtype=np.uint32)
        q = np.concatenate([rng.choice(keys, nq // 2), rng.integers(
            0, 1 << 32, nq - nq // 2).astype(np.uint64),
            np.array([0xFFFFFFFFFFFFFFFF], np.uint64)])
        _build.reset_launches()
        got = DeviceTable(keys, ids, sh, mesh).find(q)
        table_launches = dict(route_rows=_build.LAUNCHES["route_rows"],
                              find_sorted=_build.LAUNCHES["find_sorted"])
        want = DeviceTable(keys, ids, sh, "cuda").find(q)
        same_table = np.array_equal(got, want) and bool(got.any())
        if not same_table or not all(table_launches.values()):
            fail("mesh DeviceTable differs from the one-device table (%s)"
                 % table_launches)
        # the routed builder at n = 1 against the one-device builder, and a
        # snapshot through the group
        cut_reads = min(n_reads, 20_000)
        sc, so = codes[:cut_reads * 1000], offsets[:cut_reads + 1]
        one = ShardedModsetBuilder(sh, "cuda", chunk_per_dev=1 << 20)
        one.feed_stream(sc, so)
        want_b = one.finalize()
        _build.reset_launches()
        rb = ShardedModsetBuilder(sh, mesh, chunk_per_dev=1 << 20)
        half = cut_reads // 2
        rb.feed_stream(sc[:half * 1000], so[:half + 1])
        snap = os.path.join(work, "mesh.snap")
        rb.save(snap, cursor=half * 1000)
        rb, cursor = ShardedModsetBuilder.restore(snap, sh, mesh)
        rb.feed_stream(sc[cursor:], so[half:] - cursor, base=cursor)
        got_b = rb.finalize()
        builder_launches = dict(scan_compact=_build.LAUNCHES["scan_compact"],
                                route_rows=_build.LAUNCHES["route_rows"])
        same_build = (all(np.array_equal(a, b)
                          for a, b in zip(got_b, want_b))
                      and rb.total_emitted == one.total_emitted and rb.routed)
        if not same_build or not all(builder_launches.values()):
            fail("the routed builder differs from the one-device builder "
                 "(%s)" % builder_launches)
    finally:
        dist.destroy_process_group()
    say({"phase": "sharded", "world_size": world, "rank": mesh.rank,
         "device": str(mesh.device), "backend": "nccl",
         "modset_a": na, "modset_b": nb, "merged": int(ms_a.max),
         "merge_identical": same_merge, "sharded_merge_s": merge_s,
         "sharded_merge_stages_s": merge_stages, "native_merge_s": native_s,
         "merge_launches": counts,
         "table_identical": same_table, "table_keys": len(keys),
         "table_queries": len(q), "table_launches": table_launches,
         "builder_identical": same_build, "snapshot_cursor": cursor,
         "builder_launches": builder_launches, "setup_s": setup_s,
         "card": nvidia_smi_line()})


# ---------------------------------------------------------------- minimizer

MIN_KW = ((19, 31), (16, 16))     # the reference's defaults, and k16 w16
MIN_CHUNK = 1 << 22
# w = 255 and 300, each timed beside the two unfold passes
MIN_EDGE_W = (255, 300)
MIN_EDGE_LEN = 8_000_000
# w = 1, 256, 257, 1,000, the tile path's widest and one more (added at
# run time from ops/minimizer.py's W_TILE), and 2^14 and 2^20 (segments
# across many of the wide path's blocks), on a cut
MIN_CUT_W = (1, 256, 257, 1000)
MIN_WIDE_W = (1 << 14, 1 << 20)
MIN_CUT_LEN = 2_000_000
MIN_BRUTE_LEN = 1_000_000
# chunks of 32 positions: (w, m_ext, n_win, base)
MIN_TINY = ((1, 32, 32, 0), (16, 32, 17, 0), (32, 32, 1, 0), (31, 20, 5, 3),
            (7, 9, 40, 30))


def minimizer_chunk_inputs(sh, codes, s, chunk):
    """The arguments minimizer_scan gives the kernel for its chunk at hash
    position s: (sw on the card, m_ext, n_win, base, Cext)."""
    import numpy as np
    import torch
    from modimizer_tpu_torch.native import lib as native_lib
    k, w = sh.k, sh.w
    npos = len(codes) - k + 1
    C = min(chunk, ((npos + 63) // 64) * 64)
    cext = ((C + 2 * (w - 1) + 31) // 32) * 32
    lo = min(w - 1, s)
    base = s - lo
    seg = np.ascontiguousarray(codes[base:base + cext + k - 1])
    sw = np.empty(cext // 32 + 1, np.uint64)
    native_lib().pk_pack2(seg, len(seg), sw, len(sw))
    return (torch.from_numpy(sw.view(np.int64)).to("cuda"),
            min(cext, npos - base), npos - w + 1, base, cext)


def plain_minimizer_scan(mz, sh, codes):
    """minimizer_scan on the card with each chunk's plain version in the
    kernel's place."""
    kernel = mz.minimizer_chunk
    mz.minimizer_chunk = mz.minimizer_chunk_ref
    try:
        return mz.minimizer_scan(sh, codes, chunk=MIN_CHUNK, device="cuda")
    finally:
        mz.minimizer_chunk = kernel


def window_brute_force(sh, codes):
    """Every position whose hash is the minimum of a full w-window that
    covers it (all of a window's ties), by numpy over every window."""
    import numpy as np
    _km, hashes, _f = sh.scan(codes)
    win = np.lib.stride_tricks.sliding_window_view(hashes, sh.w)
    s, j = np.nonzero(win == win.min(axis=1)[:, None])
    return np.unique(s + j)


def phase_minimizer(small, launches, report):
    """The all-window minimizer scan (ops/minimizer.py) on the card: one
    uniform ACGT sequence of config 3's reference length at k19 w31 and
    k16 w16 (the main path: launch counts zeroed before each scan and read
    after), each whole output against the plain route (minimizer_chunk_ref
    on the card, chunk by chunk); the kernel held bit for bit against
    minimizer_chunk_ref on a middle chunk (halos on both sides) and timed
    with its plain version, its bound and the two window passes of
    x.unfold(0, w, 1); w = 255 and 300 on an 8 Mbp cut; w = 1, 256, 257,
    1,000, the tile path's widest and one more, 2^14 and 2^20 on a 2 Mbp
    cut (the scan and its one chunk, timed but for unfold); chunks of 32
    positions; the all-window set against brute force on a 1 Mbp cut."""
    import numpy as np
    import torch
    from modimizer_tpu_torch import _build
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.ops import minimizer as mz
    from modimizer_tpu_torch.probes._timing import bound_ms, nbytes
    from modimizer_tpu_torch.probes._timing import time_ms as device_ms
    L = _build.lib()
    if (L.mz_minimizer_tile(), L.mz_minimizer_w_tile()) != (mz.TILE,
                                                           mz.W_TILE):
        fail("minimizer: ops/minimizer.py's TILE, W_TILE = %d, %d, the "
             "kernel's %d, %d" % (mz.TILE, mz.W_TILE, L.mz_minimizer_tile(),
                                  L.mz_minimizer_w_tile()))
    n = 2_000_000 if small else CONFIG3["ref_len"]
    t0 = time.perf_counter()
    codes = np.random.default_rng(SEED).integers(0, 4, n).astype(np.uint8)
    setup_s = time.perf_counter() - t0
    err, cases, main = 0.0, [], None
    kws = [(k, w, n) for k, w in MIN_KW] + [
        (16, w, min(n, MIN_EDGE_LEN)) for w in MIN_EDGE_W] + [
        (16, w, min(n, MIN_CUT_LEN))
        for w in MIN_CUT_W + (mz.W_TILE, mz.W_TILE + 1) + MIN_WIDE_W]
    for k, w, length in kws:
        sh = Seqhash.create(k, w, SEED)
        seq = codes[:length]
        _build.reset_launches()
        t0 = time.perf_counter()
        got = mz.minimizer_scan(sh, seq, chunk=MIN_CHUNK, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = _build.LAUNCHES["minimizer"]
        if not n_launch:
            fail("minimizer k%d w%d: the kernel was never launched" % (k, w))
        if length == n:
            launches["minimizer"] = launches.get("minimizer", 0) + n_launch
        t0 = time.perf_counter()
        want = plain_minimizer_scan(mz, sh, seq)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail("minimizer k%d w%d: minimizer_scan differs from the plain "
                 "route" % (k, w))
        # the kernel against its plain version on a middle chunk
        npos = length - k + 1
        s = MIN_CHUNK if npos > 2 * MIN_CHUNK else 0
        sw, m_ext, n_win, base, cext = minimizer_chunk_inputs(
            sh, seq, s, MIN_CHUNK)
        args = dict(k=k, w=w, factor1=sh.factor1, C=cext)
        kout = mz.minimizer_chunk(sw, m_ext, n_win, base, **args)
        rout = mz.minimizer_chunk_ref(sw, m_ext, n_win, base, **args)
        torch.cuda.synchronize()
        e = max_abs_err(zip(kout, rout))
        err = max(err, e)
        if e:
            fail("minimizer k%d w%d: minimizer_chunk != minimizer_chunk_ref"
                 % (k, w))
        ms = device_ms(lambda: mz.minimizer_chunk(sw, m_ext, n_win, base,
                                                  **args), 20)[0]
        plain_ms = device_ms(lambda: mz.minimizer_chunk_ref(
            sw, m_ext, n_win, base, **args), 3, 1)[0]
        near_ms = None
        if w <= max(MIN_EDGE_W):
            hh = torch.where(torch.arange(cext, device="cuda") < m_ext,
                             rout[0], mz.PAD)
            pad = torch.full((w - 1,), mz.PAD, dtype=torch.int64,
                             device="cuda")

            def unfold_passes():
                a = torch.cat([hh, pad]).unfold(0, w, 1).amin(1)
                return torch.cat([pad * 0, a]).unfold(0, w, 1).amax(1)
            near_ms = device_ms(unfold_passes, 10)[0]
        b_ms, b_by = bound_ms(nbytes(sw, *kout))
        line = {"k": k, "w": w, "bp": length, "emitted": len(got[1]),
                "scan_s": wall, "plain_scan_s": plain_wall,
                "launches": n_launch, "path": "tile" if w <= mz.W_TILE
                else "wide", "chunk_C": cext, "ms": ms, "plain_ms": plain_ms,
                "unfold_ms": near_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bound_share": b_ms / ms}
        cases.append(line)
        say(dict({"phase": "minimizer", "identical": True}, **line))
        if main is None:
            main = line
    # chunks of 32 positions
    rng = np.random.default_rng(SEED)
    for w, m_ext, n_win, base in MIN_TINY:
        sh = Seqhash.create(16, w, SEED)
        sw = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, 2,
                                           dtype=np.int64)).to("cuda")
        args = dict(k=16, w=w, factor1=sh.factor1, C=32)
        e = max_abs_err(zip(mz.minimizer_chunk(sw, m_ext, n_win, base, **args),
                            mz.minimizer_chunk_ref(sw, m_ext, n_win, base,
                                                   **args)))
        if e:
            fail("minimizer: a chunk of 32 positions at w %d differs" % w)
    # the all-window set against brute force on a 1 Mbp cut (k19 w31)
    sh = Seqhash.create(*MIN_KW[0], SEED)
    cut = codes[:MIN_BRUTE_LEN]
    got = mz.minimizer_scan(sh, cut, chunk=1 << 18, device="cuda")[1]
    want = window_brute_force(sh, cut)
    if not np.array_equal(got, want):
        fail("minimizer: the all-window set differs from brute force")
    report["minimizer"].update(
        max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        bound_share=main["bound_share"], library_ms=None,
        library="none: no PyTorch call computes the all-window minimizer "
        "set", nearest_call="x.unfold(0, w, 1).amin(1), then .amax(1) of "
        "the masked minima: the two window passes alone, no hashing or "
        "emit", nearest_ms=main["unfold_ms"],
        timed="a middle chunk of %d positions at k%d w%d"
        % (main["chunk_C"], main["k"], main["w"]),
        ms_by_w={"k%d w%d" % (c["k"], c["w"]): c["ms"] for c in cases},
        cases=cases)
    say({"phase": "minimizer", "bp": n, "setup_s": setup_s,
         "tiny_chunks": len(MIN_TINY), "brute_force_bp": len(cut),
         "brute_force_identical": True, "card": nvidia_smi_line()})


# ---------------------------------------------------------------- chain

CHAIN_READS = 100_000             # scripts/bench_chain.py's default size
CHAIN_SPR = 30
CHAIN_ORACLE_READS = 5_000        # bench_chain's reads the oracle replays


def chain_oracle(ref, sidx, spos, seed_off):
    """Literal transcription of modmap.c:216-280 (the loc0 == 0 "no block"
    quirk, the copy-2 retry, the final n2 > 2 gate), as
    tests/test_chain.py:20-76."""
    info = ref.ms.info
    out_all = []
    for rd in range(len(seed_off) - 1):
        out = []
        loc0 = locN = i0 = iN = 0
        p0 = pN = 0
        n1 = n2 = 0
        for t in range(seed_off[rd], seed_off[rd + 1]):
            idx = sidx[t]
            if idx == 0 or (info[idx] & 3) == 3:
                continue
            loc = int(ref.rev[ref.loc[idx]])
            is1 = (info[idx] & 3) == 1

            def end_block(loc):
                if ref.id[loc] != ref.id[loc0]:
                    return True
                if loc0 < locN:
                    if loc < locN:
                        return True
                    d = locN - loc0 - iN + i0
                    if d > 50 or d < -50:
                        return True
                elif loc0 > locN:
                    if loc > locN:
                        return True
                    d = loc0 - locN - iN + i0
                    if d > 50 or d < -50:
                        return True
                return False

            end = (loc0 == 0) or end_block(loc)
            if end and loc0 and not is1:
                loc = int(ref.rev[ref.loc[idx] + 1])
                end = end_block(loc)
            if end:
                if n1 > 2:
                    out.append((p0, pN, loc0, locN, n1, n2, 0))
                n1 = n2 = 0
                loc0 = loc
                i0 = t - seed_off[rd]
                p0 = int(spos[t])
            if is1:
                n1 += 1
            else:
                n2 += 1
            locN = loc
            iN = t - seed_off[rd]
            pN = int(spos[t])
        if n2 > 2:
            out.append((p0, pN, loc0, locN, n1, n2, 1))
        out_all.append(out)
    return out_all


def native_chain_s(ref, sidx, spos, seed_off, names, qids, qlen):
    """The native automaton and its Q/M text (mm_query_emit) on the seeds,
    both outputs to /dev/null: wall s."""
    import numpy as np
    from modimizer_tpu_torch.native import lib as native_lib

    def blob(strings):
        parts = [x.encode("latin1") + b"\0" for x in strings]
        off = np.zeros(len(parts) + 1, np.int64)
        off[1:] = np.cumsum([len(x) for x in parts])
        return b"".join(parts), off
    nm, nm_off = blob(names)
    qb, q_off = blob(qids)
    devnull = os.open(os.devnull, os.O_WRONLY)
    try:
        t0 = time.perf_counter()
        native_lib().mm_query_emit(
            np.ascontiguousarray(seed_off, np.int64),
            np.ascontiguousarray(sidx, np.uint32),
            np.ascontiguousarray(spos, np.int64),
            np.ascontiguousarray(ref.ms.info, np.uint8),
            np.ascontiguousarray(ref.rev, np.uint32),
            np.ascontiguousarray(ref.loc, np.uint32),
            np.ascontiguousarray(ref.offset, np.uint32),
            np.ascontiguousarray(ref.id, np.uint32), len(ref.rev), nm,
            nm_off, qb, q_off, np.ascontiguousarray(qlen, np.int64),
            len(seed_off) - 1, 0, devnull, devnull)
        return time.perf_counter() - t0
    finally:
        os.close(devnull)


def config3_seeds(small, work, rng):
    """Config 3's reference (indexed by the port on the card, -K 24 -W 31)
    and the seeds of its 3,000 reads of 10 kbp, as modmap -q makes them
    (the scanner and the device table's lookup): (ref, sidx, spos,
    seed_off, read ids, read lengths)."""
    import numpy as np
    import torch
    from modimizer_tpu_torch.cli import modmap
    from modimizer_tpu_torch.core.modset import Modset
    from modimizer_tpu_torch.core.reference import Reference
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.io import seqio
    from modimizer_tpu_torch.ops.seqhash import ModimizerScanner
    c3 = dict(CONFIG3, **({"ref_len": SMALL["ref_len"], "n_reads":
                          SMALL["n_reads"]} if small else {}))
    genome = rng.integers(0, 4, c3["ref_len"]).astype(np.uint8)
    ref_fa = os.path.join(work, "chain_ref.fa")
    reads_fa = os.path.join(work, "chain_reads.fa")
    write_fasta(ref_fa, [("chr20", genome)])
    write_fasta(reads_fa, sampled_reads(rng, genome, c3["n_reads"],
                                        c3["read_len"], c3["sub"],
                                        c3["rc_every"]))
    del genome
    dev = torch.device("cuda")
    ms = Modset(Seqhash.create(c3["k"], c3["w"], 17), 24 if small else 28,
                0)
    ref = Reference(ms, 1 << 26)
    ref.fasta_read(ref_fa, io.StringIO(), is_add=True, device=dev)
    batch, _t = seqio.read_seq_file(reads_fa, seqio.dna2index_n0(),
                                    is_qual=False, want_ids=True)
    scanner = ModimizerScanner(ms.hasher, want_isf=False, device=dev)
    kmers, rid, rpos, _f = scanner.scan_batch(batch)
    sidx = np.ascontiguousarray(modmap._lookup(ref, scanner, kmers),
                                np.uint32)
    seed_off = np.searchsorted(rid, np.arange(batch.n + 1)).astype(np.int64)
    names = [ref.dict.name(i) for i in range(ref.dict.max)]
    return (ref, sidx, np.ascontiguousarray(rpos, np.int64), seed_off,
            names, list(batch.ids), np.asarray(batch.lengths, np.int64))


def staging_read(n_seeds):
    """One read whose records outgrow a tile's staging in csrc/chain.cu:
    copy-1 seeds on consecutive occurrences whose sequence id changes every
    third, so that each block of three closes with a record.  Returns
    (ref-like, sidx, spos, seed_off)."""
    import types
    import numpy as np
    occ = np.arange(n_seeds + 1, dtype=np.uint32)
    info = np.full(n_seeds + 1, 1, np.uint8)
    info[0] = 0
    ref = types.SimpleNamespace(rev=occ, loc=occ, id=occ // 3,
                                ms=types.SimpleNamespace(info=info))
    return (ref, occ[1:].copy(), np.arange(n_seeds, dtype=np.int64) * 3,
            np.array([0, n_seeds], np.int64))


def phase_chain(small, work, launches, report):
    """Colinear chaining (parallel/chain.py) on the card: chain_records on
    scripts/bench_chain.py's case at its own size (100,000 reads of 20-40
    seeds; the main path: launch counts zeroed before and read after),
    held against the plain driver (chain_emit_ref on the card), its first
    5,000 reads against the literal oracle, and timed beside the native
    mm_query_emit on the same seeds (text to /dev/null);
    the kernel's slots form against chain_scan_ref on the same seeds as
    [R, S] planes, bit for bit, at a cap that fits and one that
    overflows; then config 3's real seeds (the port's modmap seeding, 3,000
    reads of 10 kbp at -K 24 -W 31): chain_records against the literal
    oracle of modmap.c:216-280 and timed beside mm_query_emit; the edges
    against chain_emit_ref, bit for bit: no reads, one read of 10,000
    seeds, a read whose records outgrow a tile's staging, 100,000 reads with
    no live seed, two calls in a row and calls alternated on two streams
    (the look-back's scratch a stream)."""
    import numpy as np
    import torch
    from modimizer_tpu_torch import _build
    from modimizer_tpu_torch.parallel import chain as ch
    from modimizer_tpu_torch.probes import probe_chain as pc
    from modimizer_tpu_torch.probes._timing import bound_ms
    from modimizer_tpu_torch.probes._timing import time_ms as device_ms
    dev = torch.device("cuda")
    L = _build.lib()
    if L.mz_chain_tile_reads() != ch.TILE_READS:
        fail("chain: parallel/chain.py's TILE_READS = %d, the kernel's %d"
             % (ch.TILE_READS, L.mz_chain_tile_reads()))
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    ref, sidx, spos, off = pc.bench_chain_case(
        10_000 if small else CHAIN_READS, CHAIN_SPR)
    setup_s = time.perf_counter() - t0
    R = len(off) - 1
    _build.reset_launches()
    t0 = time.perf_counter()
    got = ch.chain_records(ref, sidx, spos, off, device=dev)
    first_s = time.perf_counter() - t0
    n_launch = _build.LAUNCHES["chain_scan"]
    if not n_launch:
        fail("chain: the kernel was never launched")
    launches["chain_scan"] = launches.get("chain_scan", 0) + n_launch
    t0 = time.perf_counter()
    got2 = ch.chain_records(ref, sidx, spos, off, device=dev)
    warm_s = time.perf_counter() - t0
    qlen = np.full(R, CHAIN_SPR * 16 + 50, np.int64)
    native_s = [native_chain_s(ref, sidx, spos, off,
                               ["ref%d" % i for i in range(24)],
                               ["q%d" % i for i in range(R)], qlen)
                for _ in range(2)]
    # the plain driver on the card, and the kernel's two forms
    la, lb, ia, ib, is1, live, ps = ch.seed_planes(ref, sidx, spos)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                ).to(dev)
    planes = [put(x) for x in (la, lb, ia, ib)]
    flags = ch.seed_flags(torch.from_numpy(is1), torch.from_numpy(live)
                          ).to(dev)
    pos_t, idmap = put(ps), put(np.asarray(ref.id, np.uint32))
    off_t = torch.from_numpy(off).to(dev)
    t0 = time.perf_counter()
    want = ch.chain_emit_ref(*planes, flags, pos_t, idmap, off_t)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    have = ch.chain_emit(*planes, flags, pos_t, idmap, off_t)
    err = max_abs_err(zip(have, want))
    rows = [tuple(r) for r in want[0].cpu().numpy().view(
        np.uint32).tolist()]
    b = want[1].cpu().tolist()
    if err or got != got2 or got != [rows[x:y] for x, y in zip(b[:-1],
                                                              b[1:])]:
        fail("chain: chain_records differs from the plain driver")
    n_oracle = min(R, CHAIN_ORACLE_READS)
    if [[tuple(int(v) for v in r) for r in g] for g in got[:n_oracle]] != \
            chain_oracle(ref, sidx, spos, off[:n_oracle + 1]):
        fail("chain: bench_chain records differ from the oracle")
    S = int(np.diff(off).max())
    j = torch.arange(S, device=dev)
    src = torch.where(j < (off_t[1:] - off_t[:-1])[:, None],
                      off_t[:-1, None] + j, int(off[-1]))

    def dense(x):
        return torch.cat([x, x.new_zeros(1)])[src]
    dplanes = [dense(x) for x in planes]
    d_is1 = dense(torch.from_numpy(is1).to(dev))
    d_live = dense(torch.from_numpy(live).to(dev))
    d_pos = dense(pos_t)
    for cap in (8, 1):
        k_out = ch.chain_scan(*dplanes, d_is1, d_live, d_pos, idmap,
                              cap=cap)
        r_out = ch.chain_scan_ref(*dplanes, d_is1, d_live, d_pos, idmap,
                                  cap=cap)
        torch.cuda.synchronize()
        e = max_abs_err(zip(k_out, r_out))
        err = max(err, e)
        if e or bool(k_out[2]) != (cap == 1):
            fail("chain: chain_scan != chain_scan_ref at cap %d" % cap)
    # the kernel's one launch, timed without chain_emit's host sync
    args = (*planes, flags, pos_t, idmap, off_t)
    ms = device_ms(lambda: pc.current_emit(args), 20)[0]
    timed = pc.current_emit(args)
    if not (torch.equal(timed[0][:have[0].shape[0]], have[0])
            and torch.equal(timed[1], have[1])):
        fail("chain: the timed launch wrote other records")
    plain_ms = device_ms(lambda: ch.chain_emit_ref(*args), 3, 1)[0]
    n_rec = int(have[0].shape[0])
    # the bound from what the one launch must move on these seeds; beside
    # it, the formula the count-and-emit form was held to
    opens, retries = pc.block_loads(la, lb, ia, ib, is1, live, ref.id, off)
    b_ms, b_by = bound_ms(pc.chain_bytes(planes[0].numel(), R, n_rec, opens,
                                         retries))
    old_ms = bound_ms(pc.chain_bytes_two_pass(planes[0].numel(), R, n_rec,
                                              int(live.sum())))[0]
    bench = {"reads": R, "seeds": int(off[-1]), "records": n_rec,
             "live_seeds": int(live.sum()), "block_openings": opens,
             "retries": retries, "longest_read": S,
             "chain_records_first_s": first_s,
             "chain_records_s": warm_s, "plain_driver_s": plain_s,
             "native_mm_query_emit_s": native_s, "launches": n_launch,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by, "bound_share": b_ms / ms,
             "bound_ms_two_pass": old_ms,
             "bound_share_two_pass": old_ms / ms}
    say(dict({"phase": "chain", "case": "bench_chain", "identical": True,
              "setup_s": setup_s}, **bench))
    # config 3's real seeds
    t0 = time.perf_counter()
    ref3, sidx3, spos3, off3, names, qids, qlen3 = config3_seeds(
        small, work, rng)
    setup3 = time.perf_counter() - t0
    _build.reset_launches()
    t0 = time.perf_counter()
    got3 = ch.chain_records(ref3, sidx3, spos3, off3, device=dev)
    c3_s = time.perf_counter() - t0
    c3_launch = _build.LAUNCHES["chain_scan"]
    t0 = time.perf_counter()
    want3 = chain_oracle(ref3, sidx3, spos3, off3)
    oracle_s = time.perf_counter() - t0
    if [[tuple(int(v) for v in r) for r in g] for g in got3] != want3:
        fail("chain: config 3 records differ from the oracle")
    c3_native = native_chain_s(ref3, sidx3, spos3, off3, names, qids, qlen3)
    say({"phase": "chain", "case": "config3", "identical": True,
         "reads": len(off3) - 1, "seeds": int(off3[-1]),
         "records": sum(len(g) for g in got3), "setup_s": setup3,
         "chain_records_s": c3_s, "native_mm_query_emit_s": c3_native,
         "oracle_s": oracle_s, "launches": c3_launch,
         "card": nvidia_smi_line()})
    edges = chain_edges(L, ch, pc, dev, ref, sidx, spos, off, args, want)
    say({"phase": "chain", "edges": edges, "identical": True})
    report["chain_scan"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, bound_share=b_ms / ms, library_ms=None,
        library="none: no PyTorch call runs a per-read sequential "
        "automaton", timed="the offsets form's one launch on "
        "bench_chain's %d reads (%d seeds)" % (R, int(off[-1])),
        bench_chain=bench, edges=edges)


def chain_edges(L, ch, pc, dev, ref, sidx, spos, off, bench_args,
                bench_want):
    """chain_emit against chain_emit_ref, bit for bit, on the edges of its
    one launch: no reads, one long read, a tile's staging outgrown, reads
    with no live seed, two calls in a row, calls alternated on two streams
    (bench_chain's reads, whose plain result is bench_want, and the long
    read).  The plain version runs with a cap that holds the long reads'
    records in one pass (it doubles its cap and runs again otherwise).
    Returns {edge: (reads, records)}."""
    import numpy as np
    import torch
    n_dead = len(off) - 1
    r_long = pc.bench_chain_case(1, 10_000, seed=3)
    dead = (ref, np.zeros_like(sidx), spos, off)
    cases = {"no_reads": (ref, sidx[:0], spos[:0], off[:1]),
             "one_read_10000": r_long, "staging": staging_read(1_800),
             "no_live_%d" % n_dead: dead}
    out, wants = {}, {}
    for tag, case in cases.items():
        args, _n = pc.device_seeds(*case, dev)
        want = ch.chain_emit_ref(*args, cap=1024)
        for _ in range(2 if tag == "one_read_10000" else 1):  # in a row
            got = ch.chain_emit(*args)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                fail("chain: chain_emit != chain_emit_ref (%s)" % tag)
        out[tag] = (len(case[3]) - 1, int(want[0].shape[0]))
        wants[tag] = (args, want)
    if out["staging"][1] <= L.mz_chain_rec_cap() or \
            out["no_live_%d" % n_dead][1]:
        fail("chain: the edge cases are not the edges: %s" % out)
    # calls alternated on two streams, each with its own scratch
    pairs = [(bench_args, bench_want), wants["one_read_10000"]]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for i in range(4):
        args, want = pairs[i % 2]
        with torch.cuda.stream(streams[i % 2]):
            got = ch.chain_emit(*args)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail("chain: chain_emit on two streams differs (call %d)" % i)
    out["two_streams"] = (4, 2 * sum(int(w[0].shape[0]) for _a, w in pairs))
    return out


# ---------------------------------------------------------------- multihost

MH_READS = 200_000                # bench.py's reads, default_rng(42)


def port_cli(tool, argv, nproc, env_extra=None):
    """The port's ``tool`` as a fresh process (nproc 0) or under torchrun
    with ``nproc`` ranks: (stdout with the timing lines dropped, wall s)."""
    module = "modimizer_tpu_torch.cli." + tool
    cmd = ([sys.executable, "-m", module] if not nproc else
           [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), "-m", module])
    env = dict(os.environ, PYTHONPATH=HERE, **(env_extra or {}))
    for v in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(v, None)
    t0 = time.perf_counter()
    r = subprocess.run(cmd + [str(a) for a in argv], cwd=HERE, env=env,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode:
        fail("%s (nproc %d) exited %d:\n%s" % (tool, nproc, r.returncode,
                                               r.stderr[-3000:]))
    return _TIMING.sub("", r.stdout), wall


def shard_of(codes, offsets, first, last):
    """Reads [first, last) of a stream: (codes, offsets from 0, base)."""
    lo, hi = int(offsets[first]), int(offsets[last])
    return codes[lo:hi], offsets[first:last + 1] - lo, lo


def phase_multihost(small, work, launches):
    """The multi-process build (parallel/multihost.py) and modutils under
    torchrun.  At world size 1 (the plain run): bench.py's 200,000 reads
    of 1,000 bp (k16 w16) fed to MultiHostModsetBuilder on a world-size-1
    NCCL group as two shards in turn, with a snapshot saved and restored
    between them (the main path: launch counts zeroed before and read
    after), against the one-device builder's finalize and total_emitted;
    then ``modutils -c 26 16 16 17 -a reads.fa -w out.mod`` as a fresh
    process and under ``torch.distributed.run --standalone`` with one rank
    (and with every card, where the machine has more than one), stdout
    and .mod byte-identical; then config 3's modmap likewise
    (``modmap_torchrun``).  Under torchrun (WORLD_SIZE > 1, one process a
    card): four uneven shards (the first rank takes half the reads)
    against the one-device builder."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from modimizer_tpu_torch import _build
    from modimizer_tpu_torch.core.seqhash import Seqhash
    from modimizer_tpu_torch.parallel.mesh import build_mesh
    from modimizer_tpu_torch.parallel.multihost import MultiHostModsetBuilder
    from modimizer_tpu_torch.parallel.sharded import ShardedModsetBuilder
    world = int(os.environ.get("WORLD_SIZE", "1"))
    sh = Seqhash.create(16, 16, SEED)
    n_reads = 4_000 if small else MH_READS
    codes, offsets = bench_codes(n_reads, 1000, 42)
    t0 = time.perf_counter()
    one = ShardedModsetBuilder(sh, "cuda")
    one.feed_stream(codes, offsets)
    want = one.finalize()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    if world > 1:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl",
                                timeout=datetime.timedelta(seconds=300))
        # the first rank takes half the reads, the others share the rest
        bounds = np.concatenate([[0], np.linspace(n_reads // 2, n_reads,
                                                  world).astype(int)])
    else:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            work, "mh_init"), world_size=1, rank=0)
        bounds = np.array([0, n_reads // 2, n_reads])
    try:
        mesh = build_mesh(group=dist.group.WORLD)
        # NCCL connects at the first all-to-all (~3 s on four cards): warm
        # it up before the timed build
        mesh.all_to_all(torch.zeros(mesh.n * 1024, dtype=torch.int64,
                                    device=mesh.device))
        mesh.barrier()
        _build.reset_launches()
        t0 = time.perf_counter()
        b = MultiHostModsetBuilder(sh, mesh)
        if world > 1:
            r = mesh.rank
            b.feed_stream(*shard_of(codes, offsets, bounds[r],
                                    bounds[r + 1]))
            cursor = None
        else:
            b.feed_stream(*shard_of(codes, offsets, 0, bounds[1]))
            snap = os.path.join(work, "mh.snap")
            b.save(snap, cursor=int(offsets[bounds[1]]))
            b, cursor = MultiHostModsetBuilder.restore(snap, sh, mesh)
            b.feed_stream(*shard_of(codes, offsets, bounds[1], bounds[2]))
        got = b.finalize()
        torch.cuda.synchronize()
        mh_s = time.perf_counter() - t0
        counts = {n: _build.LAUNCHES[n] for n in ("scan_compact",
                                                  "route_rows")}
        same = (all(np.array_equal(x, y) for x, y in zip(got, want))
                and b.total_emitted == one.total_emitted and b.routed)
        if not same or not all(counts.values()):
            fail("multihost: the build differs from the one-device builder "
                 "(%s)" % counts)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        rank = mesh.rank
    finally:
        dist.destroy_process_group()
    say({"phase": "multihost", "world_size": world, "rank": rank,
         "reads": n_reads, "shards": np.diff(bounds).tolist(),
         "identical": True, "kmers": len(got[0]),
         "total_emitted": b.total_emitted, "snapshot_cursor": cursor,
         "multihost_s": mh_s, "one_device_s": one_s, "launches": counts,
         "card": nvidia_smi_line()})
    if world > 1:
        return
    # modutils: a fresh process against torchrun's ranks
    fa = os.path.join(work, "mh_reads.fa")
    write_reads(fa, n_reads, 1000, 42)
    cpus = os.cpu_count() or 1

    def argv(tag):
        return ["-c", 26, 16, 16, 17, "-a", fa, "-w",
                os.path.join(work, tag + ".mod")]
    ref_out, ref_s = port_cli("modutils", argv("one"), 0)
    with open(os.path.join(work, "one.mod"), "rb") as f:
        ref_mod = f.read()
    walls = {"one_process": ref_s}
    for nproc in sorted({1, torch.cuda.device_count()}):
        out, wall = port_cli(
            "modutils", argv("ranks%d" % nproc), nproc,
            {"OMP_NUM_THREADS": str(max(1, cpus // nproc))})
        with open(os.path.join(work, "ranks%d.mod" % nproc), "rb") as f:
            same = f.read() == ref_mod
        if out != ref_out or not same or "added %d sequences" % n_reads \
                not in out:
            fail("modutils under torchrun (nproc %d) differs from one "
                 "process" % nproc)
        walls["torchrun_%d" % nproc] = wall
    say({"phase": "multihost", "case": "modutils", "bp": n_reads * 1000,
         "identical": True, "wall_s": walls, "card": nvidia_smi_line()})
    modmap_torchrun(small, work, launches)


def modmap_torchrun(small, work, launches):
    """``modmap -K 24 -W 31 -f ref -q reads`` on config 3 as a fresh
    process and under ``torch.distributed.run --standalone`` with one rank
    (and with every card, where the machine has more than one), in turns,
    stdout byte-identical; then once in this process with torchrun's variables
    at world size 1 (the main path: launch counts zeroed before and read
    after), where the -q lookup is the mesh DeviceTable's: route_rows in
    lookup mode, the exchange through NCCL, find_sorted."""
    import socket
    import torch
    from modimizer_tpu_torch import _build
    argv = config3_argv(small, work)
    cpus = os.cpu_count() or 1
    # in turns: one process, each rank count up and down, one process
    ranks = sorted({1, torch.cuda.device_count()})
    walls, ref_out = {}, None
    for nproc in [0] + ranks + ranks[::-1] + [0]:
        out, wall = port_cli("modmap", argv, nproc, nproc and {
            "OMP_NUM_THREADS": str(max(1, cpus // nproc))})
        ref_out = out if ref_out is None else ref_out
        if out != ref_out or "\nQ\tr0\t" not in out:
            fail("modmap under torchrun (nproc %d) differs from one process"
                 % nproc)
        walls.setdefault("torchrun_%d" % nproc if nproc else "one_process",
                         []).append(wall)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    kernels = PATH_KERNELS["modmap"] + ("route_rows",)
    _build.reset_launches()
    out, _err, wall, made, stages = run_app(
        "modmap", argv, work, "modmap.torchrun", env=dict(
            WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
    counts = {n: _build.LAUNCHES[n] for n in kernels}
    if not all(counts.values()):
        fail("modmap under torchrun: a kernel was never launched: %s"
             % counts)
    if not made or any(not s.used_device or s.device.type != "cuda"
                       for s in made):
        fail("modmap under torchrun: a scan did not run on the card")
    if out != ref_out:
        fail("modmap under torchrun in process differs from one process")
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    walls["torchrun_1_in_process"] = [wall]
    say({"phase": "multihost", "case": "modmap.config3", "argv":
         [str(a) for a in argv], "identical": True, "stdout_bytes":
         len(out), "wall_s": walls, "launches": counts, "stages_s": stages,
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
                              "scripts/probe_pallas_front.py:134",
                              "scripts/probe_front_mxu.py:200"]},
        "front_reduce": {
            "name": "front_reduce", "route": "cuda",
            "source": "modimizer_tpu_torch/csrc/front_reduce.cu",
            "replaces": "scripts/probe_pallas_parts.py:211",
            "also_replaces": ["scripts/probe_pallas_front.py:134"]},
        "front_mma": {
            "name": "front_mma", "route": "cuda",
            "source": "modimizer_tpu_torch/csrc/front_mma.cu",
            "replaces": "scripts/probe_front_mxu.py:212"},
        "front_ops": {
            "name": "front_ops", "route": "cuda",
            "source": "modimizer_tpu_torch/csrc/front_ops.cu",
            "replaces": "scripts/probe_front.py:36"},
    }
    report["find_sorted"] = {
        "name": "find_sorted", "route": "cuda",
        "source": "modimizer_tpu_torch/csrc/lookup.cu",
        "replaces": "modimizer_tpu/parallel/lookup.py:43"}
    report["overlap_pairs"] = {
        "name": "overlap_pairs", "route": "cuda",
        "source": "modimizer_tpu_torch/csrc/overlaps.cu",
        "replaces": "modimizer_tpu/parallel/overlaps.py:50"}
    for name, line in (("tala16", 68), ("dot16", 103), ("roll12", 136),
                       ("cumsum128", 165)):
        report[name] = {"name": name, "route": "cuda",
                        "source": "modimizer_tpu_torch/csrc/mosaic_prims.cu",
                        "replaces": "scripts/probe_mosaic_prims.py:%d" % line}
    report["route_rows"] = {
        "name": "route_rows", "route": "cuda",
        "source": "modimizer_tpu_torch/csrc/route.cu",
        "replaces": "modimizer_tpu/parallel/sharded.py:1692",
        "also_replaces": ["modimizer_tpu/parallel/sharded.py:2101",
                          "modimizer_tpu/parallel/lookup.py:136"]}
    report["merge_reduce"] = {
        "name": "merge_reduce", "route": "cuda",
        "source": "modimizer_tpu_torch/csrc/merge.cu",
        "replaces": "modimizer_tpu/parallel/sharded.py:2131"}
    report["minimizer"] = {
        "name": "minimizer", "route": "cuda",
        "source": "modimizer_tpu_torch/csrc/minimizer.cu",
        "replaces": "modimizer_tpu/ops/minimizer.py:136"}
    report["chain_scan"] = {
        "name": "chain_scan", "route": "cuda",
        "source": "modimizer_tpu_torch/csrc/chain.cu",
        "replaces": "modimizer_tpu/parallel/chain.py:40"}
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
        if "apps" in phases:
            os.makedirs(work, exist_ok=True)
            phase_apps(a.small, work, launches)
        if "probes" in phases:
            phase_probes(a.small, launches)
        if "sharded" in phases:
            os.makedirs(work, exist_ok=True)
            phase_sharded(a.small, work, launches, report)
        if "minimizer" in phases:
            phase_minimizer(a.small, launches, report)
        if "chain" in phases:
            os.makedirs(work, exist_ok=True)
            phase_chain(a.small, work, launches, report)
        if "multihost" in phases:
            os.makedirs(work, exist_ok=True)
            phase_multihost(a.small, work, launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name, entries in ENTRIES.items():
        if any(e in launches for e in entries):
            by = {e: launches.pop(e, 0) for e in entries}
            report[name].update(launches=sum(by.values()),
                                launches_by_entry=by)
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
