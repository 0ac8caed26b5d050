#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels from
this checkout, holds each against its plain PyTorch version, drives the
port's ``modutils -a`` at full size and checks its .mod against the native
host path byte for byte.

    python3 chip_smoke.py                 # every phase, one CUDA card
    python3 chip_smoke.py --phases env,build,kernels --small

Prints one JSON line per phase, then a ``{"kernels": [...]}`` line, the
card's ``name, power.limit`` line from nvidia-smi, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, without that last line,
when CUDA is absent, the port cannot be imported (e.g. this file alone in a
directory), a kernel fails to build or launch, or any check disagrees.
Imports nothing of JAX.
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
PHASES = ("env", "build", "kernels", "main", "overflow")
KW_PAIRS = [(16, 16), (11, 10), (13, 31), (19, 31), (24, 16), (31, 31)]
SEED = 17


def say(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit("chip_smoke FAILED: " + msg)


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
    from modimizer_tpu.native import lib as native_lib
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
    """0 when every pair is bit-identical, else the largest |a - b|."""
    import torch
    err = 0.0
    for a, b in pairs:
        if a.shape != b.shape:
            return float("inf")
        if not torch.equal(a, b):
            d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
            err = max(err, float(d), 1.0)
    return err


def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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
    from modimizer_tpu_torch import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    say({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
         "library": os.path.relpath(so, HERE),
         "sources": [os.path.relpath(s, HERE) for s in _build.sources()]})


def phase_kernels(small, report):
    """Each kernel against its plain version on the card, bit for bit."""
    import numpy as np
    import torch
    from modimizer_tpu.core.seqhash import Seqhash
    from modimizer_tpu.ops.seqhash import scan_bo
    from modimizer_tpu_torch.ops.device_scan import densify, densify_ref
    from modimizer_tpu_torch.ops.scan_kernel import (kernel_params,
                                                     scan_compact,
                                                     scan_compact_ref)
    from modimizer_tpu_torch.ops.seqhash import ModimizerScanner
    rng = np.random.default_rng(SEED)
    sizes = [1 << 15] if small else [1 << 15, 1 << 25]
    errs = {"scan_compact": 0.0, "densify": 0.0}
    n_cases = 0

    def check_scan(sw, vb, kp, C, bo, meta_isf, tag):
        nonlocal n_cases
        args = dict(k=kp.k, w=kp.w, factor1=kp.factor1, C=C, bo=bo,
                    meta_isf=meta_isf)
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
        out_k, out_meta, cnt = rows[0], rows[1], rows[2]
        for meta in (None, out_meta):
            got = densify(out_k, meta, cnt, bo=bo, cap=cap)
            want = densify_ref(out_k, meta, cnt, bo=bo, cap=cap)
            torch.cuda.synchronize()
            pairs = [(got[0], want[0])]
            if meta is not None:
                pairs.append((got[1], want[1]))
            e = max_abs_err(pairs)
            errs["densify"] = max(errs["densify"], e)
            if e:
                fail("densify != densify_ref at %s" % tag)

    for C in sizes:
        for k, w in KW_PAIRS:
            kp = kernel_params(Seqhash.create(k, w, SEED))
            sw, vb = random_chunk(rng, C, k)
            bo = scan_bo(w)
            cap = ModimizerScanner(Seqhash.create(k, w, SEED), chunk=C,
                                   device="cuda").cap
            for meta_isf in (False, True):
                tag = "C=2^%d k=%d w=%d meta_isf=%s" % (
                    C.bit_length() - 1, k, w, meta_isf)
                rows = check_scan(sw, vb, kp, C, bo, meta_isf, tag)
                check_densify(rows, bo, cap, tag)
    # poly-A: k-mer 0 hashes to 0, every position emits, every block
    # overflows bo
    C = sizes[-1]
    kp = kernel_params(Seqhash.create(16, 16, SEED))
    sw, vb = random_chunk(rng, C, 16, poly_a=True)
    bo = scan_bo(16)
    rows = check_scan(sw, vb, kp, C, bo, False, "poly-A")
    if not bool(rows[4]) or int((rows[2] > bo).sum()) != rows[2].numel():
        fail("poly-A chunk did not overflow every block")
    check_densify(rows, bo, C // 4, "poly-A")
    say({"phase": "kernels", "cases": n_cases, "sizes": sizes,
         "kw": KW_PAIRS, "max_abs_err": errs})

    # time each kernel beside its plain version at the main path's shape
    # (C = 2^25 unless --small; k=16 w=16, kmers-only, the bench cap)
    C = sizes[-1]
    sh = Seqhash.create(16, 16, SEED)
    kp = kernel_params(sh)
    bo = scan_bo(16)
    cap = ModimizerScanner(sh, chunk=C, device="cuda").cap
    sw, vb = random_chunk(rng, C, 16)
    args = dict(k=kp.k, w=kp.w, factor1=kp.factor1, C=C, bo=bo,
                meta_isf=False)
    rows = scan_compact(sw, vb, **args)
    t = {"scan_compact": (time_ms(lambda: scan_compact(sw, vb, **args), 20),
                          time_ms(lambda: scan_compact_ref(sw, vb, **args),
                                  3)),
         "densify": (time_ms(lambda: densify(rows[0], None, rows[2], bo=bo,
                                             cap=cap), 20),
                     time_ms(lambda: densify_ref(rows[0], None, rows[2],
                                                 bo=bo, cap=cap), 3))}
    for name, (ms, plain_ms) in t.items():
        report[name].update(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms)
    say({"phase": "kernel_times", "C": C, "k": 16, "w": 16,
         "ms": {n: v[0] for n, v in t.items()},
         "plain_ms": {n: v[1] for n, v in t.items()},
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


def run_port(argv, launches):
    """The port's modutils in this process on the card: (stdout, wall s,
    scanner).  Launch counts are zeroed just before and read just after,
    and every kernel of the path must have run."""
    import torch
    from modimizer_tpu_torch import _build
    from modimizer_tpu_torch.cli import modutils as port_cli
    out = io.StringIO()
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        scanner = port_cli.run(argv, device=torch.device("cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    if not all(counts.values()):
        fail("%s: a kernel was never launched: %s" % (argv, counts))
    if scanner is None or not scanner.used_device or scanner.n_fallback:
        fail("%s: the scan left the device (n_fallback=%s)"
             % (argv, None if scanner is None else scanner.n_fallback))
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    return out.getvalue(), wall, scanner


def run_host(argv):
    """The JAX package's modutils on its native host scan (a subprocess,
    MODIMIZER_SCAN=host; no jax is imported there either): (stdout, wall)."""
    env = dict(os.environ, MODIMIZER_SCAN="host")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "modimizer_tpu.cli.modutils"]
                       + argv, cwd=HERE, env=env, capture_output=True,
                       text=True)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        fail("host modutils rc %d: %s" % (r.returncode, r.stderr[-2000:]))
    return r.stdout, wall


def run_pair(work, fa, params, tag, launches):
    """modutils -c <params> -a fa through the port (on the card) and the
    host path: timed without -w (parse + scan + table replay, the build
    rate), then again with -w; .mod bytes and 'added' lines must agree."""
    port_mod = os.path.join(work, tag + ".port.mod")
    host_mod = os.path.join(work, tag + ".host.mod")
    argv = ["-c"] + [str(p) for p in params] + ["-a", fa]
    port_out, port_s, scanner = run_port(argv, launches)
    port_w_out, port_w_s, _ = run_port(argv + ["-w", port_mod], launches)
    host_out, host_s = run_host(argv)
    host_w_out, host_w_s = run_host(argv + ["-w", host_mod])
    lines = [[m.group(0) for m in _ADDED.finditer(o)]
             for o in (port_out, port_w_out, host_out, host_w_out)]
    if not lines[0] or any(x != lines[0] for x in lines):
        fail("%s: 'added' lines differ: %r" % (tag, lines))
    with open(port_mod, "rb") as a, open(host_mod, "rb") as b:
        same = a.read() == b.read()
    if not same:
        fail("%s: port .mod differs from the host path's" % tag)
    m = re.match(r"added (\d+) sequences total length (\d+)", lines[0][0])
    kpos = int(m.group(2)) - (params[1] - 1) * int(m.group(1))
    say({"phase": "main", "case": tag, "params": list(params),
         "added": lines[0][0], "mod_identical": same, "kmer_positions": kpos,
         "port_build_s": port_s, "port_mpos_s": kpos / port_s / 1e6,
         "host_build_s": host_s, "host_mpos_s": kpos / host_s / 1e6,
         "port_with_write_s": port_w_s, "host_with_write_s": host_w_s,
         "n_wide": scanner.n_wide, "n_fallback": scanner.n_fallback,
         "launches": dict(launches), "card": nvidia_smi_line()})


def phase_main(small, work, launches):
    n200 = 2_000 if small else 200_000
    n20 = 2_000 if small else 20_000
    fa = os.path.join(work, "reads200.fa")
    write_reads(fa, n200, 1000, 42)
    run_pair(work, fa, (26, 16, 16, 17), "k16w16", launches)
    fa20 = os.path.join(work, "reads20.fa")
    write_reads(fa20, n20, 1000, 43)
    run_pair(work, fa20, (26, 19, 31, 17), "k19w31", launches)
    if "jax" in sys.modules:
        fail("jax was imported")


def phase_overflow():
    """A 220 bp poly-A run overflows its block: the wide device retry
    absorbs it without the host rescan, and rows match the host path."""
    import numpy as np
    from modimizer_tpu.core.seqhash import Seqhash
    from modimizer_tpu.ops.seqhash import ModimizerScanner as HostScanner
    from modimizer_tpu_torch.ops.seqhash import ModimizerScanner
    sh = Seqhash.create(16, 16, SEED)
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 1 << 15).astype(np.uint8)
    codes[5000:5000 + 220] = 0
    offsets = np.array([0, len(codes)], np.int64)
    host = HostScanner(sh, host_threshold=1 << 62)
    dev = ModimizerScanner(sh, chunk=1 << 14, device="cuda",
                           host_threshold=0)
    same_k = np.array_equal(dev.scan_kmers(codes, offsets),
                            host.scan_kmers(codes, offsets))
    dev2 = ModimizerScanner(sh, chunk=1 << 14, device="cuda",
                            host_threshold=0)
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
    }
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
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "main" in phases:
        for name, n in launches.items():
            report[name]["launches"] = n
    if "jax" in sys.modules:
        fail("jax was imported")
    say({"kernels": list(report.values())})
    print(nvidia_smi_line(), flush=True)
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
