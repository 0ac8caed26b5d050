#!/usr/bin/env python3
"""The benchmark of modimizer_tpu_torch, the PyTorch and CUDA port: one run
of one cell of BENCHMARK.json on the CUDA cards of this machine.

    python3 portbench/run.py --workload ecoli_hifi30x.build --seed 7 \\
        --seconds 10 --trace 0

Set-up (timed as ``setup_s``) imports the port, builds its kernels on a
checkout's first run, makes the cell's inputs from the seed, writes them
as FASTA under $TMPDIR and runs one warm-up job.  The window then runs
whole jobs back to back, one at a time, through the CLI's own
``main(argv, device="cuda")``; no job starts once ``--seconds`` have
passed, and the cell's rate is the work of all the jobs over the span from
the first one's start to the last one's end.  After the window the plain
reference (``reference/``) works out what the jobs must produce and
``checks/`` compares.  The last line of stdout is the result object;
with ``--trace 1`` its metrics are the cell's per-layer ones, read from
the program's stage spans and a ``torch.profiler`` trace of the window.

Exits non-zero without a result when no CUDA card is there (or fewer
than the cell asks for), when the port is not beside this directory, and
when JAX or the JAX package is loaded once the window has closed."""

import time

T_START = time.perf_counter()

import argparse     # noqa: E402
import json         # noqa: E402
import os           # noqa: E402
import sys          # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    from bench_harness import Spec, banned_modules, run_cell
    spec = Spec(os.path.join(ROOT, "BENCHMARK.json"))
    cell = spec.cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        sys.stderr.write("portbench: the cell needs %d CUDA card(s); this "
                         "machine has %s\n"
                         % (cell["chips"], torch.cuda.device_count()
                            if torch.cuda.is_available() else "none"))
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    found = banned_modules()
    if found:
        sys.stderr.write("portbench: JAX or the JAX package was loaded: "
                         "%s\n" % ", ".join(found))
        return 3
    for name, c in result["checks"].items():
        sys.stderr.write("check %s %r limit %r\n"
                         % (name, c["value"], c["limit"]))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
