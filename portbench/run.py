#!/usr/bin/env python3
"""The benchmark of modimizer_tpu_torch, the PyTorch and CUDA port: one run
of one cell of BENCHMARK.json on the CUDA cards of this machine.

    python3 portbench/run.py --workload ecoli_hifi30x.build --seed 7 \\
        --seconds 10 --trace 0

A cell on one card runs with OMP_NUM_THREADS at 4 where the environment
leaves it unset.  Set-up (timed as ``setup_s``) imports the port, builds
its kernels on a checkout's first run, makes the cell's inputs from the seed, writes them
as FASTA under $TMPDIR and runs one warm-up job.  The window then runs
whole jobs back to back, one at a time, through the CLI's own
``main(argv, device="cuda")``; no job starts once ``--seconds`` have
passed, and the cell's rate is the work of all the jobs over the span from
the first one's start to the last one's end.  After the window the plain
reference (``reference/``) works out what the jobs must produce and
``checks/`` compares.  The last line of stdout is the result object;
with ``--trace 1`` its metrics are the cell's per-layer ones, read from
the program's stage spans and a ``torch.profiler`` trace of the window.

A cell on n > 1 cards runs as n ranks under torchrun, one process a card
(``bench_ranks.py``): every rank runs each job, in lockstep, and rank 0
traces, checks and makes the result, which this process prints; its
``setup_s`` runs from this process's start to rank 0's window.

Exits non-zero without a result when no CUDA card is there (or fewer
than the cell asks for), when the port is not beside this directory,
when a rank fails or the ranks run past their deadline, and when JAX or
the JAX package is loaded once the window has closed."""

import time

T_START = time.perf_counter()

import argparse     # noqa: E402
import json         # noqa: E402
import os           # noqa: E402
import sys          # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# OpenMP's threads in a cell on one card, where the environment leaves
# OMP_NUM_THREADS unset: half of an 8-core host, for the native FASTA
# pass and torch's CPU operations alike; with every core, runs of one
# code on a shared host spread by up to a quarter, at 4 by about a tenth
SOLO_THREADS = 4


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
    if cell["chips"] == 1:
        # one process of few threads, set before torch and the native
        # library load their OpenMP runtimes; torchrun sets 1 a rank
        os.environ.setdefault("OMP_NUM_THREADS", str(SOLO_THREADS))
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        sys.stderr.write("portbench: the cell needs %d CUDA card(s); this "
                         "machine has %s\n"
                         % (cell["chips"], torch.cuda.device_count()
                            if torch.cuda.is_available() else "none"))
        return 2
    if cell["chips"] > 1:
        from bench_ranks import launch
        rc, result = launch(spec, args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START)
        if result is None:
            sys.stderr.write("portbench: the ranks ended with code %r and "
                             "no result\n" % rc)
            return rc or 1
    else:
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
