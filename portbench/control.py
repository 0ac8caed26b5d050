#!/usr/bin/env python3
"""The control of the output check: the plain reference put in the
program's place, computed one step below what the configuration states.
The configurations state exact tables of 64-bit k-mers (k 19 is 38 bits,
k 24 is 48); the step below carries the k-mers in 32 bits (the table
keyed, counted and looked up by their low 32 bits), the shortcut a
32-bit key would take.  Every cell's check has to fail it.

    python3 portbench/control.py --workload grch38_chr20.map --seeds 1 2 3

Prints one JSON line a seed with each number the check compares and its
limit; exits non-zero if the control passed on any seed.  The benchmark's
own runs do not run it."""

import argparse
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def control_numbers(spec, name, seed, device, cfg=None):
    """{number: value} the cell's check reads for the control on ``seed``,
    and the limits."""
    from bench_data import input_paths, make_inputs
    from bench_harness import job_argv
    cell = spec.cell(name)
    cfg = spec.config(cell) if cfg is None else cfg
    traffic = spec.traffic(cell)
    kind = importlib.import_module("checks." + traffic["check"])
    inputs = make_inputs(cfg, seed, traffic)
    argv = job_argv(traffic, dict(cfg, **input_paths(traffic["inputs"],
                                                     ".")))
    want = kind.expected(inputs, cfg, device, argv)
    low = kind.expected(inputs, cfg, device, argv, kmer_bits=32)
    return kind.numbers(kind.as_port(low), ["\n".join(low["lines"])],
                        want), kind.LIMITS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    from bench_harness import Spec
    spec = Spec(os.path.join(os.path.dirname(HERE), "BENCHMARK.json"))
    passed = 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers, limits = control_numbers(spec, args.workload, seed,
                                          args.device)
        fails = [n for n, v in numbers.items() if v > limits[n]]
        passed += not fails
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": numbers, "limits": limits,
                          "failed": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
