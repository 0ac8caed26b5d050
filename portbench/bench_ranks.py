#!/usr/bin/env python3
"""A cell on n > 1 cards: n ranks, one process a card, launched as users
launch the port's mesh, by ``torch.distributed.run --standalone
--nproc_per_node n`` (torchrun, with its defaults: it sets
OMP_NUM_THREADS to 1 for every rank where the environment leaves it
unset).

``launch`` (``run.py`` calls it) builds the port's kernels and its native
library once, before any rank starts, makes a work directory, and runs
torchrun's own ``main`` in its process, so that torch is imported once
before the ranks start and not twice.  Each rank (this file, run as a
script) joins one process group in its set-up, with a timeout of
GROUP_TIMEOUT_S: NCCL on the card ``cuda:<LOCAL_RANK>``, or gloo on the
CPU.  The CLI's ``torchrun_mesh`` then finds the group made and leaves it
after each job.  Every rank runs ``bench_harness.run_cell`` with its
``Ranks``.  Rank 0 writes the inputs into the work directory and decides
before each job whether it runs.  Every rank runs the job, and rank 0
takes the job's end once every rank has ended it.  That control rides
torchrun's key-value store, apart from the group's collectives.  Rank 0
writes the result object into the work directory, and ``launch`` returns
it once torchrun has ended without a failure.  Every rank looks in its
``sys.modules`` for JAX or the JAX package once the window has closed,
and one that finds either exits non-zero, so that torchrun fails and no
result is returned.

When a rank dies, torchrun stops the others at once.  When a rank hangs,
the others give up after GROUP_TIMEOUT_S, waiting in a collective or on
the store, and torchrun stops the rest: SIGTERM, then SIGKILL after its
grace of TERM_GRACE_S.  So a fault ends the run within GROUP_TIMEOUT_S +
TERM_GRACE_S and a few seconds.  Whatever happens, ``launch`` stops
torchrun, the same way, ``seconds`` + DEADLINE_S after starting it.
Each rank is set to end with the launching process, so no rank outlives
a run.

    python3 portbench/bench_ranks.py --workload W --seed S --seconds T \
        --trace 0 --t-start F --work DIR --spec BENCHMARK.json

is one rank, under torchrun's variables.
"""

import argparse
import datetime
import importlib
import json
import os
import shutil
import signal
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PORT = "modimizer_tpu_torch"
GROUP_TIMEOUT_S = 60    # the group's collectives and the store's waits
TERM_GRACE_S = 30       # torchrun's, from SIGTERM to SIGKILL of its ranks
DEADLINE_S = 240        # beyond the window: set-up, the check, teardown


def die_with_parent(sig):
    """Have the kernel send ``sig`` to this process when its parent ends
    (Linux's PR_SET_PDEATHSIG)."""
    import ctypes
    parent = os.getppid()
    ctypes.CDLL(None, use_errno=True).prctl(1, int(sig), 0, 0, 0)
    if os.getppid() != parent:          # it ended before the request
        os.kill(os.getpid(), sig)


class Ranks:
    """Rank ``rank`` of ``n``: the jobs' lockstep over torchrun's store."""

    def __init__(self, store, rank, n):
        self.store, self.rank, self.n = store, rank, n
        self.step = 0

    def go(self, want):
        """Whether the next job runs: rank 0's ``want``, on every rank."""
        key = "go.%d" % self.step
        if self.rank == 0:
            self.store.set(key, "1" if want else "0")
        return self.store.get(key) == b"1"

    def done(self, err):
        """This rank has ended the job; ``err`` is its error text, or
        None.  On rank 0, once every rank has ended it: the errors of
        the ranks on which it failed, or None."""
        keys = ["done.%d.%d" % (self.step, r) for r in range(self.n)]
        self.step += 1
        self.store.set(keys[self.rank], "" if err is None else err[-2000:])
        if self.rank:
            return None
        self.store.wait(keys)
        errs = ["rank %d: %s" % (r, v.decode(errors="replace"))
                for r, v in enumerate(self.store.get(k) for k in keys) if v]
        return "\n".join(errs) or None

    def put(self, key, value):
        """A rank above 0 hands rank 0 its reading ``key``."""
        self.store.set("%s.%d" % (key, self.rank), json.dumps(value))

    def gather(self, key, value):
        """On rank 0: its reading ``key`` and every other rank's."""
        return [value] + [json.loads(self.store.get("%s.%d" % (key, r)))
                          for r in range(1, self.n)]


def join(device):
    """Join torchrun's group (NCCL on this rank's card, gloo for the
    CPU) and return this rank's ``Ranks``."""
    import torch
    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    store, rank, n = next(dist.rendezvous("env://", timeout=timeout))
    cpu = torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("gloo" if cpu else "nccl", store=store,
                            rank=rank, world_size=n, timeout=timeout)
    return Ranks(dist.PrefixStore("portbench", store), rank, n)


class Deadline(Exception):
    """The launch ran past its deadline."""


def launch(spec, name, seed, seconds, trace, t_start, device="cuda",
           cfg=None, nproc=None):
    """Run cell ``name`` as ``nproc`` ranks (the cell's chips) and return
    (0, or 1 where torchrun failed, or 124 where the deadline stopped it;
    the result object, or None).  ``device="cpu"`` runs gloo ranks on the
    CPU and ``cfg`` replaces the cell's configuration (the CPU tests)."""
    from bench_harness import set_caches
    from torch.distributed.run import main as torchrun
    nproc = spec.cell(name)["chips"] if nproc is None else nproc
    set_caches()
    if device != "cpu":
        importlib.import_module(PORT + "._build").lib()   # nvcc, first run
    importlib.import_module(PORT + ".native").lib()       # g++, first run
    work = tempfile.mkdtemp(prefix="portbench.")

    def past_deadline(_sig, _frame):
        raise Deadline()
    alarm = signal.signal(signal.SIGALRM, past_deadline)
    try:
        if cfg is not None:
            with open(os.path.join(work, "cfg.json"), "w") as f:
                json.dump(cfg, f)
        signal.alarm(int(seconds + DEADLINE_S))
        try:
            # torchrun stops its ranks when it leaves, by any exception
            torchrun(["--standalone", "--nproc_per_node", str(nproc),
                      str(HERE / "bench_ranks.py"),
                      "--workload", name, "--seed", str(seed),
                      "--seconds", repr(seconds), "--trace", str(int(trace)),
                      "--t-start", repr(t_start), "--work", work,
                      "--spec", str(spec.path), "--device", device])
            rc = 0
        except Deadline:
            rc = 124
        except Exception:                   # a rank failed
            rc = 1
        finally:
            signal.alarm(0)
        path = os.path.join(work, "result.json")
        if rc != 0 or not os.path.exists(path):
            return rc or 1, None
        with open(path) as f:
            return rc, json.load(f)
    finally:
        signal.signal(signal.SIGALRM, alarm)
        shutil.rmtree(work, ignore_errors=True)


def rank_main(argv):
    ap = argparse.ArgumentParser(prog="bench_ranks.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    ap.add_argument("--t-start", type=float, required=True)
    ap.add_argument("--work", required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    die_with_parent(signal.SIGKILL)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch.distributed as dist
    from bench_harness import Spec, banned_modules, run_cell
    cfg_path = os.path.join(a.work, "cfg.json")
    cfg = None
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
    ranks = join(a.device)
    try:
        result = run_cell(Spec(a.spec), a.workload, a.seed, a.seconds,
                          bool(a.trace), a.device, a.t_start, cfg=cfg,
                          ranks=ranks, work=a.work)
    finally:
        dist.destroy_process_group()
    found = banned_modules()                # on every rank: torchrun then
    if found:                               # fails, and no result is read
        sys.stderr.write("portbench: rank %d: JAX or the JAX package was "
                         "loaded: %s\n" % (ranks.rank, ", ".join(found)))
        return 3
    if result is None:                      # a rank above 0
        return 0
    path = os.path.join(a.work, "result.json")
    with open(path + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(path + ".tmp", path)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
