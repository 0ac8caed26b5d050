"""One run of one cell: set-up, a window of whole jobs, the output check
and the result line.  ``run.py`` is the command; this module is what it
and the CPU tests drive.

Everything that belongs to one configuration, one kind of job or one
per-layer metric is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (the tool, its argv template, its inputs, the
end-to-end rate it reports and the kind of check), ``checks/<kind>.py``
and ``metrics/<metric>.py``.  A new cell or metric is new files and new
entries in ``BENCHMARK.json``; nothing here names a cell.

A cell on one card runs in this process.  A cell on n > 1 cards runs as
n ranks, one process a card (``bench_ranks.py``), each calling
``run_cell`` with its ``Ranks``: the jobs run in lockstep, and rank 0
(the lead) makes the inputs, keeps the job's objects, traces, checks and
makes the result."""

import contextlib
import importlib
import importlib.util
import json
import os
import random
import re
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "modimizer_tpu")
PORT = "modimizer_tpu_torch"


def banned_modules():
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Spec:
    """BENCHMARK.json and the files it names."""

    def __init__(self, bench_json, here=HERE):
        self.path = Path(bench_json)
        self.bench = load_json(bench_json)
        self.here = Path(here)

    def cell(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload %r in BENCHMARK.json" % name)

    def config(self, cell):
        return load_json(self.here / "configs" / (cell["config"] + ".json"))

    def traffic(self, cell):
        return load_json(self.here / "traffic" / (cell["traffic"] + ".json"))

    def metrics(self, kind, cell):
        """The cell's end-to-end or per-layer metrics."""
        return [m for m in self.bench[kind]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric):
        """metrics/<name>.py's read(window)."""
        path = self.here / "metrics" / (metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + re.sub(r"\W", "_", metric), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def job_argv(traffic, values):
    """The traffic's argv template filled in: "{key}" is values[key], a
    list giving one argument an item."""
    argv = []
    for a in traffic["argv"]:
        m = re.fullmatch(r"\{(\w+)\}", a)
        v = values[m.group(1)] if m else a
        argv += [str(x) for x in v] if isinstance(v, list) else [str(v)]
    return argv


def _attr(module, qualname):
    """(owner, name) of ``module.<qualname>``, a dotted path such as
    "Class.method"."""
    owner = importlib.import_module(module)
    *outer, name = qualname.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, name


class Spy:
    """Keeps, for one job of the window drawn from the seed (reservoir
    sampling, so each job is as likely), the argument of the port's
    function that holds the job's result, and, where ``returns`` names a
    second function of the port, what that one returned in the job, call
    by call.  ``target`` None keeps nothing (a rank above 0)."""

    def __init__(self, target, seed, returns=None):
        self.rng = random.Random(seed)
        self.current = self.kept = None
        self.returned, self.kept_returned = [], []
        self.taps = []
        if target is None:
            return
        module, fn, arg = target

        def keep_arg(orig):
            def spy(*args, **kwargs):
                self.current = args if arg is None else args[arg]
                return orig(*args, **kwargs)
            return spy

        def keep_return(orig):
            def spy(*args, **kwargs):
                out = orig(*args, **kwargs)
                self.returned.append(out)
                return out
            return spy

        self.taps.append(_attr(module, fn) + (keep_arg,))
        if returns is not None:
            self.taps.append(_attr(*returns) + (keep_return,))

    def __enter__(self):
        self.origs = [getattr(owner, name) for owner, name, _ in self.taps]
        for (owner, name, wrap), orig in zip(self.taps, self.origs):
            setattr(owner, name, wrap(orig))
        return self

    def __exit__(self, *exc):
        for (owner, name, _), orig in zip(self.taps, self.origs):
            setattr(owner, name, orig)
        self.current = None

    def job_start(self):
        self.current, self.returned = None, []

    def job_done(self, i):
        if self.rng.random() * (i + 1) < 1:
            self.kept, self.kept_returned = self.current, self.returned
        self.job_start()


def run_job(main, argv, out_path, device):
    """One whole job: ``main(argv, device)`` in this process, stdout to
    ``out_path`` (the native engines write to its file descriptor),
    stderr dropped.  (ok, error text)."""
    err = None
    with open(out_path, "w") as out, open(os.devnull, "w") as null, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(null):
        try:
            main(argv, device=device)
        except SystemExit as e:
            err = "exit %r" % (e.code,)
        except Exception:          # a job that fails is counted, not fatal
            err = traceback.format_exc()
    return err is None, err


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def set_caches():
    """The kernel caches at fixed directories inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(HERE / "_cache" / sub)


class Solo:
    """The one rank of a cell on one card: every job is its own."""

    rank, n = 0, 1

    def go(self, want):
        return want

    def done(self, err):
        return err

    def gather(self, _key, value):
        return [value]


def run_cell(spec, name, seed, seconds, trace, device, t_start, cfg=None,
             say=print, ranks=None, work=None):
    """Run cell ``name`` and return its result object (the last line).
    ``cfg`` replaces the cell's configuration (the CPU tests' small
    sizes); ``t_start`` is the run's start on time.perf_counter
    (CLOCK_MONOTONIC, one clock for every process of the machine).
    ``ranks`` (``bench_ranks.Ranks``) runs it as one rank of several, in
    ``work``, a directory every rank sees; a rank above 0 returns None."""
    cell = spec.cell(name)
    cfg = dict(spec.config(cell) if cfg is None else cfg)
    traffic = spec.traffic(cell)
    kind = importlib.import_module("checks." + traffic["check"])
    set_caches()
    ranks = Solo() if ranks is None else ranks
    lead = ranks.rank == 0

    import torch
    from bench_data import bases, input_paths, make_inputs, write_inputs
    from bench_trace import StageRecorder, Window, breakdown, read_trace
    from checks import text_ok
    on_card = torch.device(device).type == "cuda"
    main = importlib.import_module(PORT + ".cli." + traffic["tool"]).main
    if on_card:
        importlib.import_module(PORT + "._build").lib()   # nvcc, first run
    importlib.import_module(PORT + ".native").lib()       # g++, first run
    profiling = importlib.import_module(PORT + ".utils.profiling")

    own_work = work is None
    work = tempfile.mkdtemp(prefix="portbench.") if own_work else work
    try:
        if lead:
            inputs = make_inputs(cfg, seed, traffic)
            paths = write_inputs(inputs, cfg, traffic["inputs"], work)
            work_bases = bases(inputs, traffic["work"])
        else:                                   # rank 0's files
            paths = input_paths(traffic["inputs"], work)
        argv = job_argv(traffic, dict(cfg, **paths))

        def out_path(job):
            return os.path.join(work, job + ".out") if lead else os.devnull

        recorder = (StageRecorder(profiling, torch.profiler.record_function)
                    if trace and lead else contextlib.nullcontext())
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if trace else None)
        mark = (torch.profiler.record_function if trace
                else lambda _name: contextlib.nullcontext())
        errors, ends = [], []
        returns = getattr(kind, "RETURNS", None)
        with Spy(kind.SPY if lead else None, seed, returns) as spy, \
                recorder:
            ranks.go(True)                     # the inputs are written
            _ok, err = run_job(main, argv, out_path("warm"),
                               device)                  # warm-up: set-up
            sync(device)
            err = ranks.done(err)
            if err:
                errors.append(err)
            if prof is not None:
                prof.start()
            t_first = time.perf_counter()
            with mark("window"):
                while ranks.go(not ends or ends[-1] - t_first < seconds):
                    i = len(ends)
                    spy.job_start()
                    with mark("job:" + traffic["tool"]):
                        _ok, err = run_job(main, argv,
                                           out_path("job%d" % i), device)
                        sync(device)
                    err = ranks.done(err)    # every rank has ended the job
                    ends.append(time.perf_counter())
                    spy.job_done(i)
                    if err:
                        errors.append(err)
            if prof is not None:
                prof.stop()
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        if not lead:
            ranks.put("peak", peak)
            if prof is not None:
                window_us, device_ev, _marks = read_trace(prof)
                ranks.put("busy", Window(0, 0, [], {}, window_us,
                                         device_ev).busy_s)
            return None
        peak = max(ranks.gather("peak", peak))      # the fullest card's
        span = ends[-1] - t_first
        jobs = len(ends)
        say(json.dumps({"window": {"jobs": jobs, "span_s": span,
                                   "setup_s": t_first - t_start,
                                   "job_s": [b - a for a, b in zip(
                                       [t_first] + ends, ends)]}}))
        texts = []
        for i in range(jobs):
            with open(os.path.join(work, "job%d.out" % i)) as f:
                texts.append(f.read())
        spans = ([s for s in recorder.spans if s[1] >= t_first]
                 if trace else [])
        port_out = (None if spy.kept is None
                    else kind.port_output(spy.kept) if returns is None
                    else kind.port_output(spy.kept, spy.kept_returned))
        del spy
        if prof is not None:
            window_us, device_ev, marks = read_trace(prof)
            del prof
        if on_card:
            torch.cuda.empty_cache()

        # the output check: the plain reference, after the window
        want = kind.expected(inputs, cfg, device, argv)
        numbers = (kind.numbers(port_out, texts, want) if port_out is not None
                   else dict.fromkeys(kind.LIMITS))    # no job's result seen
        failed = len(errors) + sum(not text_ok(t, want) for t in texts)
        correct = (failed == 0 and port_out is not None
                   and all(numbers[n] <= lim for n, lim in
                           kind.LIMITS.items()))
        result = {"correct": correct, "attempted": jobs, "failed": failed}
        if trace:
            win = Window(span, jobs, spans, kind.sizes(want), window_us,
                         device_ev, ranks.n)
            metrics = {}
            for m in spec.metrics("per_layer", cell):
                v = spec.reader(m["name"])(win)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            result["metrics"] = metrics
            say(json.dumps({"stages_s": win.stage_totals()}))
        else:
            rates = {m["name"]: m for m in spec.metrics("end_to_end", cell)}
            metrics = {traffic["rate"]: {
                "value": work_bases * jobs / span / 1e6,
                "unit": rates[traffic["rate"]]["unit"]},
                "setup_s": {"value": t_first - t_start, "unit": "s"}}
            result["metrics"] = metrics
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": torch.cuda.get_device_name(device) if on_card
               else "cpu",
               "count": cell["chips"], "memory_peak_bytes": peak}
        if trace:
            busy = ranks.gather("busy", win.busy_s)   # every card's
            dev["busy_s"] = None if None in busy else sum(busy) / len(busy)
            dev["window_s"] = win.window_s
        result["device"] = dev
        if trace and window_us is not None:
            result["breakdown"] = breakdown(window_us, device_ev, marks)
        result["checks"] = {n: {"value": numbers[n], "limit": lim}
                            for n, lim in kind.LIMITS.items()}
        result["checks"]["jobs_failed"] = {"value": failed, "limit": 0}
        for err in errors[:3]:
            sys.stderr.write("a job failed: %s\n" % err[-2000:])
        return result
    finally:
        if own_work:
            shutil.rmtree(work, ignore_errors=True)
