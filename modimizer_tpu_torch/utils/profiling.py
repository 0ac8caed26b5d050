"""Spans and counters of the port's jobs: one recorder, off by default.

Each CLI's ``run``/``main`` (``cli.common.cli_guard``) is one job: a root
span named after the CLI (``modutils``, ``modmap``, ...) with the next job
id.  Inside it:

- ``span(name)``: a timed block, recorded as (name, parent, job id,
  thread, start_ns, end_ns) on ``time.perf_counter_ns``; the parent is the
  innermost span open on the same thread (the root on a thread with none
  open).  A span's self time is its duration less the union of its
  children's intervals.
- ``count(name, n)``: adds ``n`` to the job's counter ``name`` where the
  work happens (``parse.bases``, ``scan.rows``, ``lookup.queries``,
  ``lookup.hits``).  A job also keeps the kernels' launches it made
  (``_build.LAUNCHES``'s difference) as ``launch.<kernel>``.

``jobs()`` returns each finished job's record (``Job``): its spans and
counters, and one anchor pair ``(time.time_ns(), time.perf_counter_ns())``
taken at its start, through which ``Job.clock_ns`` puts its spans on the
clock ``torch.profiler`` stamps its events with (CLOCK_REALTIME).

A job records when, at its start, ``MODIMIZER_STAGES=1`` or
``MODIMIZER_TRACE=<dir>`` is set or a ``torch.profiler`` is active.
Otherwise ``span`` and ``count`` record nothing and cost a flag test.

- ``MODIMIZER_STAGES=1``: at exit, per name the calls, total and self
  seconds of every recorded job, then the counters, on stderr.
- ``MODIMIZER_TRACE=<dir>``: each job runs under ``torch.profiler`` (the
  host and, where there is one, the CUDA card) and writes one Chrome trace,
  ``<dir>/modimizer_trace.<pid>.<job>.json``: the host and device lanes,
  each span's ``stage:<name>`` mark, the job's spans (job id and parent in
  their ``args``) and its counters, all on the file's clock.  Open it in
  Perfetto or chrome://tracing.  Under a profiler already active no file
  is written: the trace is its owner's.

While the job is profiled, each span is marked once in the trace as
``record_function("stage:<name>")``, by the hook ``stage``: ``span``
enters ``profiling.stage(name)`` as bound at that moment, and reads its
bounds inside it, so a benchmark that puts its own recorder in ``stage``'s
place sees every span, and marks it itself.  The hook goes once the
benchmark reads ``jobs()`` instead.
"""

import atexit
import contextlib
import itertools
import json
import os
import sys
import threading
import time
from contextlib import contextmanager

_jobs = []                    # finished jobs, oldest first
_current = None               # the job recording now
_marking = False              # the current job marks its spans in a trace
_ids = itertools.count(1)
_local = threading.local()    # each thread's stack of open spans
_NULL = contextlib.nullcontext()


class Span:
    __slots__ = ("name", "parent", "job", "thread", "start_ns", "end_ns")

    def __init__(self, name, parent, job, thread, start_ns):
        self.name = name
        self.parent = parent          # index in the job's spans; None: root
        self.job = job
        self.thread = thread
        self.start_ns = start_ns
        self.end_ns = None            # None while open


class Job:
    """One job's record: ``spans[0]`` is the root."""

    def __init__(self, name):
        self.id = next(_ids)
        self.name = name
        self.anchor = (time.time_ns(), time.perf_counter_ns())
        self.spans = []
        self.counters = {}
        self.lock = threading.Lock()

    def clock_ns(self, perf_ns):
        """A perf_counter_ns reading on the profiler's clock (ns since the
        epoch), through the job's anchor."""
        return self.anchor[0] + perf_ns - self.anchor[1]

    def self_ns(self):
        """Each span's duration less the union of its children's
        intervals, in the order of ``spans``."""
        kids = [[] for _ in self.spans]
        for s in self.spans:
            if s.parent is not None:
                kids[s.parent].append((s.start_ns, s.end_ns))
        return [(s.end_ns - s.start_ns) - _covered(s, k)
                for s, k in zip(self.spans, kids)]


def _covered(span, intervals):
    """The ns of ``span`` that the union of ``intervals`` covers."""
    total, at = 0, span.start_ns
    for s, e in sorted(intervals):
        s, e = max(s, at), min(e, span.end_ns)
        if e > s:
            total += e - s
            at = e
    return total


def recording() -> bool:
    """Whether the current job records: guards work done only to count."""
    return _current is not None


def span(name):
    """A timed block of the current job (see the module doc)."""
    if _current is None:
        return stage(name)
    return _recorded(name)


@contextmanager
def _recorded(name):
    rec = _current
    loc = _local
    if getattr(loc, "job", None) != rec.id:
        loc.job, loc.stack = rec.id, []
    # the bounds are read inside the mark: what the span does to set
    # itself up (an allocation, a collection the allocation sets off)
    # falls outside both, not between a bound and its mark's
    with stage(name):
        start = time.perf_counter_ns()
        s = Span(name, loc.stack[-1] if loc.stack else 0, rec.id,
                 threading.get_ident(), start)
        rec.spans.append(s)
        loc.stack.append(len(rec.spans) - 1)
        try:
            yield
        finally:
            loc.stack.pop()
            s.end_ns = time.perf_counter_ns()


def count(name, n):
    """Add ``n`` to the current job's counter ``name``."""
    rec = _current
    if rec is not None:
        with rec.lock:
            rec.counters[name] = rec.counters.get(name, 0) + int(n)


def stage(name):
    """The hook that marks a span in the trace: ``record_function(
    "stage:<name>")`` while the current job is profiled, else nothing."""
    if _marking:
        return sys.modules["torch"].profiler.record_function("stage:" + name)
    return _NULL


@contextmanager
def job(name):
    """One job, the root span ``name``; inside a recording job, a span of
    it."""
    global _current, _marking
    if _current is not None:
        with span(name):
            yield
        return
    torch = sys.modules.get("torch")
    profiled = torch is not None and torch._C._autograd._profiler_enabled()
    trace_dir = os.environ.get("MODIMIZER_TRACE")
    if not (profiled or trace_dir
            or os.environ.get("MODIMIZER_STAGES") == "1"):
        with stage(name):
            yield
        return
    prof = None if profiled or not trace_dir else _start_profiler()
    from .. import _build
    launches = dict(_build.LAUNCHES)
    rec = Job(name)
    _current, _marking = rec, profiled or prof is not None
    _local.job, _local.stack = rec.id, [0]
    try:
        with stage(name):
            start = time.perf_counter_ns()
            root = Span(name, None, rec.id, threading.get_ident(), start)
            rec.spans.append(root)
            try:
                yield
            finally:
                root.end_ns = time.perf_counter_ns()
    finally:
        _current, _marking = None, False
        for k, n in _build.LAUNCHES.items():
            if n != launches.get(k, 0):
                rec.counters["launch." + k] = n - launches.get(k, 0)
        _jobs.append(rec)
        if prof is not None:
            prof.stop()
            _write_trace(prof, rec, trace_dir)


def _start_profiler():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _write_trace(prof, rec, trace_dir):
    """The profiler's Chrome trace of ``rec`` with its spans and counters
    added on the file's clock (µs past ``baseTimeNanoseconds``)."""
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "modimizer_trace.%d.%d.json"
                        % (os.getpid(), rec.id))
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)

    def us(ns):
        return (rec.clock_ns(ns) - base) / 1e3

    events = trace.setdefault("traceEvents", [])
    for i, s in enumerate(rec.spans):
        events.append({"ph": "X", "cat": "span", "name": s.name,
                       "pid": "modimizer spans", "tid": "thread %d"
                       % s.thread, "ts": us(s.start_ns),
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"job": rec.id, "span": i,
                                "parent": s.parent}})
    end = us(rec.spans[0].end_ns)
    for name, n in sorted(rec.counters.items()):
        events.append({"ph": "C", "name": name, "pid": "modimizer spans",
                       "ts": end, "args": {"value": n}})
    with open(path, "w") as f:
        json.dump(trace, f)


def jobs():
    """The finished jobs' records, oldest first."""
    return list(_jobs)


def totals(records):
    """({name: [calls, total s, self s]}, {counter: sum}) over ``records``
    (``Job``s)."""
    by_name, counters = {}, {}
    for rec in records:
        for s, own in zip(rec.spans, rec.self_ns()):
            t = by_name.setdefault(s.name, [0, 0.0, 0.0])
            t[0] += 1
            t[1] += (s.end_ns - s.start_ns) / 1e9
            t[2] += own / 1e9
        for k, n in rec.counters.items():
            counters[k] = counters.get(k, 0) + n
    return dict(sorted(by_name.items())), dict(sorted(counters.items()))


def report(f=None):
    """The ``MODIMIZER_STAGES`` report of every finished job."""
    by_name, counters = totals(_jobs)
    if not by_name:
        return
    f = f or sys.stderr
    f.write("── stage timers (MODIMIZER_STAGES) ──\n")
    for name, (calls, tot, own) in by_name.items():
        f.write("  %-24s %8.3f s  x%-6d self %8.3f s\n"
                % (name, tot, calls, own))
    for name, n in counters.items():
        f.write("  %-24s %12d\n" % (name, n))
    f.flush()


def _exit_report():
    if os.environ.get("MODIMIZER_STAGES") == "1":
        report()


atexit.register(_exit_report)
