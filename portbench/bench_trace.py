"""The traced run's readings: the program's stage spans, the card's
intervals from ``torch.profiler``, and the window they are read over.

The port times its host stages with ``utils.profiling.stage``; in a traced
run the harness puts a recorder in its place that keeps each span (name,
start, end on the host clock) and marks it in the profiler's trace, so
that an idle gap of the card can be named by the stage the host was in.
The card's busy time is the union of its kernel, copy and set intervals
(the port's smoke run's ``device_busy``); the host-side rows that launched
them carry the same time again and are not counted."""

import re
import time
from contextlib import contextmanager

MARK = re.compile(r"^(stage:|job:|window$)")


class StageRecorder:
    """Stands in for ``profiling.stage`` while installed."""

    def __init__(self, profiling, record_function):
        self.spans = []
        self._profiling = profiling
        self._orig = profiling.stage
        self._record = record_function

    @contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            with self._record("stage:" + name):
                yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def __enter__(self):
        self._profiling.stage = self.stage
        return self

    def __exit__(self, *exc):
        self._profiling.stage = self._orig


def union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name):
    """A kernel's name without its return type, namespace and arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return name.split("(")[0][:80]


class Window:
    """What a per-layer metric reads: the window's span on the host clock
    and on the trace's, the card's busy seconds, the jobs run, the stage
    spans and device events inside it, and one job's work counts."""

    def __init__(self, span_s, jobs, spans, sizes, window_us=None,
                 device=()):
        self.span_s = span_s
        self.jobs = jobs
        self.spans = spans
        self.sizes = sizes
        self.window_s = (None if window_us is None
                         else (window_us[1] - window_us[0]) / 1e6)
        self.device = list(device)
        busy = union((s, e) for _n, s, e in self.device)
        self.busy_s = (sum(e - s for s, e in busy) / 1e6 if window_us
                       else None)

    def stage_totals(self):
        """{stage: seconds in the window}."""
        out = {}
        for n, s, e in self.spans:
            out[n] = out.get(n, 0.0) + e - s
        return dict(sorted(out.items()))

    def stage_s(self, *names):
        """Seconds spent in the named stages in the window; None if none
        ran."""
        got = [e - s for n, s, e in self.spans if n in names]
        return sum(got) if got else None

    def device_s(self, pattern):
        """Device seconds of the events whose name matches; None if none
        ran."""
        got = [e - s for n, s, e in self.device if re.search(pattern, n)]
        return sum(got) / 1e6 if got else None


def read_trace(prof):
    """(window interval, device events, stage marks) from a profiler run
    that marked the window with record_function("window"): times in
    microseconds on the trace's clock."""
    from torch.autograd import DeviceType
    window, device, marks = None, [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the trace mirrors each host mark onto the card's timeline
            if not MARK.match(e.name):
                device.append((e.name or "(unnamed)", s, t))
        elif e.name == "window":
            window = (s, t)
        elif e.name.startswith("stage:"):
            marks.append((e.name[6:], s, t))
        elif e.name.startswith("job:"):
            marks.append(("outside stages, in " + e.name[4:], s, t))
    if window is None:
        return None, [], []
    lo, hi = window
    device = [(n, max(s, lo), min(t, hi)) for n, s, t in device
              if t > lo and s < hi]
    return window, device, [m for m in marks if m[2] > lo and m[1] < hi]


def breakdown(window_us, device, marks, top=10):
    """The device operations that took most time, and the longest idle
    gaps of the card, each named by the innermost stage the host was in
    at its middle, else by the job it fell in, else "unknown" (between
    jobs): {"device_ops": [[name, s], ...],
    "idle_gaps": [[name, s], ...]}."""
    by_name = {}
    for n, s, e in device:
        k = short_name(n)
        by_name[k] = by_name.get(k, 0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, at = [], window_us[0]
    for s, e in union((s, e) for _n, s, e in device) + [[window_us[1]] * 2]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inside = [m for m in marks if m[1] <= mid <= m[2]]
        name = max(inside, key=lambda m: m[1])[0] if inside else "unknown"
        named.append([name, (g1 - g0) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
