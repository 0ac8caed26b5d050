"""The port's own records of a traced run's jobs
(``modimizer_tpu_torch.utils.profiling.jobs()``: each job's spans, with
their parents, and its counters).

A job records when a ``torch.profiler`` is active at its start.  The
traced run starts its profiler after the warm-up, so the last ``w.jobs``
records are the window's jobs.  A port that keeps no such records, or
fewer of them, gives None, and the metric is left out."""

import importlib

PORT = "modimizer_tpu_torch"


def window_jobs(w):
    """The window's job records, oldest first; None if the port has none
    for every job of the window."""
    try:
        profiling = importlib.import_module(PORT + ".utils.profiling")
    except ImportError:
        return None
    jobs = getattr(profiling, "jobs", None)
    got = jobs() if jobs is not None else []
    if not w.jobs or len(got) < w.jobs:
        return None
    return got[-w.jobs:]


def span_s(records, *names):
    """Seconds spent in the spans named ``names``; None if none ran."""
    got = [s.end_ns - s.start_ns for r in records for s in r.spans
           if s.name in names]
    return sum(got) / 1e9 if got else None


def root_self_s(records):
    """Seconds of the jobs' root spans (``spans[0]``) that none of their
    children (``parent == 0``) covers."""
    total = 0
    for r in records:
        root = r.spans[0]
        at = root.start_ns
        covered = 0
        for s, e in sorted((c.start_ns, c.end_ns) for c in r.spans[1:]
                           if c.parent == 0):
            s, e = max(s, at), min(e, root.end_ns)
            if e > s:
                covered += e - s
                at = e
        total += root.end_ns - root.start_ns - covered
    return total / 1e9


def counter(records, name):
    """The sum of the jobs' counter ``name``; None if no job kept it."""
    got = [r.counters[name] for r in records if name in r.counters]
    return sum(got) if got else None
