"""Per-stage profiling for the device pipelines (the port's copy of
``modimizer_tpu/utils/profiling.py``, tracing with ``torch.profiler``).

Two layers, both default-off so the hot paths stay clean:

- MODIMIZER_STAGES=1: lightweight wall-clock stage accumulators printed to
  stderr at process exit (and on demand via report()).  Stages are nested
  ("scan.pack", "scan.drain", ...); each records total seconds and count.
- MODIMIZER_TRACE=<dir>: wraps the FIRST top-level pipeline call in a
  ``torch.profiler`` trace of the host and the card, written to <dir> as a
  Chrome trace (open it in Perfetto or chrome://tracing).
"""

import atexit
import os
import time
from contextlib import contextmanager

_stages = {}
_enabled = os.environ.get("MODIMIZER_STAGES") == "1"
_trace_dir = os.environ.get("MODIMIZER_TRACE")
_trace_active = [False]
_printed = [False]


def enabled() -> bool:
    return _enabled


@contextmanager
def stage(name):
    """Accumulate wall time under `name` (no-op unless MODIMIZER_STAGES=1)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        tot, cnt = _stages.get(name, (0.0, 0))
        _stages[name] = (tot + dt, cnt + 1)


@contextmanager
def trace_region():
    """torch.profiler trace around a top-level pipeline call (first call
    only, no-op unless MODIMIZER_TRACE=<dir>)."""
    if not _trace_dir or _trace_active[0]:
        yield
        return
    import torch
    _trace_active[0] = True
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(_trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        _trace_dir, "modimizer_trace.%d.json" % os.getpid()))


def report(f=None):
    if not _stages:
        return
    import sys
    f = f or sys.stderr
    f.write("── stage timers (MODIMIZER_STAGES) ──\n")
    for name in sorted(_stages):
        tot, cnt = _stages[name]
        f.write("  %-24s %8.3f s  x%d\n" % (name, tot, cnt))
    f.flush()


def _exit_report():
    if _enabled and not _printed[0]:
        _printed[0] = True
        report()


atexit.register(_exit_report)
