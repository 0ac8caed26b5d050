"""Per-command resource reporting, mirroring the reference's timeUpdate/timeTotal.

The reference prints, after every ordered CLI command and at exit, a line
``user\t<u>\tsystem\t<s>\tmax_RSS\t<d>\tmemory\t<m>`` from getrusage deltas
(reference utils.c:176-204).  We keep the exact format so downstream log
parsers work; the numbers themselves are inherently machine-dependent.

The ``memory`` column is the reference's cumulative-allocation counter
(its malloc wrappers count every byte, utils.c:59-75; timeUpdate prints the
RUNNING TOTAL, not a delta).  The framework counts its own allocation choke
points through utils.alloc by default; set MODIMIZER_MEMORY=1 to use
tracemalloc instead (every interpreter allocation, ~2x overhead).
"""

import os
import resource

from . import alloc


class Timer:
    def __init__(self):
        self._first = None
        self._old = None
        self._trace = os.environ.get("MODIMIZER_MEMORY") == "1"
        if self._trace:
            import tracemalloc
            tracemalloc.start()
        self._trace_hwm = 0

    def _allocated(self):
        """Cumulative allocation counter for the memory column
        (utils.c:59-75 semantics: a RUNNING TOTAL that only grows).
        Default: the framework's own allocation-choke-point counters.
        MODIMIZER_MEMORY=1 swaps in tracemalloc for full Python coverage;
        its current-footprint gauge shrinks on frees, so track its
        high-water mark to keep the column monotone like the reference's."""
        if not self._trace:
            return alloc.total()
        import tracemalloc
        self._trace_hwm = max(self._trace_hwm,
                              tracemalloc.get_traced_memory()[0])
        return self._trace_hwm

    @staticmethod
    def _usage():
        return resource.getrusage(resource.RUSAGE_SELF)

    def update(self, f):
        """Print usage since last call (first call just initialises)."""
        new = self._usage()
        if self._old is not None:
            # the reference prints the RUNNING TOTAL (utils.c:195)
            self._print_delta(f, self._old, new, self._allocated())
        else:
            self._first = new
        self._old = new

    def total(self, f):
        """Print usage since the first update() call."""
        if self._first is None:
            return
        self._old = self._first
        self.update(f)

    @staticmethod
    def _print_delta(f, old, new, alloc=0):
        def split(delta):
            secs = int(delta)
            usecs = int(round((delta - secs) * 1e6))
            if usecs < 0:
                usecs += 1000000
                secs -= 1
            return secs, usecs

        us, uu = split(new.ru_utime - old.ru_utime)
        ss, su = split(new.ru_stime - old.ru_stime)
        f.write("user\t%d.%06d" % (us, uu))
        f.write("\tsystem\t%d.%06d" % (ss, su))
        f.write("\tmax_RSS\t%d" % (new.ru_maxrss - old.ru_maxrss))
        f.write("\tmemory\t%d" % alloc)  # cumulative bytes (utils.c:195)
        f.write("\n")
