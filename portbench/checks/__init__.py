"""The comparisons that decide ``correct``, one module a kind of job
(a traffic file names its kind).  Each module gives:

- ``SPY``: (module, function, argument) of the port whose argument the
  harness keeps for one job of the window, drawn from the seed (the
  object that holds the job's result);
- ``RETURNS`` (where the module has it): (module, qualified name) of a
  second function of the port, whose return values in the kept job, call
  by call, the harness keeps too;
- ``port_output(kept)``, or ``port_output(kept, returned)`` with
  ``RETURNS``: numpy copies of what is compared;
- ``expected(inputs, cfg, device, argv, kmer_bits)``: the plain
  reference's result for the job's inputs and argv (``kmer_bits`` 32: the
  control);
- ``as_port(want)``: a reference result in the form ``port_output`` gives,
  so that the control can stand in the program's place;
- ``LIMITS`` and ``numbers(port, texts, want)``: each number compared,
  with its limit, from the kept job's output, every job's stdout and the
  reference (whose "lines" are what each job must print);
- ``sizes(want)``: the job's work counts that the per-layer metrics use.

Nothing here imports JAX, the JAX package or the port.
"""

import re

_TIMING = re.compile(r"^(user\t|total resources used: )")


def text_lines(text):
    """A job's stdout as lines, the resource-usage lines left out (their
    numbers are the machine's)."""
    return [s for s in text.split("\n") if s and not _TIMING.match(s)]


def text_ok(text, want):
    """A job's stdout is the reference's lines."""
    return text_lines(text) == want["lines"]


def lines_wrong(got, want):
    """Lines of ``got`` that differ from ``want`` at the same place, plus
    the lines one has beyond the other."""
    n = min(len(got), len(want))
    return sum(a != b for a, b in zip(got[:n], want[:n])) + abs(len(got)
                                                               - len(want))


def rows_wrong(got, want):
    """Rows (aligned arrays, one a column) that differ, plus the rows
    one table has beyond the other."""
    n = min(len(got[0]), len(want[0]))
    bad = 0
    if n:
        diff = False
        for a, b in zip(got, want):     # k-mers < 2^62: int64 is exact
            diff = diff | (a[:n].astype("int64") != b[:n].astype("int64"))
        bad = int(diff.sum())
    return bad + abs(len(got[0]) - len(want[0]))
