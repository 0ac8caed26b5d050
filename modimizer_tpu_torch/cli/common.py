"""Ordered-command CLI framework.

The reference tools execute flags *in order* ("Commands are executed in order -
set parameters before using them!", modmap.c:287) via an ARGMATCH macro that
consumes argv (modmap.c:333).  This module reproduces that surface: ordered
matching, the ``COMMAND ...`` echo to stderr (modutils.c:125-127), per-command
resource lines, and die() semantics (exit -1 with "FATAL ERROR: ").
"""

import sys

import functools

from ..utils import profiling
from ..utils.timers import Timer
from ..utils.errors import ModsetOverflowError, die, warn  # noqa: F401


def cli_guard(main_fn):
    """Run the CLI as one job of ``utils.profiling`` (its root span is
    named after the CLI's module) and convert library ModsetOverflowError
    to the reference's die() (exact message + exit -1, utils.c:21-30) at
    the CLI boundary."""
    name = main_fn.__module__.rsplit(".", 1)[-1]

    @functools.wraps(main_fn)
    def wrapped(*args, **kwargs):
        with profiling.job(name):
            try:
                return main_fn(*args, **kwargs)
            except ModsetOverflowError as e:
                die("%s", str(e))
    return wrapped


class Args:
    """argv cursor with ARGMATCH semantics."""

    def __init__(self, argv):
        self.argv = list(argv)
        self.i = 0

    def __bool__(self):
        return self.i < len(self.argv)

    @property
    def current(self):
        return self.argv[self.i]

    def remaining(self):
        return len(self.argv) - self.i

    def match(self, short, long_, n):
        """ARGMATCH(x, y, n): if argv[0] is x or y and >= n args remain,
        consume n and return the consumed list (flag + n-1 operands)."""
        if self.i >= len(self.argv):
            return None
        a = self.argv[self.i]
        if (a == short or a == long_) and self.remaining() >= n:
            consumed = self.argv[self.i:self.i + n]
            self.i += n
            return consumed
        return None

    def take_while_not_flag(self):
        """Consume operands until the next token starting with '-'."""
        out = []
        while self.i < len(self.argv) and not self.argv[self.i].startswith("-"):
            out.append(self.argv[self.i])
            self.i += 1
        return out

    def echo_command(self):
        """stderr echo: COMMAND <flag> <args-until-next-dash>."""
        parts = [self.argv[self.i]]
        j = self.i + 1
        while j < len(self.argv) and not self.argv[j].startswith("-"):
            parts.append(self.argv[j])
            j += 1
        sys.stderr.write("COMMAND " + " ".join(parts) + "\n")


class OutFile:
    """outFile handling: '-' = stdout; reopen failures fall back to stdout."""

    def __init__(self):
        self.f = sys.stdout
        self.is_stdout = True

    def set(self, name):
        if name == "-":
            self.f = sys.stdout
            self.is_stdout = True
            return
        try:
            self.f = open(name, "w")
            self.is_stdout = False
        except OSError:
            sys.stderr.write(
                "can't open output file %s - resetting to stdout\n" % name)
            self.f = sys.stdout
            self.is_stdout = True

    def write(self, s):
        self.f.write(s)

    def flush(self):
        self.f.flush()


def finish(out: OutFile, timer: Timer):
    """Exit banner: timeTotal to outFile (and stdout if different)."""
    out.write("total resources used: ")
    timer.total(out.f)
    if not out.is_stdout:
        sys.stdout.write("total resources used: ")
        timer.total(sys.stdout)
