"""die/warn with the reference's exact semantics (utils.c:21-43): both
print to stderr and exit(-1).  Library code uses these too — the
reference's modset.c:58 die()s from inside the probe-table insert, so
faithful ports must terminate identically, not raise."""

import sys


def die(fmt, *args):
    sys.stderr.write("FATAL ERROR: " + (fmt % args if args else fmt) + "\n")
    sys.exit(255)  # C exit(-1)


def warn(fmt, *args):
    # NB reference warn() also exits (utils.c:32-43)
    sys.stderr.write("WARNING: " + (fmt % args if args else fmt) + "\n")
    sys.exit(255)


class ModsetOverflowError(RuntimeError):
    """Probe-table overflow (modset.c:58).  The library RAISES so
    embedders (long-running builders) can checkpoint/retry; the CLI layer
    converts it to the reference's die() — exact message, exit -1 —
    via cli.common.cli_guard."""
