"""Cumulative allocation accounting for the rusage lines.

The reference counts every byte through its malloc wrappers and prints the
running total in the ``memory`` column after each ordered command
(utils.c:59-75, 176-204).  Python has no free per-byte hook, so the
framework counts at its allocation choke points instead: sequence batches,
modset/readset arrays, scan outputs — the same structures the reference's
counter is dominated by.  The number is machine-dependent on both sides
(golden tests mask the line); what matters is the UX: a nonzero, monotone
cumulative byte count per command.
"""

_total = 0


def add(nbytes: int) -> None:
    global _total
    _total += int(nbytes)


def track(arr):
    """Count a numpy array's payload; returns the array for chaining."""
    add(arr.nbytes)
    return arr


def total() -> int:
    return _total
