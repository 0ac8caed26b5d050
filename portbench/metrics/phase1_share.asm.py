"""The share of the window the assembly jobs spend in findOverlaps'
phase 1 on the card: the span ``asm.phase1`` (``cli/modasm.py``), which
holds ``overlaps.prep`` (the host's preparation of the hit rows),
``overlaps.device`` (the upload, the self-join, the download) and
``overlaps.order`` (the candidates' order), from the program's own
records.  A job whose phase 1 took the host walk has no such span."""

from bench_spans import span_s, window_jobs


def read(w):
    jobs = window_jobs(w)
    s = None if jobs is None else span_s(jobs, "asm.phase1")
    return None if s is None else 100.0 * s / w.span_s
