"""The share of the window the assembly jobs spend in findOverlaps'
phase 2: the span ``asm.phase2``, the native ``*_pre`` engines of
``native/modasm_native.cpp`` over the candidates phase 1 found, from the
program's own records."""

from bench_spans import span_s, window_jobs


def read(w):
    jobs = window_jobs(w)
    s = None if jobs is None else span_s(jobs, "asm.phase2")
    return None if s is None else 100.0 * s / w.span_s
