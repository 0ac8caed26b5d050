"""The share of the window the build jobs spend in no named span: the
self time of their root spans (``modutils``: what ran between the
program's spans), from the program's own records (``bench_spans``)."""

from bench_spans import root_self_s, window_jobs


def read(w):
    jobs = window_jobs(w)
    return None if jobs is None else 100.0 * root_self_s(jobs) / w.span_s
