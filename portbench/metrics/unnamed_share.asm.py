"""The share of the window the assembly jobs spend in no named span: the
self time of their root spans (``modasm``: the ``-m`` read of the
modset and the readset's native assembly of hits, counts and inverse
lists, which have no span of their own), from the program's own records
(``bench_spans``)."""

from bench_spans import root_self_s, window_jobs


def read(w):
    jobs = window_jobs(w)
    return None if jobs is None else 100.0 * root_self_s(jobs) / w.span_s
