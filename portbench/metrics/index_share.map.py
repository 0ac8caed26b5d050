"""The share of the window the mapping jobs spend indexing the
reference on the host: the span ``ref.index`` (the modset's allocation,
the inserts of the reference's k-mers, the depths, copy numbers and the
two packs; ``core/reference.py``), from the program's own records."""

from bench_spans import span_s, window_jobs


def read(w):
    jobs = window_jobs(w)
    s = None if jobs is None else span_s(jobs, "ref.index")
    return None if s is None else 100.0 * s / w.span_s
