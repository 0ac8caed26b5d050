"""The share of the window the assembly jobs spend building the readset:
the spans ``rs.parse`` (the FASTA parse), ``rs.scan`` (the scanner on
the card) and ``rs.lookup`` (the modset's lookup of every modimizer) of
``core/readset.py``, from the program's own records."""

from bench_spans import span_s, window_jobs


def read(w):
    jobs = window_jobs(w)
    s = None if jobs is None else span_s(jobs, "rs.parse", "rs.scan",
                                         "rs.lookup")
    return None if s is None else 100.0 * s / w.span_s
