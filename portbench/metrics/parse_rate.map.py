"""The parser's rate in the mapping jobs: the bases it parsed (the
counter ``parse.bases``, ``io/seqio.read_seq_file``) over the seconds of
the spans ``ref.parse`` and ``map.parse``, in Mbp/s, from the program's
own records."""

from bench_spans import counter, span_s, window_jobs

SPANS = ("ref.parse", "map.parse")


def read(w):
    jobs = window_jobs(w)
    if jobs is None:
        return None
    bases, s = counter(jobs, "parse.bases"), span_s(jobs, *SPANS)
    return None if bases is None or not s else bases / s / 1e6
