"""The share of the window the build jobs spend parsing their reads: the
host stage ``read`` (the whole-file FASTA parse of ``io/seqio.py``)."""


def read(w):
    s = w.stage_s("read")
    return None if s is None else 100.0 * s / w.span_s
