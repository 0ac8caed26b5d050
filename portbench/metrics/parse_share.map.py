"""The share of the window the mapping jobs spend parsing the reference
and the queries: the host stages ``ref.parse`` and ``map.parse``
(``io/seqio.py``)."""


def read(w):
    s = w.stage_s("ref.parse", "map.parse")
    return None if s is None else 100.0 * s / w.span_s
