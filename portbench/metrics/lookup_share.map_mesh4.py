"""The share of the window rank 0's mapping jobs spend in the span
``map.lookup`` (``cli/modmap.py``): on the mesh the device table's build
(``map.table``: each rank keeps the k-mers it owns), then the lookup of
``parallel/lookup.py``'s ``DeviceTable.find``: a quarter of the queries
routed by ``route_rows``, the first exchange, ``find_sorted`` on the
rank's shard, the exchange back, the gather of every answer and its
download.  From the program's own records (``bench_spans``)."""

from bench_spans import span_s, window_jobs


def read(w):
    jobs = window_jobs(w)
    s = None if jobs is None else span_s(jobs, "map.lookup")
    return None if s is None else 100.0 * s / w.span_s
