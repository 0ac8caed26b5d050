"""The table lookup's share of its roofline: the least time the jobs'
lookups could take (the sorted keys and the queries in once, an answer
out a query, the id of each hit: ``bench_roofline.lookup_bytes``) over
the device time of ``find_sorted`` in the window."""

from bench_roofline import lookup_bytes, share_pct


def read(w):
    s = w.sizes
    n = lookup_bytes(s["keys"], s["queries"], s["hits"]) * w.jobs
    return share_pct(n, w.device_s(r"find_sorted"))
