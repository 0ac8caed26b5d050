"""The routing's share of its roofline on rank 0: the least time rank 0's
``route_rows`` calls could take (lookup mode: its ceil(queries / ranks)
queries in once, ranks x as many slots out, the counts;
``bench_roofline.route_bytes``, from the job's query count as the
reference works it out) over the device time of ``route_tiles`` and
``route_pad`` on card 0 in the window."""

from bench_roofline import route_bytes, share_pct


def read(w):
    cap = -(-w.sizes["queries"] // w.ranks)
    n = route_bytes(cap, w.ranks, cap, "lookup") * w.jobs
    return share_pct(n, w.device_s(r"route_tiles|route_pad"))
