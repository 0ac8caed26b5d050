"""The share of the traced window in which card 0 ran a collective: the
union of its NCCL kernels' intervals (names starting ``nccl``: the
all-to-alls, the gather and the all-reduces of modmap's branch checks)
over the window.  A kernel's interval holds the time card 0 waits in it
for its peers."""

from bench_trace import short_name, union


def read(w):
    got = [(s, e) for n, s, e in w.device
           if short_name(n).startswith("nccl")]
    if not got or not w.window_s:
        return None
    return 100.0 * sum(e - s for s, e in union(got)) / 1e6 / w.window_s
