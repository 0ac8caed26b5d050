"""The overlap self-join's share of its roofline: the least time phase
1's join could take on the card (each hit row in once, each distinct
candidate pair out once: ``bench_roofline.overlap_bytes``, the rows and
pairs counted by the plain reference), once a findOverlaps pass, over
the device time of the join's kernels (``overlap_groups_kernel``,
``overlap_join_kernel``, ``overlap_dense_kernel``) in the window.  The
stable ``torch.sort`` of the rows before them is left out of the time:
its kernels are the library's and carry no name of the join's own."""

from bench_roofline import overlap_bytes, share_pct


def read(w):
    s = w.sizes
    n = overlap_bytes(s["hit_rows"], s["pairs"]) * s["passes"] * w.jobs
    return share_pct(n, w.device_s(r"overlap_(groups|join|dense)_kernel"))
