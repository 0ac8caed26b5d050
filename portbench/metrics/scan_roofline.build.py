"""The scan's share of its roofline: the least time the jobs' scans could
take on the card (each base in once as 2 bits, each emitted row out once,
``bench_roofline.scan_bytes``) over the device time of the scan kernels
(``scan_compact`` and ``densify``'s two kernels) in the window."""

from bench_roofline import scan_bytes, share_pct


def read(w):
    n = scan_bytes(w.sizes["scan_bases"], w.sizes["scan_rows"]) * w.jobs
    return share_pct(n, w.device_s(r"scan_compact|densify"))
