"""The yardstick of the rooflines: the card's published peak and the
bytes each layer's work must move, read once and written once, counted
from the jobs' sizes as the plain reference works them out (never from
what a kernel happens to allocate or read again).

The arithmetic follows the port's probes (``probes/_timing.bound_ms``,
``probe_scan_compact.scan_compact_bytes``, ``probe_lookup.lookup_bytes``,
``probe_route.route_bytes``), copied here so that a change to the program
cannot move the yardstick."""

# NVIDIA H100 SXM, published: 3.35 TB/s of HBM3 at the full 700 W limit
HBM_BYTES_S = 3.35e12


def scan_bytes(bases, rows):
    """The scan: each base in once as 2 bits, each emitted row out once
    as its 8-byte k-mer and its 4-byte position."""
    return bases / 4 + rows * 12


def lookup_bytes(keys, queries, hits):
    """The table lookup: the sorted 8-byte keys and the 8-byte queries in
    once, a 4-byte answer out a query, and the 4-byte id of each hit."""
    return keys * 8 + queries * 12 + hits * 4


def route_bytes(N, n, cap, mode):
    """The routing of N rows to n owners of ``cap`` slots each
    (``route_rows``): the rows in once (8 bytes, +4 of position in builder
    mode), the n*cap slots out once (a 4-byte index, +16 bytes of k-mer
    and position in builder mode) and the n counts."""
    builder = mode == "builder"
    return N * (12 if builder else 8) + n * cap * (20 if builder else 4) \
        + 4 * n


def share_pct(n_bytes, device_s):
    """The least time the bytes take at the peak, as a percentage of the
    device time the kernels took; None where no kernel ran."""
    if not device_s:
        return None
    return 100.0 * n_bytes / HBM_BYTES_S / device_s
