r"""route_rows at the mesh paths' shapes, timed on the card beside an earlier
version of its kernel and the PyTorch route.

  merge     the sharded merge's rows at world size 1 (17,779,074: the
            200,000-read modset's 11,765,322 entries and the 100,000-read
            one's 6,013,752), merge mode, at n = 1, 2, 4 and 8 owners
  builder   one chunk of the routed builder: ``scan_compact``'s rows of
            2^22 positions (k16 w16, positions as meta), builder mode, n = 1,
            the builder's cap
  lookup    the mesh table's queries at config 3 (967,742), lookup mode,
            n = 1, cap = the queries

The merge rows are uniform random k16 k-mers (numpy ``default_rng``), none
a sentinel, as the modsets' are; the lookup queries half k-mers of a
config-3-sized key set, half random, the last all ones; the builder chunk
is ``probe_scan_compact``'s input.  cap is the fullest owner's rows in
merge mode (nothing overflows, nothing is dropped).  ``--baseline SRC.cu``
compiles SRC as it stands (nvcc with the port's flags) into a library of
its own in ``SRC``'s directory, ``_build/``, and calls its
``mz_route_rows`` through the interface the kernel had before it kept a
scratch of tiles: (kmers, pos, base, N, mode, factor1, shift, w, n, cap,
segments, tally, index, counts, overflow, send_k, send_p, stream), with a
tally of n ints a segment of 1,024 rows.  For example the source at an
earlier commit::

    git show REV:modimizer_tpu_torch/csrc/route.cu > old/route.cu
    python -m modimizer_tpu_torch.probes.probe_route --baseline old/route.cu

Each version is held against ``route_rows_ref``, bit for bit; then they are
timed in turns (baseline, current, library, library, current, baseline),
CUDA events with the launches queued behind a sleep.  "library" is the
route with PyTorch calls (``library_route``: the owners, a stable
``torch.sort`` of the owner keys, ``searchsorted``, a gather).  One JSON
line per shape and n: each time, the bound (the rows read once: 8 B of
k-mer, 4 B of position in builder mode; the n*cap slots written once: a 4 B
index, 16 B more in builder mode), the current kernel's share of it and its
speed-up over the baseline.  A disagreement exits non-zero.
"""

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from .. import _build
from ..core.seqhash import Seqhash
from ..ops.route import MODES, owners, route_rows, route_rows_ref
from ..ops.scan_kernel import scan_compact
from ..parallel.sharded import ShardedModsetBuilder
from . import SEED, resolve_device
from . import probe_lookup
from . import probe_scan_compact as psc
from ._timing import bound_ms, card_line, same, time_ms

MERGE_ROWS = 11_765_322 + 6_013_752
LOOKUP_QUERIES = probe_lookup.SHAPES["config3"][1] + 1
# name: (mode, owner counts)
SHAPES = {"merge": ("merge", (1, 2, 4, 8)), "builder": ("builder", (1,)),
          "lookup": ("lookup", (1,))}
OLD_SEG = 1024          # rows a segment of the earlier kernel's tally
SMALL_ROWS = 1 << 15


def shape_rows(name, small, device):
    """(k-mers, positions or None, chunk base, Seqhash, the cap of the
    builder's chunk or None): the rows of shape ``name``."""
    rng = np.random.default_rng(SEED)
    sh = Seqhash.create(16, 16, SEED)
    if name == "merge":
        n = SMALL_ROWS if small else MERGE_ROWS
        km = rng.integers(0, 1 << 32, n, dtype=np.int64)
        return torch.from_numpy(km).to(device), None, 0, sh, None
    if name == "lookup":
        n_keys, nq = ((5_000, SMALL_ROWS) if small
                      else (probe_lookup.SHAPES["config3"][0],
                            LOOKUP_QUERIES))
        _keys, _vals, q = probe_lookup.lookup_inputs(rng, n_keys, nq, device)
        return q, None, 0, sh, None
    C = 1 << (15 if small else 22)
    sw, vb, args = psc.shape_inputs("builder", C, device)
    ck, cp, _cnt, _n, _ovf = scan_compact(sw, vb, **args)
    cap = ShardedModsetBuilder(sh, device, chunk_per_dev=C,
                               state_size=16).cap
    return ck, cp, 5 << 33, sh, cap


def library_route(kmers, n, cap, mode, pos=None, base=0, **hkw):
    """The JAX route with PyTorch calls: each row's owner (a sentinel row
    keyed n, last, unless in lookup mode), a stable ``torch.sort`` of the
    keys, the owners' group bounds by ``searchsorted``, and the gather of
    each owner's first cap rows; in builder mode also the k-mer and position
    columns gathered through the index."""
    key = owners(kmers, n, mode, **hkw)
    if mode != "lookup":
        key = torch.where(kmers != -1, key, n)
    sk, order = torch.sort(key, stable=True)
    ar = torch.arange(n, device=kmers.device)
    starts = torch.searchsorted(sk, ar)
    ends = torch.searchsorted(sk, ar, right=True)
    j = torch.arange(n * cap, device=kmers.device)
    idx = starts[j // cap] + j % cap
    live = idx < ends[j // cap]
    index = torch.where(live, order[idx.clamp(max=max(kmers.numel() - 1,
                                                      0))], -1).to(torch.int32)
    if mode != "builder":
        return (index,)
    src = index.clamp(min=0)
    return (index, torch.where(live, kmers[src], -1),
            torch.where(live, (pos[src].to(torch.int64) & 0xFFFFFFFF)
                        + base, -1))


def load_baseline(src):
    """Build ``src`` into its own library and declare the earlier
    interface of ``mz_route_rows``."""
    L = _build.build_aside(src)
    p, i32, i64, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_uint64)
    L.mz_route_rows.restype = i32
    L.mz_route_rows.argtypes = [p, p, u64, i64, i32, u64, i32, u64, i32, i32,
                                i32, p, p, p, p, p, p, p]
    return L


def baseline_route(L, kmers, n, cap, mode, pos=None, base=0, k=0, w=1,
                   factor1=0):
    """The earlier kernel, with its tally scratch and outputs allocated as
    its wrapper did."""
    dev, N = kmers.device, kmers.numel()
    nseg = max(1, -(-N // OLD_SEG))
    tally = torch.empty(n * nseg, dtype=torch.int32, device=dev)
    index = torch.empty(n * cap, dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    send_k = send_p = None
    if mode == "builder":
        send_k = torch.empty(n * cap, dtype=torch.int64, device=dev)
        send_p = torch.empty(n * cap, dtype=torch.int64, device=dev)
    shift = 0 if mode == "merge" else 64 - 2 * k
    if mode == "merge":
        w, factor1 = 1, 0
    rc = L.mz_route_rows(
        kmers.data_ptr(), None if pos is None else pos.data_ptr(),
        ctypes.c_uint64(base), N, MODES[mode], ctypes.c_uint64(factor1),
        shift, ctypes.c_uint64(w), n, cap, nseg, tally.data_ptr(),
        index.data_ptr(), counts.data_ptr(), overflow.data_ptr(),
        None if send_k is None else send_k.data_ptr(),
        None if send_p is None else send_p.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError("baseline route_rows: CUDA error %d" % rc)
    return index, counts, overflow, send_k, send_p


def route_bytes(N, n, cap, mode):
    """Bytes read once and written once: the rows (8 B, +4 B of position in
    builder mode), n*cap slots (a 4 B index, +16 B in builder mode) and the
    counts."""
    builder = mode == "builder"
    return N * (12 if builder else 8) + n * cap * (20 if builder else 4) \
        + 4 * n


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_route",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(SHAPES))
    ap.add_argument("--baseline", metavar="SRC.cu",
                    help="an earlier route.cu to time beside")
    ap.add_argument("--small", action="store_true",
                    help="2^15 rows (2^15 positions for builder)")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    for name in a.names:
        if name not in SHAPES:
            raise SystemExit("probe_route: unknown shape %r; shapes: %s"
                             % (name, ",".join(SHAPES)))
    dev = resolve_device(device)
    if a.baseline and dev.type != "cuda":
        raise SystemExit("probe_route: --baseline needs the card")
    L = load_baseline(a.baseline) if a.baseline else None
    ok = True
    for name in a.names:
        mode, ns = SHAPES[name]
        km, pos, base, sh, bcap = shape_rows(name, a.small, dev)
        N = km.numel()
        hkw = {} if mode == "merge" else dict(k=sh.k, w=sh.w,
                                              factor1=sh.factor1)
        for n in ns:
            if bcap is not None:
                cap = bcap
            elif mode == "lookup":
                cap = max(1, N)
            else:
                cap = max(1, int(torch.bincount(owners(km, n, mode, **hkw),
                                                minlength=n).max()))
            args = dict(hkw, pos=pos, base=base) if mode == "builder" \
                else hkw
            want = route_rows_ref(km, n, cap, mode, **args)
            fns = {"current": lambda: route_rows(km, n, cap, mode, **args)}
            if L is not None:
                fns["baseline"] = lambda: baseline_route(L, km, n, cap, mode,
                                                         **args)
            checks = {who: same(tuple(fn()), tuple(want))
                      for who, fn in fns.items()}
            fns["library"] = lambda: library_route(km, n, cap, mode, **args)
            cols = (want.index, want.send_k, want.send_p)
            checks["library"] = same(fns["library"](),
                                     cols if mode == "builder" else cols[:1])
            ok &= all(checks.values())
            line = {"probe": "probe_route", "shape": name, "mode": mode,
                    "rows": N, "n": n, "cap": cap,
                    "check": {who: "match" if c else "DIFF"
                              for who, c in checks.items()}}
            if dev.type == "cuda":
                order = ["current", "library", "library", "current"]
                if L is not None:
                    order = ["baseline"] + order + ["baseline"]
                times = {who: [] for who in fns}
                for who in order:
                    times[who].append(time_ms(fns[who])[0])
                b_ms, b_by = bound_ms(route_bytes(N, n, cap, mode))
                cur = min(times["current"])
                line.update(ms=times, bound_ms=b_ms, bound_by=b_by,
                            bound_share=b_ms / cur,
                            library="owners, stable torch.sort of the "
                            "owner keys, searchsorted, gather",
                            device=torch.cuda.get_device_name(dev),
                            card=card_line())
                if L is not None:
                    line["speedup"] = min(times["baseline"]) / cur
            else:
                line.update(ms=None, device="cpu", card=None)
            print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
