r"""find_sorted at modmap's config-3 shape, timed on the card beside earlier
or other versions of its kernel and the PyTorch route.

  config3   2,078,844 keys (GRCh38 chr20's 64,444,167 bp / w 31), 967,741
            queries (3,000 reads of 10 kbp / 31), half of them present
  small     5,000 keys, 3,000 queries (a quick check)

The keys are unique random 48-bit integers from numpy ``default_rng`` with
ids 1..n in random order; the queries are half keys, half random, the last
one all ones (-1), shuffled.  ``--baseline SRC.cu`` compiles SRC as it
stands (nvcc with the port's flags) into a library of its own in ``SRC``'s
directory, ``_build/``, and calls its ``mz_find_sorted`` through the
interface the kernel had before it took a search index: (keys, vals, n, q,
nq, out, stream).  For example the source at an earlier commit::

    git show REV:modimizer_tpu_torch/csrc/lookup.cu > old/lookup.cu
    python -m modimizer_tpu_torch.probes.probe_lookup \
        --baseline old/lookup.cu

Each version is held against ``find_sorted_ref``; then they are timed in
turns (baseline, current, library, library, current, baseline), CUDA
events with the launches queued behind a sleep.
"library" is the PyTorch route (``torch.searchsorted``, clamp, gather,
compare, ``torch.where``).  Also timed: the index build
(``search_index``), and the current and baseline kernels on the same
queries sorted (their lanes share cache lines).  One JSON line per shape:
each time, the bound (keys and queries read once, the output written once,
the ids of the hits), the current kernel's share of it and its speed-up
over the baseline.  A disagreement exits non-zero.
"""

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from .. import _build
from ..parallel.lookup import find_sorted, find_sorted_ref, search_index
from . import resolve_device
from ._timing import bound_ms, card_line, time_ms

SEED = 17
# name: (keys, queries)
SHAPES = {"config3": (64_444_167 // 31, 3_000 * 10_000 // 31),
          "small": (5_000, 3_000)}


def lookup_inputs(rng, n, nq, dev):
    """A config-3-like table (n unique random 48-bit k-mers, ascending, ids
    1..n in random order) and nq queries: half present, half random, and
    one all-ones (-1)."""
    keys = np.unique(rng.integers(0, 1 << 48, n, dtype=np.int64))
    vals = (rng.permutation(len(keys)) + 1).astype(np.int32)
    present = rng.choice(keys, nq // 2) if len(keys) else keys[:0]
    q = np.concatenate([present, rng.integers(0, 1 << 48, nq - len(present))])
    if nq:
        q[-1] = -1
    rng.shuffle(q)
    return tuple(torch.from_numpy(a).to(dev) for a in (keys, vals, q))


def library_route(keys, vals, q):
    pos = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    return torch.where(keys[pos] == q, vals[pos], 0)


def lookup_bytes(keys, q, hits):
    """Keys and queries read once, the output written once, and the ids of
    this run's hits."""
    return keys.numel() * 8 + q.numel() * 12 + hits * 4


def load_aside(src):
    """Build ``src`` into its own library and declare the interface of
    ``mz_find_sorted`` before the search index: (keys, vals, n, q, nq, out,
    stream)."""
    L = _build.build_aside(src)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    L.mz_find_sorted.restype = ctypes.c_int
    L.mz_find_sorted.argtypes = [p, p, i64, p, i64, p, p]
    return L


def aside_find(L, keys, vals, n, q):
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    rc = L.mz_find_sorted(keys.data_ptr(), vals.data_ptr(), n, q.data_ptr(),
                          q.numel(), out.data_ptr(),
                          torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError("aside find_sorted: CUDA error %d" % rc)
    return out


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="probe_lookup",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=["config3"])
    ap.add_argument("--baseline", metavar="SRC.cu",
                    help="an earlier lookup.cu to time beside")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    for n in a.names:
        if n not in SHAPES:
            raise SystemExit("probe_lookup: unknown shape %r; shapes: %s"
                             % (n, ",".join(SHAPES)))
    dev = resolve_device(device)
    if a.baseline and dev.type != "cuda":
        raise SystemExit("probe_lookup: --baseline needs the card")
    base = load_aside(a.baseline) if a.baseline else None
    ok = True
    for name in a.names:
        rng = np.random.default_rng(SEED)
        keys, vals, q = lookup_inputs(rng, *SHAPES[name], dev)
        n = keys.numel()
        index = search_index(keys)
        want = find_sorted_ref(keys, vals, q)
        hits = int((want != 0).sum())
        fns = {"current": lambda: find_sorted(keys, vals, q, index)}
        line = {"probe": "probe_lookup", "shape": name, "n": n,
                "nq": q.numel(), "hits": hits,
                "index_entries": index.numel()}
        if base is not None:
            fns["baseline"] = lambda: aside_find(base, keys, vals, n, q)
        checks = {who: bool(torch.equal(fn(), want))
                  for who, fn in fns.items()}
        ok &= all(checks.values())
        line["check"] = {who: "match" if c else "DIFF"
                         for who, c in checks.items()}
        if dev.type == "cuda":
            fns["library"] = lambda: library_route(keys, vals, q)
            order = ["current", "library", "library", "current"]
            if base is not None:
                order = ["baseline"] + order + ["baseline"]
            times = {who: [] for who in fns}
            for who in order:
                times[who].append(time_ms(fns[who])[0])
            qs = torch.sort(q).values
            sorted_ms = {"current": time_ms(
                lambda: find_sorted(keys, vals, qs, index))[0]}
            if base is not None:
                sorted_ms["baseline"] = time_ms(
                    lambda: aside_find(base, keys, vals, n, qs))[0]
            b_ms, b_by = bound_ms(lookup_bytes(keys, q, hits))
            cur = min(times["current"])
            line.update(ms=times, sorted_queries_ms=sorted_ms,
                        index_build_ms=time_ms(lambda: search_index(keys))[0],
                        bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / cur,
                        library="torch.searchsorted + clamp + gather + "
                        "compare + torch.where",
                        device=torch.cuda.get_device_name(dev),
                        card=card_line())
            if base is not None:
                line["speedup"] = min(times["baseline"]) / cur
        else:
            line.update(ms=None, device="cpu", card=None)
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
