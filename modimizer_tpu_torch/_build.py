"""Build and bind the CUDA kernels in ``csrc/``: nvcc into a shared library
with a plain C interface, loaded with ctypes, at first use.

The library is named by a hash of the sources and built with an atomic
rename (the same scheme as ``modimizer_tpu/native/__init__.py``), so
concurrent first uses are safe and an edited source rebuilds.  Each source
is compiled by its own nvcc process, all started together, then linked.
Nothing here runs at import: the CPU-only test suite imports every module.

``LAUNCHES`` counts each kernel's launches; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc"
_LOCK = threading.Lock()
_LIB = None

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

LAUNCHES = {"scan_compact": 0, "densify": 0, "find_sorted": 0,
            "overlap_groups": 0, "overlap_join": 0, "overlap_dense": 0,
            "front_planes": 0, "front_reduce": 0, "front_mma": 0,
            "front_ops": 0, "tala16": 0, "dot16": 0, "roll12": 0,
            "cumsum128": 0, "route_rows": 0, "merge_reduce": 0,
            "minimizer": 0, "chain_scan": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources():
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("modimizer_tpu_torch: nvcc not found (no CUDA toolkit "
                       "on PATH or under torch's CUDA_HOME)")


def build() -> Path:
    """Compile csrc/*.cu (if not already built for these sources) and
    return the library path."""
    srcs = sources()
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = _CSRC / "_build"
    out_dir.mkdir(exist_ok=True)
    so = out_dir / f"libmodimizer_kernels-{h.hexdigest()[:16]}.so"
    if not so.exists():
        nvcc = _nvcc()
        tag = f".tmp{os.getpid()}"
        objs = [out_dir / f"{s.stem}{tag}.o" for s in srcs]
        procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", "-o", str(o),
                                                         str(s)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        errors = []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append("%s (rc %d):\n%s" % (s.name, p.returncode, out))
        tmp = so.with_suffix(f"{tag}.so")
        try:
            if errors:
                raise RuntimeError("nvcc failed: " + "\n".join(errors))
            r = subprocess.run([nvcc] + NVCC_FLAGS + ["-shared", "-o",
                                                      str(tmp)]
                               + [str(o) for o in objs],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError("nvcc link failed (rc %d):\n%s%s"
                                   % (r.returncode, r.stdout, r.stderr))
            os.replace(tmp, so)
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
    return so


def build_aside(src) -> ctypes.CDLL:
    """Compile one source as it stands (nvcc with the port's flags) into a
    library of its own in ``src``'s directory, ``_build/``, and load it: an
    earlier version of a kernel that a probe times beside the current one."""
    src = Path(src).resolve()
    out = src.parent / "_build" / (src.stem + ".so")
    out.parent.mkdir(exist_ok=True)
    r = subprocess.run([_nvcc()] + NVCC_FLAGS + ["-shared", "-o", str(out),
                                                 str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc %s failed (rc %d):\n%s%s"
                           % (src, r.returncode, r.stdout, r.stderr))
    return ctypes.CDLL(str(out))


def lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            L = ctypes.CDLL(str(build()))
            _declare(L)
            _LIB = L
        return _LIB


def _declare(L):
    # every pointer and the stream as c_void_p, the 64-bit scalars as
    # c_uint64/c_int64: an undeclared Python int goes through as a 32-bit
    # C int and cuts pointers and factor1
    p, i32, i64, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_uint64)
    L.mz_scan_compact.restype = ctypes.c_int
    L.mz_scan_compact.argtypes = [
        p, p,                  # sw, vbits
        i64, i32, u64,         # C, k, factor1
        u64, i32, u64,         # the emit test: minv, rot, limit
        i32, i32, i32,         # blk, bo, meta_isf
        p, p, p, p, p,         # out_k, out_meta, cnt, n_emit, overflow
        p]                     # stream
    L.mz_densify.restype = ctypes.c_int
    L.mz_densify.argtypes = [
        p, p, p, p,            # src_k, src_meta (nullable), cnt, agg
        i64, i32, i64,         # nb, bo, cap
        p, p,                  # dst_k, dst_meta (nullable)
        p]                     # stream
    L.mz_find_sorted.restype = ctypes.c_int
    L.mz_find_sorted.argtypes = [
        p, p, i64, p,          # keys, vals, n, index (the search levels)
        p, i64, p,             # q, nq, out
        p]                     # stream
    L.mz_overlap_groups.restype = ctypes.c_int
    L.mz_overlap_groups.argtypes = [
        p, p, p, p, i64,       # h, order, xs, st, n
        p, p, p,               # grp, yb, max_group
        p]                     # stream
    L.mz_overlap_join.restype = ctypes.c_int
    L.mz_overlap_join.argtypes = [
        p, p, p, p, p, p,      # xs, js, st, first, grp, yb
        i64, i32,              # n, cap
        p, p, p, p,            # dcnt, flags, nflag, incl (NULL: count)
        p, p, p, p,            # out key, cnt, agree, rank
        p]                     # stream
    L.mz_overlap_dense.restype = ctypes.c_int
    L.mz_overlap_dense.argtypes = [
        p, p, p, p, p, p,      # xs, js, st, first, grp, yb
        i64, p, p,             # n, flags, nflag
        i64, i32, p,           # nid, blocks, table
        p, p,                  # dcnt, incl (NULL: count)
        p, p, p, p,            # out key, cnt, agree, rank
        p]                     # stream
    L.mz_front_planes.restype = ctypes.c_int
    L.mz_front_planes.argtypes = [
        p, p, p, p,            # pa, pb, za, zb
        i64, i32, u64,         # nj, variant, factor1
        ctypes.c_uint32,       # wmask = w - 1
        i64, i32, i32,         # mj, seed, nblocks
        p, p,                  # km, em
        p]                     # stream
    L.mz_front_emit_blocks_per_sm.restype = ctypes.c_int
    L.mz_front_emit_blocks_per_sm.argtypes = [p]          # &blocks
    L.mz_front_reduce_blocks_per_sm.restype = ctypes.c_int
    L.mz_front_reduce_blocks_per_sm.argtypes = [i32, p]   # variant, &blocks
    L.mz_front_reduce.restype = ctypes.c_int
    L.mz_front_reduce.argtypes = [
        p, p, p, p,            # pa, pb, za, zb
        i64, i32, u64,         # nj, variant, factor1
        ctypes.c_uint32, i32,  # wmask, nblocks
        p, p,                  # scratch (zero in, zero out), out
        p]                     # stream
    L.mz_front_mma.restype = ctypes.c_int
    L.mz_front_mma.argtypes = [
        p, p, p, p,            # pa, pb, za, zb
        i64, p,                # nj, limb weights (host, 24 x 8 u8)
        ctypes.c_uint32, i32,  # wmask, nblocks
        p, p,                  # km, em
        p]                     # stream
    L.mz_front_ops.restype = ctypes.c_int
    L.mz_front_ops.argtypes = [
        p, i64, i32,           # x, n, op
        i32, i32, i32, i32,    # L, R, r_last, nblocks
        p,                     # out
        p]                     # stream
    for name, args in (("mz_tala16", [p, p, i64, p]),     # x, idx, nj, out
                       ("mz_dot16", [p, p, i64, p]),      # rank, cols, nb, out
                       ("mz_roll12", [p, i64, i64, p]),   # x, rows, nj, out
                       ("mz_cumsum128", [p, i64, p])):    # e, rows, out
        getattr(L, name).restype = ctypes.c_int
        getattr(L, name).argtypes = args + [p]            # + stream
    L.mz_route_rows.restype = ctypes.c_int
    L.mz_route_rows.argtypes = [
        p, p, u64, i64,        # kmers, pos (builder mode, nullable), base, N
        i32, u64, i32, u64,    # mode, factor1, shift, w
        i32, i32,              # n, cap
        p, i64, u64,           # scratch, its bytes, the call's sequence
        p, p, p,               # index, counts, overflow
        p, p,                  # send_k, send_p (builder mode, nullable)
        p]                     # stream
    L.mz_route_tile_rows.restype = ctypes.c_int
    L.mz_route_tile_rows.argtypes = [i32]                 # mode
    L.mz_merge_reduce.restype = ctypes.c_int
    L.mz_merge_reduce.argtypes = [
        p, p, p, p,            # kmers, depth, info, rank
        i64, i64, i32, p,      # m, out_len, blocks, block-count scratch
        p, p, p, p, p,         # out_k, out_d, out_i, out_r, n_heads
        p]                     # stream
    L.mz_minimizer_chunk.restype = ctypes.c_int
    L.mz_minimizer_chunk.argtypes = [
        p, i64, i64, i64, i64,  # sw, C, m_ext, n_win, base
        i32, i64, u64,         # k, w, factor1
        p, p, p, p,            # out hash, isF, emit, scratch (nullable)
        p]                     # stream
    L.mz_minimizer_tile.restype = ctypes.c_int
    L.mz_minimizer_tile.argtypes = []
    L.mz_minimizer_w_tile.restype = ctypes.c_int
    L.mz_minimizer_w_tile.argtypes = []
    L.mz_chain_scan.restype = ctypes.c_int
    L.mz_chain_scan.argtypes = [
        p, p, p, p,            # la, lb, ia, ib
        p, p, p, p,            # flags, pos, idmap, seed_off
        i64, i32,              # R, cap
        p, p, p,               # out (slots), counts, overflow
        p]                     # stream
    L.mz_chain_emit.restype = ctypes.c_int
    L.mz_chain_emit.argtypes = [
        p, p, p, p,            # la, lb, ia, ib
        p, p, p, p,            # flags, pos, idmap, seed_off
        i64, p, i64, u64,      # R, scratch, its words, seq
        p, p,                  # rec_off, out
        p]                     # stream
    L.mz_chain_tile_reads.restype = ctypes.c_int
    L.mz_chain_tile_reads.argtypes = []
    L.mz_chain_rec_cap.restype = ctypes.c_int
    L.mz_chain_rec_cap.argtypes = []
    L.mz_error_string.restype = ctypes.c_char_p
    L.mz_error_string.argtypes = [i32]


def check(rc: int, what: str):
    """Raise on a non-zero cudaGetLastError() returned by a C entry point."""
    if rc != 0:
        msg = lib().mz_error_string(rc).decode(errors="replace")
        raise RuntimeError("%s: CUDA error %d after launch (%s)"
                           % (what, rc, msg))
