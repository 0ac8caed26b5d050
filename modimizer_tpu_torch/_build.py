"""Build and bind the CUDA kernels in ``csrc/``: nvcc into a shared library
with a plain C interface, loaded with ctypes, at first use.

The library is named by a hash of the sources and built with an atomic
rename (the same scheme as ``modimizer_tpu/native/__init__.py``), so
concurrent first uses are safe and an edited source rebuilds.  Nothing here
runs at import: the CPU-only test suite imports every module.

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
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"scan_compact": 0, "densify": 0}


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
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        r = subprocess.run([_nvcc()] + NVCC_FLAGS + ["-o", str(tmp)]
                           + [str(s) for s in srcs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc failed (rc %d):\n%s%s"
                               % (r.returncode, r.stdout, r.stderr))
        os.replace(tmp, so)
    return so


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
        i64, i32, u64, u64,    # C, k, w, factor1
        i32, i32, i32,         # blk, bo, meta_isf
        p, p, p, p, p,         # out_k, out_meta, cnt, n_emit, overflow
        p]                     # stream
    L.mz_densify.restype = ctypes.c_int
    L.mz_densify.argtypes = [
        p, p, p, p,            # src_k, src_meta (nullable), cnt, base
        i64, i32, i64,         # nb, bo, cap
        p, p,                  # dst_k, dst_meta (nullable)
        p]                     # stream
    L.mz_error_string.restype = ctypes.c_char_p
    L.mz_error_string.argtypes = [i32]


def check(rc: int, what: str):
    """Raise on a non-zero cudaGetLastError() returned by a C entry point."""
    if rc != 0:
        msg = lib().mz_error_string(rc).decode(errors="replace")
        raise RuntimeError("%s: CUDA error %d after launch (%s)"
                           % (what, rc, msg))
