"""Native (C++) host runtime: built on demand with g++, loaded via ctypes.

The port's own copy of ``modimizer_tpu/native``: the same sources, built
into ``modimizer_tpu_torch/native/_build/``.  The port calls the host scan
(``sh_scan_emit_reads``), the packers (``pk_*``), the parsers (``io_*``) and
the table (``ms_*``); the ``rs_*`` readset engine of modasm is declared
too."""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_LOCK = threading.Lock()
_LIB = None


_SOURCES = ["modset_native.cpp", "modasm_native.cpp", "cram_native.cpp"]


def _build() -> Path:
    srcs = [_HERE / s for s in _SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.read_bytes())
    stamp = h.hexdigest()[:16]
    build_dir = _HERE / "_build"
    build_dir.mkdir(exist_ok=True)
    so = build_dir / f"modimizer_native-{stamp}.so"
    if not so.exists():
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-o", str(tmp)] + [str(s) for s in srcs],
            check=True, capture_output=True)
        os.replace(tmp, so)
    return so


class RSView(ctypes.Structure):
    """Mirror of modasm_native.cpp's RSView (flat CSR readset view)."""
    _fields_ = [
        ("rlen", ctypes.POINTER(ctypes.c_int32)),
        ("nHit", ctypes.POINTER(ctypes.c_int32)),
        ("nMiss", ctypes.POINTER(ctypes.c_int32)),
        ("bad", ctypes.POINTER(ctypes.c_uint8)),
        ("oflags", ctypes.POINTER(ctypes.c_uint8)),
        ("contained", ctypes.POINTER(ctypes.c_int32)),
        ("nCopy", ctypes.POINTER(ctypes.c_int32)),
        ("hitOff", ctypes.POINTER(ctypes.c_int64)),
        ("hits", ctypes.POINTER(ctypes.c_uint32)),
        ("dx", ctypes.POINTER(ctypes.c_uint16)),
        ("depth", ctypes.POINTER(ctypes.c_uint16)),
        ("info", ctypes.POINTER(ctypes.c_uint8)),
        ("invOff", ctypes.POINTER(ctypes.c_int64)),
        ("invReads", ctypes.POINTER(ctypes.c_uint32)),
        ("miFlags", ctypes.POINTER(ctypes.c_uint8)),
        ("miPos", ctypes.POINTER(ctypes.c_int32)),
        ("miGood", ctypes.POINTER(ctypes.c_int32)),
        ("miMod2", ctypes.POINTER(ctypes.c_int32)),
        ("miBadLD", ctypes.POINTER(ctypes.c_int32)),
        ("miSplit", ctypes.POINTER(ctypes.c_int32)),
        ("miSplitLD", ctypes.POINTER(ctypes.c_int32)),
        ("nReads", ctypes.c_int64),
        ("msMax", ctypes.c_int64),
        ("totHit", ctypes.c_int64),
        ("hasherW", ctypes.c_int32),
        ("fdOut", ctypes.c_int32),
        ("fdStdout", ctypes.c_int32),
        ("pad_", ctypes.c_int32),
    ]


def lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = ctypes.CDLL(str(_build()))
            _declare(_LIB)
        return _LIB


def _declare(L):
    c = ctypes
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    L.ms_find_batch.restype = None
    L.ms_find_batch.argtypes = [u32p, u64p, c.c_int, c.c_uint64, c.c_int,
                                u64p, c.c_int64, u32p]
    L.ms_insert_batch.restype = c.c_int64
    L.ms_insert_batch.argtypes = [u32p, u64p, u16p, u8p, c.c_int, c.c_uint64,
                                  c.c_int, c.c_int64, c.c_int64, u64p,
                                  c.c_void_p, c.c_int64, c.c_void_p]
    L.ms_merge_batch.restype = c.c_int64
    L.ms_merge_batch.argtypes = [u32p, u64p, u16p, u8p, c.c_int, c.c_uint64,
                                 c.c_int, c.c_int64, c.c_int64, u64p, u16p,
                                 u8p, c.c_int64]
    L.ms_rebuild_table.restype = c.c_int64
    L.ms_rebuild_table.argtypes = [u32p, u64p, c.c_int, c.c_uint64, c.c_int,
                                   c.c_int64]

    vp = c.POINTER(RSView)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    for name, extra in [
            ("rs_inv_build", []),
            ("rs_find_overlaps", [c.c_int64, c.c_int]),
            ("rs_overlaps_every", [c.c_int64]),
            ("rs_mark_bad", []),
            ("rs_mark_contained", []),
            ("rs_cluster", []),
            ("rs_clean_mods", []),
            ("rs_test_mods", [c.c_int, c.c_int]),
            ("rs_ref_flag", [u32p, i32p, c.c_int64]),
            ("rs_reset_bits", [c.c_int]),
            ("rs_read_properties", []),
            ("rs_print_overlap", [c.c_int64, c.c_int64]),
            ("rs_assemble_from_mod", [c.c_uint32, c.c_int, c.c_int]),
            ("rs_assemble_from_read", [c.c_int64]),
    ]:
        fn = getattr(L, name)
        fn.restype = None
        fn.argtypes = [vp] + extra

    i64pp = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    cand = [u32p, u16p, i64pp]
    for name, extra in [
            ("rs_mark_bad_pre", cand),
            ("rs_mark_contained_pre", cand),
            ("rs_cluster_pre", cand),
            ("rs_overlaps_every_pre", [c.c_int64] + cand),
    ]:
        fn = getattr(L, name)
        fn.restype = None
        fn.argtypes = [vp] + extra

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    L.sh_scan_emit.restype = c.c_int64
    L.sh_scan_emit.argtypes = [u8p, c.c_int64, c.c_int, c.c_uint64,
                               c.c_uint64, c.c_int, u64p, i64p, u8p,
                               c.c_int64]
    L.sh_scan_emit_reads.restype = c.c_int64
    L.sh_scan_emit_reads.argtypes = [u8p, i64p, c.c_int64, c.c_int,
                                     c.c_uint64, c.c_uint64, c.c_int, u64p,
                                     i64p, u8p, c.c_int64]
    L.rs_hits_from_scan.restype = c.c_int64
    L.rs_hits_from_scan.argtypes = [i64p, u8p, u32p, c.c_int64, i64p,
                                    c.c_int64, u32p, u16p, i32p, i32p, u16p]
    L.sh_rid_rpos.restype = None
    L.sh_rid_rpos.argtypes = [i64p, c.c_int64, i64p, c.c_int64, i64p, i64p]
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    L.pk_pack2.restype = None
    L.pk_pack2.argtypes = [u8p, c.c_int64, u64p, c.c_int64]
    L.pk_valid_words.restype = None
    L.pk_valid_words.argtypes = [i64p, c.c_int64, c.c_int64, c.c_int, u64p,
                                 c.c_int64]
    L.io_byte_hist.restype = None
    L.io_byte_hist.argtypes = [u8p, c.c_int64, u64p]
    L.io_u16_hist.restype = None
    L.io_u16_hist.argtypes = [u16p, c.c_int64, u64p, c.c_int64]
    L.io_fasta_count.restype = c.c_int64
    L.io_fasta_count.argtypes = [u8p, c.c_int64]
    L.io_parse_fasta.restype = c.c_int64
    L.io_parse_fasta.argtypes = [u8p, c.c_int64, i16p, i8p, i64p, i64p]
    L.io_fastq_count.restype = c.c_int64
    L.io_fastq_count.argtypes = [u8p, c.c_int64]
    L.io_parse_fastq.restype = c.c_int64
    L.io_parse_fastq.argtypes = [u8p, c.c_int64, c.c_void_p, c.c_int, i8p,
                                 i64p, i64p, c.c_void_p]
    L.cram_rans_decode.restype = c.c_int64
    L.cram_rans_decode.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
    L.mm_query_emit.restype = None
    L.mm_query_emit.argtypes = [i64p, u32p, i64p, u8p, u32p, u32p, u32p,
                                u32p, c.c_int64, c.c_char_p, i64p,
                                c.c_char_p, i64p, i64p, c.c_int64, c.c_int,
                                c.c_int, c.c_int]


def byte_hist256(arr) -> np.ndarray:
    """Histogram of a u8/i8 array into 256 bins without numpy's int64-cast
    temporary (np.bincount materializes len(arr)*8 bytes)."""
    a = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    out = np.zeros(256, np.uint64)
    lib().io_byte_hist(a, len(a), out)
    return out


def u16_hist(arr, nbins: int) -> np.ndarray:
    a = np.ascontiguousarray(arr, np.uint16).reshape(-1)
    out = np.zeros(nbins, np.uint64)
    lib().io_u16_hist(a, len(a), out, nbins)
    return out

