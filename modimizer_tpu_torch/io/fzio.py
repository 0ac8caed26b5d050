"""fzopen-equivalent IO: transparent gzip on write, auto-detect on read.

The reference persists every binary structure through fzopen (utils.c:108-127),
whose write path is zlib's gzopen — so .mod/.ref/.readset files on disk are
gzip streams.  For byte-identical output we reproduce zlib's gz framing
exactly: header 1f 8b 08 00 <mtime=0> 00 <OS=3>, raw deflate at level 6,
crc32 + isize trailer.
"""

import os
import zlib

_GZ_HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03"

# ------------------------------------------------------------------
# fast whole-buffer gzip decode (libdeflate when present, zlib fallback)
#
# Only the READ side may use libdeflate: decompression just has to produce
# the right bytes, while the write side must emit zlib-level-6 streams
# byte-identical to the reference's gzopen output (GzWriter below stays
# zlib).  libdeflate's inflate measures 1.6-1.9x zlib on this host and
# also handles multi-member streams (BGZF/BAM) in one pass — the same
# reason htslib links it.
# ------------------------------------------------------------------

_LIBDEFLATE = None          # lazy: ctypes handle or False after first probe


def _libdeflate():
    global _LIBDEFLATE
    if _LIBDEFLATE is None:
        if os.environ.get("MODIMIZER_NO_LIBDEFLATE"):
            _LIBDEFLATE = False
        else:
            try:
                import ctypes
                lib = ctypes.CDLL("libdeflate.so.0")
                lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
                lib.libdeflate_free_decompressor.argtypes = [ctypes.c_void_p]
                lib.libdeflate_gzip_decompress_ex.restype = ctypes.c_int
                lib.libdeflate_gzip_decompress_ex.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.POINTER(ctypes.c_size_t),
                    ctypes.POINTER(ctypes.c_size_t)]
                _LIBDEFLATE = lib
            except OSError:
                _LIBDEFLATE = False
    return _LIBDEFLATE


def _gz_decompress_zlib(data) -> bytearray:
    """Multi-member gzip decode through zlib (fallback path).

    Trailing bytes that do not BEGIN a gzip member are ignored, like
    zlib's gzread (the reference reads everything through it).  A later
    member that starts with the gzip magic but is corrupt still raises —
    silently truncating a damaged multi-member file would hand callers an
    incomplete payload as if it were whole."""
    out = bytearray()
    view = memoryview(data)
    first = True
    while len(view):
        if not first and bytes(view[:2]) != b"\x1f\x8b":
            break  # trailing garbage after complete member(s)
        d = zlib.decompressobj(16 + zlib.MAX_WBITS)
        out += d.decompress(view)  # raises zlib.error on a corrupt member
        first = False
        view = memoryview(d.unused_data)
        if not d.eof:
            break  # truncated final member: return what zlib produced
    return out


def gz_decompress_all(data) -> bytearray:
    """Decompress a whole gzip stream (any member count) to a bytearray.

    ``data`` must be a writable buffer (bytearray / writable memoryview)
    for the zero-copy libdeflate path; bytes inputs are copied once.
    Falls back to zlib when libdeflate is absent or rejects the stream.
    """
    lib = _libdeflate()
    if not lib:
        return _gz_decompress_zlib(data)
    import ctypes
    if isinstance(data, bytes):
        data = bytearray(data)
    n = len(data)
    inaddr = ctypes.addressof(ctypes.c_char.from_buffer(data))
    # single-member files (everything gzopen writes) store the output
    # size mod 2^32 in the ISIZE trailer; multi-member streams (BGZF)
    # grow on demand below.  Clamp by deflate's maximum expansion (~1032x)
    # so a garbage tail (where data[-4:] is not a real ISIZE) cannot
    # trigger a multi-GB spurious allocation.
    cap = max(min(int.from_bytes(bytes(data[-4:]), "little"),
                  n * 1032 + 64), 64)
    out = bytearray(cap)
    pos = wpos = 0
    dec = lib.libdeflate_alloc_decompressor()
    try:
        ain = ctypes.c_size_t(0)
        aout = ctypes.c_size_t(0)
        while pos < n:
            pin = ctypes.c_char.from_buffer(out)   # pin while libdeflate writes
            r = lib.libdeflate_gzip_decompress_ex(
                dec, inaddr + pos, n - pos,
                ctypes.addressof(pin) + wpos, cap - wpos,
                ctypes.byref(ain), ctypes.byref(aout))
            del pin
            if r == 3:  # LIBDEFLATE_INSUFFICIENT_SPACE: double and retry
                cap = cap * 2 + 64
                out += bytes(cap - len(out))
                continue
            if r != 0:
                if pos > 0 and bytes(data[pos:pos + 2]) != b"\x1f\x8b":
                    break  # trailing garbage: ignore, like zlib's gzread
                # bad/truncated member: redo through zlib so both decode
                # paths return (or raise) identically
                return _gz_decompress_zlib(data)
            pos += ain.value
            wpos += aout.value
    finally:
        lib.libdeflate_free_decompressor(dec)
    del out[wpos:]
    return out


class GzWriter:
    """File-like writer producing byte-identical output to zlib gzopen(...,"w")."""

    def __init__(self, path_or_file):
        if hasattr(path_or_file, "write"):
            self._f = path_or_file
            self._own = False
        else:
            self._f = open(path_or_file, "wb")
            self._own = True
        self._c = zlib.compressobj(6, zlib.DEFLATED, -15)
        self._crc = 0
        self._len = 0
        self._f.write(_GZ_HEADER)

    def write(self, data):
        # zero-copy: crc32/compress take any C-contiguous buffer (numpy
        # arrays included) — a bytes() copy here doubled the write cost of
        # the multi-hundred-MB .mod/.ref payloads
        if not isinstance(data, (bytes, bytearray, memoryview)):
            data = memoryview(data).cast("B")
        self._crc = zlib.crc32(data, self._crc)
        self._len += data.nbytes if isinstance(data, memoryview) else len(data)
        out = self._c.compress(data)
        if out:
            self._f.write(out)

    def close(self):
        self._f.write(self._c.flush())
        self._f.write(self._crc.to_bytes(4, "little"))
        self._f.write((self._len & 0xFFFFFFFF).to_bytes(4, "little"))
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_maybe_gz(path) -> bytearray:
    """Read a whole file, transparently decompressing gzip (like gzread).

    Returns a writable bytearray so structure loaders (Modset.from_bytes)
    can wrap the payload without another whole-buffer copy."""
    size = os.path.getsize(path)
    data = bytearray(size)
    with open(path, "rb") as f:
        got = f.readinto(data)
    del data[got:]
    if data[:2] == b"\x1f\x8b":
        return gz_decompress_all(data)
    return data


def open_maybe_gz(path):
    """Open for buffered byte reading with transparent gzip."""
    import gzip
    import io
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f
