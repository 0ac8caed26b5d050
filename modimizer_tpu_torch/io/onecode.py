"""ONE-code ("VGP") structured file library subset (reference: ONElib.c/h).

Byte-exact reimplementation of the parts of ONElib the modimizer toolset
uses: schema-from-text, ASCII and binary read/write of data lines, the
length-limited Huffman list codec with its training protocol, the built-in
2-bit DNA codec, binary footers with object/group indexes, and provenance
headers.  Enough that a .1seq written here is byte-identical to one written
by the reference seqio+ONElib (modulo the embedded timestamp, which has a
fixed width), and that modtype's ins/smp inputs parse identically.

Not carried over: master/slave threaded file handles (ONElib.c:1394-1450) —
parallel ingest in this framework shards whole files across hosts instead.

Key quirks preserved for parity (all cited):
 - binary line code bytes: (t-'A')<<1|0x80 etc (ONElib.c:159-165)
 - variable-length ints: intPut/intGet (ONElib.c:3386-3448)
 - INT_LIST compaction: diff + low-byte truncation (ONElib.c:749-801)
 - Huffman bitstream: 2-bit endian tag, 64-bit MSB-first words flushed
   little-endian, final-word byte reversal, first-word 0<->7 byte swap
   (vcEncode, ONElib.c:3119-3216), 0xff literal fallback
 - codec training: engage after 100000 raw list bytes (ONElib.c:461,2086)
"""

import struct
import sys
import time

import numpy as np

MAJOR, MINOR = 1, 1
HUFF_CUTOFF = 12

INT, REAL, CHAR, STRING, INT_LIST, REAL_LIST, STRING_LIST, DNA = range(1, 9)
TYPE_NAME = {INT: "INT", REAL: "REAL", CHAR: "CHAR", STRING: "STRING",
             INT_LIST: "INT_LIST", REAL_LIST: "REAL_LIST",
             STRING_LIST: "STRING_LIST", DNA: "DNA"}
NAME_TYPE = {v: k for k, v in TYPE_NAME.items()}
LIST_ELT_SIZE = {STRING: 1, INT_LIST: 8, REAL_LIST: 8, STRING_LIST: 1, DNA: 1}
LIST_TYPES = (STRING, INT_LIST, REAL_LIST, STRING_LIST, DNA)

M64 = (1 << 64) - 1


def _die(fmt, *args):
    raise ValueError("ONE file error: " + (fmt % args if args else fmt))


# ------------------------------------------------------------------
# variable-length integers (intPut/intGet/ltf*, ONElib.c:3386-3489)
# ------------------------------------------------------------------

def int_put(val: int) -> bytes:
    v8 = struct.pack("<q", val)
    if val >= 0:
        if val < 0x40:
            return bytes([val | 0x40])
        if val < 0x2000:
            return bytes([(val >> 8) | 0x20, val & 0xFF])
        for d, hi in ((1, 1 << 16), (2, 1 << 24), (3, 1 << 32), (4, 1 << 40),
                      (5, 1 << 48), (6, 1 << 56)):
            if val < hi:
                return bytes([d]) + v8[:d + 1]
        return bytes([7]) + v8
    else:
        if val >= -0x40:
            return bytes([(val & 0xFF) | 0x40])
        for d, lo in ((1, -(1 << 16)), (2, -(1 << 24)), (3, -(1 << 32)),
                      (4, -(1 << 40)), (5, -(1 << 48)), (6, -(1 << 56))):
            if val >= lo:
                return bytes([0x80 | d]) + v8[:d + 1]
        return bytes([0x87]) + v8


def ltf_read(f) -> int:
    b0 = f.read(1)[0]
    if b0 & 0x40:  # single byte
        if b0 & 0x80:
            return struct.unpack("<q", bytes([b0]) + b"\xff" * 7)[0]
        return b0 & 0x3F
    if b0 & 0x20:  # two bytes positive
        b1 = f.read(1)[0]
        return ((b0 & 0x1F) << 8) | b1
    n = 1 + (b0 & 0x0F)
    rest = f.read(n)
    neg = bool(b0 & 0x80)
    v = int.from_bytes(rest, "little")
    if neg:
        v |= (-1 << (8 * n))
    return v


# ------------------------------------------------------------------
# DNA codec (Compress_DNA/Uncompress_DNA, ONElib.c:3066-3247)
# ------------------------------------------------------------------

_DNA_NUM = np.zeros(256, np.uint8)
for _c, _v in ((b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    _DNA_NUM[_c[0]] = _v
    _DNA_NUM[_c[1]] = _v
_DNA_BASE = np.frombuffer(b"acgt", np.uint8)


def compress_dna(data: bytes):
    """Returns (nBits, packed bytes); nBits = 2*len."""
    n = len(data)
    codes = _DNA_NUM[np.frombuffer(data, np.uint8)]
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
    q = codes.reshape(-1, 4)
    packed = ((q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) |
              q[:, 3]).astype(np.uint8)
    return 2 * n, packed.tobytes()


def uncompress_dna(data: bytes, n_bases: int) -> bytes:
    b = np.frombuffer(data, np.uint8)
    out = np.empty(4 * len(b), np.uint8)
    out[0::4] = _DNA_BASE[(b >> 6) & 3]
    out[1::4] = _DNA_BASE[(b >> 4) & 3]
    out[2::4] = _DNA_BASE[(b >> 2) & 3]
    out[3::4] = _DNA_BASE[b & 3]
    return out[:n_bases].tobytes()


DNA_CODEC = "dna"  # sentinel like ONElib's DNAcodec


# ------------------------------------------------------------------
# length-limited Huffman codec (_OneCodec, ONElib.c:2542-3216)
# ------------------------------------------------------------------

class HuffCodec:
    __slots__ = ("state", "hist", "codebits", "codelens", "esc_code",
                 "esc_len", "lookup")
    EMPTY, FILLED, CODED_WITH, CODED_READ = range(4)

    def __init__(self):
        self.state = self.EMPTY
        self.hist = np.zeros(256, np.uint64)
        self.codebits = np.zeros(256, np.uint16)
        self.codelens = np.zeros(256, np.uint8)
        self.esc_code = -1
        self.esc_len = 0
        self.lookup = None  # np.uint8 [65536] decode table

    def add(self, data: bytes):
        self.hist += np.bincount(np.frombuffer(data, np.uint8),
                                 minlength=256).astype(np.uint64)
        if self.state < self.FILLED:
            self.state = self.FILLED

    def create_codec(self, partial: int = 1):
        """vcCreateCodec (ONElib.c:2643-2841), incl. stable tie order of the
        glibc-mergesort HSORT."""
        hist = self.hist.astype(np.int64)
        ecode = -partial
        code = []
        for i in range(256):
            if hist[i] > 0:
                code.append(i)
            elif ecode < 0:
                ecode = i
                code.append(i)
        ncode = len(code)
        if ecode < 0:
            partial = 0
        code.sort(key=lambda x: int(hist[x]))  # stable, like glibc msort

        leng = [0] * ncode
        countb = [int(hist[c]) for c in code]
        lcnt = countb[:]
        matrix = [None] * HUFF_CUTOFF
        llen = ncode - 1
        for L in range(HUFF_CUTOFF - 1, 0, -1):
            j = k = 0
            ccnt = []
            row = []
            while j < ncode or k < llen:
                if k >= llen or (j < ncode and
                                 countb[j] <= lcnt[k] + lcnt[k + 1]):
                    ccnt.append(countb[j])
                    row.append(1)
                    j += 1
                else:
                    ccnt.append(lcnt[k] + lcnt[k + 1])
                    row.append(0)
                    k += 2
            matrix[L] = row
            llen = len(ccnt) - 1
            lcnt = ccnt
        span = 2 * (ncode - 1)
        for L in range(1, HUFF_CUTOFF):
            j = 0
            for n in range(span):
                if matrix[L][n]:
                    leng[j] += 1
                    j += 1
            span = 2 * (span - j)
        for n in range(span):
            leng[n] += 1

        bits = [0] * ncode
        llen = leng[0]
        lbits = (1 << llen) - 1
        bits[0] = lbits
        for n in range(1, ncode):
            while (lbits & 1) == 0:
                lbits >>= 1
                llen -= 1
            lbits -= 1
            while llen < leng[n]:
                lbits = ((lbits << 1) | 1) & 0xFFFF
                llen += 1
            bits[n] = lbits

        self.codelens[:] = 0
        self.codebits[:] = 0
        for i in range(ncode):
            self.codelens[code[i]] = leng[i]
            self.codebits[code[i]] = bits[i]
        self._build_lookup()
        if partial:
            self.esc_code = ecode
            self.esc_len = int(self.codelens[ecode])
            self.codelens[ecode] = 0
        else:
            self.esc_code = -1
        self.state = self.CODED_WITH

    def _build_lookup(self):
        look = np.zeros(0x10000, np.uint8)
        for i in range(256):
            ln = int(self.codelens[i])
            if ln > 0:
                base = int(self.codebits[i]) << (16 - ln)
                look[base:base + (1 << (16 - ln))] = i
        self.lookup = look

    def serialize(self) -> bytes:
        out = [bytes([0]),  # isbig = 0 (little-endian writer)
               struct.pack("<i", self.esc_code),
               struct.pack("<i", self.esc_len)]
        for i in range(256):
            ln = int(self.codelens[i])
            out.append(bytes([ln]))
            if ln > 0 or i == self.esc_code:
                out.append(struct.pack("<H", int(self.codebits[i])))
        return b"".join(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "HuffCodec":
        v = cls()
        v.state = cls.CODED_READ
        isbig = data[0]
        if isbig:
            _die("big-endian codec not supported")
        v.esc_code, v.esc_len = struct.unpack_from("<ii", data, 1)
        off = 9
        for i in range(256):
            ln = data[off]
            off += 1
            v.codelens[i] = ln
            if ln > 0 or i == v.esc_code:
                v.codebits[i] = struct.unpack_from("<H", data, off)[0]
                off += 2
        if v.esc_code >= 0:
            v.codelens[v.esc_code] = v.esc_len
        v._build_lookup()
        if v.esc_code >= 0:
            v.codelens[v.esc_code] = 0
        return v

    def encode(self, data: bytes):
        """vcEncode: returns (nBits, bytes)."""
        ilen = len(data)
        ibits = ilen << 3
        esc, elen = self.esc_code, self.esc_len
        clens, cbits = self.codelens, self.codebits
        words = []
        ocode = 0
        rem = 62
        tbits = 2
        fallback = False

        def emit(L, C):
            nonlocal rem, ocode
            rem -= L
            if rem <= 0:
                ocode |= C >> (-rem)
                words.append(ocode & M64)
                if rem < 0:
                    rem += 64
                    ocode = (C << rem) & M64
                else:
                    rem = 64
                    ocode = 0
            else:
                ocode |= (C << rem) & M64

        for x in data:
            n = int(clens[x])
            if n == 0:
                if esc < 0:
                    _die("no code for %x and no escape code", x)
                tbits += 8 + elen
                if tbits > ibits:
                    fallback = True
                    break
                emit(elen, int(cbits[esc]))
                emit(8, x)
            else:
                tbits += n
                if tbits > ibits:
                    fallback = True
                    break
                emit(n, int(cbits[x]))

        if fallback:
            return ibits + 8, b"\xff" + data

        out = bytearray()
        for w in words:
            out += struct.pack("<Q", w)
        # final partial word: bytes written MSB-first (ONElib.c:3204-3207)
        bcode = struct.pack("<Q", ocode & M64)
        klo = 7 - ((63 - rem) >> 3)
        for k in range(7, klo - 1, -1):
            out.append(bcode[k])
        if tbits >= 64:  # first-word byte swap quirk (ONElib.c:3210-3214)
            out[0], out[7] = out[7], out[0]
        return tbits, bytes(out)

    def decode(self, nbits: int, data: bytes) -> bytes:
        """vcDecode transliteration (little-endian input assumed)."""
        if data[0] == 0xFF:
            olen = (nbits >> 3) - 1
            return data[1:1 + olen]
        buf = bytearray(data)
        if not (buf[0] & 0x40) and nbits >= 64:
            buf[0], buf[7] = buf[7], buf[0]
        look, lens = self.lookup, self.codelens
        esc, elen = self.esc_code, self.esc_len
        # reconstruct the MSB-first bitstream: whole 64-bit words are stored
        # little-endian; the trailing partial word is already MSB-first
        nwords = nbits >> 6
        bits = bytearray()
        for w in range(nwords):
            bits += buf[8 * w:8 * w + 8][::-1]
        bits += buf[8 * nwords:]
        big = int.from_bytes(bytes(bits), "big")
        total_bits = 8 * len(bits)
        out = bytearray()
        pos = 2  # skip the 2-bit endian tag
        end = nbits
        while pos < end:
            window = (big >> max(0, total_bits - pos - 16)) & 0xFFFF
            if total_bits - pos < 16:
                window = (window << (16 - (total_bits - pos))) & 0xFFFF
            c = int(look[window])
            if c == esc:
                pos += elen
                c = (big >> (total_bits - pos - 8)) & 0xFF
                pos += 8
            else:
                pos += int(lens[c])
            out.append(c)
        return bytes(out)


# ------------------------------------------------------------------
# schema
# ------------------------------------------------------------------

class OneInfo:
    __slots__ = ("field_types", "list_elt_size", "list_field", "comment",
                 "binary_type_pack", "list_codec", "is_use_list_codec",
                 "list_tack", "accum_count", "accum_max", "accum_total",
                 "given_count", "given_max", "given_total", "buffer",
                 "gmax_count", "gmax_total", "g_count", "g_total")

    def __init__(self, field_types, t):
        self.field_types = list(field_types)
        self.list_elt_size = 0
        self.list_field = -1
        self.comment = None
        self.list_codec = None
        self.is_use_list_codec = False
        self.list_tack = 0
        self.accum_count = self.accum_max = self.accum_total = 0
        self.given_count = self.given_max = self.given_total = 0
        self.gmax_count = self.gmax_total = 0
        self.g_count = self.g_total = 0
        self.buffer = None
        for i, ft in enumerate(self.field_types):
            if ft in LIST_TYPES:
                if self.list_elt_size:
                    _die("multiple list types for linetype %c", t)
                self.list_elt_size = LIST_ELT_SIZE[ft]
                self.list_field = i
                if ft == DNA:
                    self.list_codec = DNA_CODEC
                    self.is_use_list_codec = True
                else:
                    self.list_codec = HuffCodec()
        o = ord(t)
        if "A" <= t <= "Z":
            self.binary_type_pack = ((o - 65) << 1) | 0x80
        elif "a" <= t <= "z":
            self.binary_type_pack = ((26 + o - 97) << 1) | 0x80
        elif t == ";":
            self.binary_type_pack = (52 << 2) | 0x80
        elif t == "&":
            self.binary_type_pack = (53 << 2) | 0x80
        elif t == "*":
            self.binary_type_pack = (54 << 2) | 0x80
        elif t == "/":
            self.binary_type_pack = (55 << 2) | 0x80
        elif t == ".":
            self.binary_type_pack = (56 << 2) | 0x80
        else:
            self.binary_type_pack = 0


class FileSchema:
    def __init__(self, primary):
        self.primary = primary
        self.secondary = []
        self.info = {}
        self.object_type = None
        self.group_type = None
        self.n_field_max = 4

    def add_line(self, kind, t, types, comment):
        if t in self.info:
            _die("duplicate schema specification for linetype %s", t)
        if kind == "G":
            self.group_type = t
        elif kind == "O":
            self.object_type = t
        vi = OneInfo(types, t)
        vi.comment = comment
        self.info[t] = vi
        if len(types) > self.n_field_max:
            self.n_field_max = len(types)


class OneSchema:
    """Parsed '.def' schema text (oneSchemaCreateFromText)."""

    def __init__(self):
        self.filetypes = []  # list of FileSchema

    @classmethod
    def from_text(cls, text: str) -> "OneSchema":
        vs = cls()
        cur = None
        for raw in text.replace("\\n", "\n").split("\n"):
            line = raw.strip("\r")
            if not line or line[0] == ".":
                continue
            t = line[0]
            toks = _ascii_tokens(line)
            if t == "1":  # schema file header line, ignore
                continue
            if t == "P":
                name = toks.string()
                cur = FileSchema(name)
                vs.filetypes.append(cur)
            elif t == "S":
                cur.secondary.append(toks.string())
            elif t in "GOD":
                c = toks.char()
                n = toks.int()
                types = [NAME_TYPE[toks.string()] for _ in range(n)]
                cur.add_line(t, c, types, toks.comment())
            else:
                _die("unrecognized schema line starting with %s", t)
        return vs

    def find(self, filetype):
        for fs in self.filetypes:
            if fs.primary == filetype:
                return fs, None
            if filetype in fs.secondary:
                return fs, filetype
        return None, None


class _ascii_tokens:
    """Tokenizer over one ASCII ONE line (after the linetype char)."""

    def __init__(self, line):
        self.s = line
        self.i = 1

    def _skip(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def int(self):
        self._skip()
        j = self.i
        while j < len(self.s) and self.s[j] not in " \n":
            j += 1
        v = int(self.s[self.i:j])
        self.i = j
        return v

    def real(self):
        self._skip()
        j = self.i
        while j < len(self.s) and self.s[j] not in " \n":
            j += 1
        v = float(self.s[self.i:j])
        self.i = j
        return v

    def char(self):
        self._skip()
        c = self.s[self.i]
        self.i += 1
        return c

    def string(self):
        n = self.int()
        self.i += 1  # single separator space
        v = self.s[self.i:self.i + n]
        self.i += n
        return v

    def comment(self):
        if self.i < len(self.s) and self.s[self.i] == " ":
            return self.s[self.i + 1:]
        return None


# ------------------------------------------------------------------
# universal header/footer line types (ONElib.c:288-305)
# ------------------------------------------------------------------

UNIVERSAL = {
    "1": [STRING, INT, INT],
    "2": [STRING],
    "#": [CHAR, INT],
    "@": [CHAR, INT],
    "+": [CHAR, INT],
    "%": [CHAR, CHAR, CHAR, INT],
    "!": [STRING_LIST],
    "<": [STRING, INT],
    ">": [STRING],
    "~": [CHAR, CHAR, STRING_LIST],
    ".": [],
    "$": [INT],
    "^": [],
    "-": [INT],
    "&": [INT_LIST],
    "*": [INT_LIST],
    ";": [CHAR, STRING],
    "/": [STRING],
}


def _fresh_info(t, types, comment=None):
    vi = OneInfo(types, t)
    vi.comment = comment
    return vi


class OneFile:
    """One ONE-code file handle (read or write)."""

    def __init__(self):
        self.f = None
        self.is_write = False
        self.is_binary = False
        self.is_big = False
        self.file_type = ""
        self.sub_type = ""
        self.info = {}
        self.object_type = None
        self.group_type = None
        self.provenance = []   # (program, version, command, date)
        self.line = 0
        self.lineType = None
        self.fields = []
        self.list_data = None
        self.comment_buf = None
        self.is_last_line_binary = True
        self.is_header_out = False
        self.object = 0
        self.group = 0
        self.object_index = []
        self.group_index = []
        self.codec_training_size = 100000
        self.in_group = False
        self.is_index_in = False
        self._start_off = 0
        self._binary_unpack = {}

    # -------------- common setup --------------

    def _setup(self, schema: OneSchema, filetype: str):
        fs, sub = schema.find(filetype)
        if fs is None:
            return False
        self.file_type = fs.primary
        self.sub_type = sub or ""
        self.object_type = fs.object_type
        self.group_type = fs.group_type
        for t, types in UNIVERSAL.items():
            self.info[t] = _fresh_info(t, types)
        for t, vi in fs.info.items():
            nv = _fresh_info(t, vi.field_types, vi.comment)
            self.info[t] = nv
        for t, vi in self.info.items():
            if vi.binary_type_pack:
                self._binary_unpack[vi.binary_type_pack] = t
                self._binary_unpack[vi.binary_type_pack | 1] = t
        return True

    # ============== WRITE side ==============

    @classmethod
    def open_write_new(cls, path, schema: OneSchema, filetype: str,
                       is_binary=True):
        vf = cls()
        if not vf._setup(schema, filetype):
            return None
        if hasattr(path, "write"):
            vf.f = path
        else:
            vf.f = open(path, "wb") if path != "-" else sys.stdout.buffer
        vf.is_write = True
        vf.is_binary = is_binary
        vf.is_last_line_binary = True  # no newline before first true line
        return vf

    def add_provenance(self, prog, version, command, date=None):
        if date is None:
            date = time.strftime("%Y-%m-%d_%H:%M:%S", time.localtime())
        self.provenance.append((prog, version, command, date))
        self.info["!"].accum_count += 1

    def _w(self, s):
        self.f.write(s.encode("latin1") if isinstance(s, str) else s)

    def _write_info_spec(self, t):
        vi = self.info[t]
        kind = ("G" if t == self.group_type
                else "O" if t == self.object_type else "D")
        self._w("\n~ %s %s %d" % (kind, t, len(vi.field_types)))
        for ft in vi.field_types:
            name = TYPE_NAME[ft]
            self._w(" %d %s" % (len(name), name))
        if vi.comment is not None:
            self._w(" %s" % vi.comment)  # oneWriteComment, ASCII mode

    def write_header(self):
        self.is_last_line_binary = False  # header is ASCII
        self._w("1 %d %s %d %d" % (len(self.file_type), self.file_type,
                                   MAJOR, MINOR))
        self.line += 1
        if self.sub_type:
            self._w("\n2 %d %s" % (len(self.sub_type), self.sub_type))
            self.line += 1
        for p in self.provenance:
            self._w("\n! 4" + "".join(" %d %s" % (len(x), x) for x in p))
            self.line += 1
        self._w("\n.")
        if self.group_type:
            self._write_info_spec(self.group_type)
        if self.object_type:
            self._write_info_spec(self.object_type)
        for o in range(ord("A"), ord("z") + 1):
            t = chr(o)
            if (t.isalnum() and t in self.info and t != self.object_type
                    and t != self.group_type):
                self._write_info_spec(t)
        if self.is_binary:
            self._w("\n$ %d" % int(self.is_big))
            self.line += 1
        else:
            self._w("\n.")
            # fresh writes have no given counts, so nothing more to add
        self.is_header_out = True

    def write_comment(self, comment: str):
        if self.is_last_line_binary:
            self.write_line("/", [], comment.encode("latin1"))
        else:
            self._w(" %s" % comment)

    def write_line(self, t, fields, data=None):
        """fields: non-list field values in order (list fields take their
        length automatically).  data: bytes (STRING/DNA), list[int]
        (INT_LIST), list[float], or list[str] (STRING_LIST)."""
        vi = self.info[t]
        self.line += 1
        vi.accum_count += 1
        if t == self.group_type:
            self.group += 1
            self._update_group_count(True)

        # assemble the full field vector
        fvec = []
        fi = 0
        list_len = 0
        if vi.list_elt_size:
            ft = vi.field_types[vi.list_field]
            if ft in (STRING, DNA):
                list_len = len(data)
            elif ft in (INT_LIST, REAL_LIST, STRING_LIST):
                list_len = len(data)
        for i, ftype in enumerate(vi.field_types):
            if i == vi.list_field:
                fvec.append(list_len)
            else:
                fvec.append(fields[fi])
                fi += 1

        if self.is_binary:
            self._write_binary(t, vi, fvec, data, list_len)
        else:
            self._write_ascii(t, vi, fvec, data, list_len)

    def _write_binary(self, t, vi, fvec, data, list_len):
        f = self.f
        if not self.is_last_line_binary:
            f.write(b"\n")
        if t == self.object_type:
            self.object_index.append(f.tell())
            self.object += 1
        if t == self.group_type:
            if len(self.group_index) < self.group:
                self.group_index.extend(
                    [0] * (self.group - len(self.group_index)))
            self.group_index[self.group - 1] = self.object

        x = vi.binary_type_pack
        if vi.is_use_list_codec:
            x |= 0x01
        f.write(bytes([x]))

        for i, ftype in enumerate(vi.field_types):
            if ftype == REAL:
                f.write(struct.pack("<d", fvec[i]))
            elif ftype == CHAR:
                f.write(fvec[i].encode("latin1")
                        if isinstance(fvec[i], str) else bytes([fvec[i]]))
            else:
                f.write(int_put(int(fvec[i])))

        if vi.list_elt_size and list_len > 0:
            vi.accum_total += list_len
            if list_len > vi.accum_max:
                vi.accum_max = list_len
            ft = vi.field_types[vi.list_field]
            if ft == INT_LIST:
                vals = [int(v) for v in data]
                f.write(int_put(vals[0]))
                payload, list_bytes = _compact_int_list(vals)
                f.write(bytes([list_bytes]))
                eff_len = list_len - 1
            elif ft == REAL_LIST:
                payload = np.asarray(data, "<f8").tobytes()
                list_bytes = vi.list_elt_size
                eff_len = list_len
            elif ft == STRING_LIST:  # written as ASCII below (ONElib.c:2064)
                payload = b""
                list_bytes = vi.list_elt_size
                eff_len = 0
            else:
                payload = data if isinstance(data, (bytes, bytearray)) \
                    else bytes(data)
                list_bytes = vi.list_elt_size
                eff_len = list_len
            if ft == STRING_LIST:
                self._write_string_list_ascii(vi, data)
            elif x & 0x1:
                if vi.list_codec == DNA_CODEC:
                    nbits, enc = compress_dna(payload)
                else:
                    nbits, enc = vi.list_codec.encode(bytes(payload))
                f.write(int_put(nbits))
                f.write(enc[:(nbits + 7) >> 3])
            else:
                f.write(bytes(payload))
                if vi.list_codec is not None and vi.list_codec != DNA_CODEC:
                    size = eff_len * list_bytes
                    vi.list_codec.add(bytes(payload))
                    vi.list_tack += size
                    if vi.list_tack > self.codec_training_size:
                        vi.list_codec.create_codec(1)
                        vi.is_use_list_codec = True
        self.is_last_line_binary = True

    def _write_string_list_ascii(self, vi, strings):
        tot = 0
        for s in strings:
            b = s.encode("latin1") if isinstance(s, str) else s
            tot += len(b)
            self._w(" %d " % len(b))
            self._w(b)
        vi.accum_total += tot
        if tot > vi.accum_max:
            vi.accum_max = tot

    def _write_ascii(self, t, vi, fvec, data, list_len):
        if not self.is_last_line_binary:
            self._w("\n")
        self._w(t)
        for i, ftype in enumerate(vi.field_types):
            if ftype == INT:
                self._w(" %d" % int(fvec[i]))
            elif ftype == REAL:
                self._w(" %f" % fvec[i])
            elif ftype == CHAR:
                self._w(" %s" % fvec[i])
            else:
                vi.accum_total += list_len
                if list_len > vi.accum_max:
                    vi.accum_max = list_len
                self._w(" %d" % list_len)
                if ftype in (STRING, DNA):
                    self._w(" ")
                    self._w(data if isinstance(data, (bytes, bytearray))
                            else data.encode("latin1"))
                elif ftype == INT_LIST:
                    for v in data:
                        self._w(" %d" % int(v))
                elif ftype == REAL_LIST:
                    for v in data:
                        self._w(" %f" % v)
                else:
                    self._write_string_list_ascii(vi, data)
        self.is_last_line_binary = False

    def _update_group_count(self, is_group_line: bool):
        """updateGroupCount (ONElib.c:714-739): per-group maxima for the
        uppercase data types, folded at each group start and at close."""
        for o in range(ord("A"), ord("Z") + 1):
            vi = self.info.get(chr(o))
            if vi is None:
                continue
            if self.in_group:
                vi.gmax_count = max(vi.gmax_count,
                                    vi.accum_count - vi.g_count)
                vi.gmax_total = max(vi.gmax_total,
                                    vi.accum_total - vi.g_total)
            vi.g_count = vi.accum_count
            vi.g_total = vi.accum_total
        if is_group_line:
            self.in_group = True

    def _write_footer(self):
        f = self.f
        foot_off = f.tell()
        self._update_group_count(False)  # close the last group
        order = [chr(o) for o in range(ord("A"), ord("Z") + 1)]
        if self.group_type:
            order.append(self.group_type)
        for t in order:
            vi = self.info.get(t)
            if vi is None or vi.accum_count == 0:
                continue
            self._w("# %s %d\n" % (t, vi.accum_count))
            if vi.list_elt_size:
                self._w("@ %s %d\n" % (t, vi.accum_max))
                self._w("+ %s %d\n" % (t, vi.accum_total))
            if (self.group_type and t != self.group_type and self.group > 0):
                self._w("%% %s # %s %d\n" % (self.group_type, t,
                                              vi.gmax_count))
                if vi.list_elt_size:
                    self._w("%% %s + %s %d\n" % (self.group_type, t,
                                                  vi.gmax_total))
            if (vi.is_use_list_codec and vi.list_codec != DNA_CODEC):
                self.write_line(";", [t], vi.list_codec.serialize())
        vi = self.info["/"]
        if vi.is_use_list_codec:
            self.write_line(";", ["/"], vi.list_codec.serialize())
        self.write_line("&", [], self.object_index)
        if self.group_type and self.group > 0:
            gi = self.group_index + [self.object]
            self.write_line("*", [], gi)
        self._w("^\n")
        f.write(struct.pack("<q", foot_off))

    def close(self):
        if self.is_write:
            self.f.write(b"\n")  # end of data marker
            if self.is_binary:
                self._write_footer()
        if self.f not in (sys.stdout.buffer,):
            self.f.close()

    # ============== READ side ==============

    @classmethod
    def open_read(cls, path, schema: OneSchema, filetype: str):
        if hasattr(path, "read"):
            f = path
            path = getattr(path, "name", "<stream>")
        else:
            try:
                f = open(path, "rb")
            except OSError:
                return None
        first = f.readline().decode("latin1")
        if not first:
            sys.stderr.write("ONE file error %s: file is empty\n" % path)
            return None
        if first[0] != "1":
            sys.stderr.write("ONE file error %s: no header line\n" % path)
            return None
        toks = _ascii_tokens(first)
        name = toks.string()
        major, minor = toks.int(), toks.int()
        if major != MAJOR or minor > MINOR:
            sys.stderr.write("ONE file error %s: version mismatch\n" % path)
            return None
        vf = cls()
        if not vf._setup(schema, name):
            sys.stderr.write("ONE file error %s: failed to create OneFile "
                             "object\n" % path)
            return None
        if (filetype and filetype != vf.file_type
                and filetype != vf.sub_type):
            sys.stderr.write("ONE file error %s: fileType mismatch file %s "
                             "!= requested %s\n" % (path, vf.file_type,
                                                    filetype))
            return None
        vf.f = f
        vf.line = 1
        vf._read_header()
        return vf

    def _peek(self):
        b = self.f.read(1)
        if b:
            self.f.seek(-1, 1)
        return b

    def _read_header(self):
        while True:
            b = self._peek()
            if not b:
                break
            peek = b[0]
            if peek & 0x80:
                peek = ord(self._binary_unpack.get(peek, "\0"))
            if chr(peek).isalpha():
                break
            if self.read_line() is None:
                break
            t = self.lineType
            if t == "2":
                self.sub_type = self.one_string()
            elif t == "~":
                c = self.one_char(1)
                kind = self.one_char(0)
                types = [NAME_TYPE[s] for s in self.one_string_list()]
                if c in self.info:
                    if self.info[c].field_types != types:
                        _die("schema mismatch linetype %s", c)
                else:
                    vi = _fresh_info(c, types)
                    self.info[c] = vi
                    if kind == "G":
                        self.group_type = c
                    elif kind == "O":
                        self.object_type = c
                    if vi.binary_type_pack:
                        self._binary_unpack[vi.binary_type_pack] = c
                        self._binary_unpack[vi.binary_type_pack | 1] = c
            elif t in "#@+":
                c = self.one_char(0)
                vi = self.info.get(c)
                if vi is None:
                    _die("unknown line type %s", c)
                v = self.one_int(1)
                if t == "#":
                    vi.given_count = v
                elif t == "@":
                    vi.given_max = v
                else:
                    vi.given_total = v
            elif t == "%":
                pass
            elif t == "!":
                sl = self.one_string_list()
                self.provenance.append(tuple(sl))
            elif t in "<>.":
                pass
            elif t == "$":
                if self.one_int(0) != int(self.is_big):
                    _die("endian mismatch - convert file to ascii")
                self.is_binary = True
                self._start_off = self.f.tell()
                self.f.seek(-8, 2)
                foot_off = struct.unpack("<q", self.f.read(8))[0]
                self.f.seek(foot_off)
            elif t == "^":
                self.f.seek(self._start_off)
            elif t == "&":
                self.object_index = list(self.one_int_list())
                self.is_index_in = True
            elif t == "*":
                self.group_index = list(self.one_int_list())
            elif t == ";":
                c = self.one_char(0)
                self.info[c].list_codec = HuffCodec.deserialize(
                    self.one_string_bytes())
            else:
                _die("unknown header line type %s", t)

    # -------------- random access (binary files with footer index) -------

    def goto_object(self, i: int) -> bool:
        """oneGotoObject (ONElib.c:1491-1499): position so the next
        read_line returns object i's first line (0-based).  Requires a
        binary file whose footer object index was read."""
        if (self.is_index_in and self.object_type
                and 0 <= i < len(self.object_index)):
            self.f.seek(self.object_index[i])
            self.object = i
            return True
        return False

    def goto_group(self, i: int):
        """oneGotoGroup (ONElib.c:1501-1509): position at group i's first
        object; returns the group's object count, 0 on failure.  The '*'
        footer list holds each group's first object index plus a final
        end-of-objects sentinel."""
        if (self.is_index_in and self.group_type
                and 0 <= i < len(self.group_index) - 1):
            if not self.goto_object(self.group_index[i]):
                return 0
            return self.group_index[i + 1] - self.group_index[i]
        return 0

    def read_line(self):
        """Returns the line type char, or None at end of data."""
        self.comment_buf = None
        b = self.f.read(1)
        if not b or b == b"\n":
            self.lineType = None
            return None
        x = b[0]
        self.line += 1
        if x & 0x80:
            t = self._binary_unpack.get(x)
            if t is None:
                _die("unknown binary line code %d", x)
            self.lineType = t
            vi = self.info[t]
            vi.accum_count += 1
            if t == self.object_type:
                self.object += 1
            self._read_binary_line(t, vi, x)
        else:
            t = chr(x)
            vi = self.info.get(t)
            if vi is None:
                _die("unknown line type %s line %d", t, self.line)
            self.lineType = t
            vi.accum_count += 1
            if t == self.object_type:
                self.object += 1
            self._read_ascii_line(t, vi)
        return self.lineType

    def _read_ascii_line(self, t, vi):
        rest = b""
        while True:
            c = self.f.read(1)
            if not c or c == b"\n":
                break
            rest += c
        toks = _ascii_tokens(t + rest.decode("latin1"))
        self.fields = []
        self.list_data = None
        for ftype in vi.field_types:
            if ftype == INT:
                self.fields.append(toks.int())
            elif ftype == REAL:
                self.fields.append(toks.real())
            elif ftype == CHAR:
                self.fields.append(toks.char())
            elif ftype in (STRING, DNA):
                s = toks.string()
                self.fields.append(len(s))
                self.list_data = s.encode("latin1")
            elif ftype == INT_LIST:
                n = toks.int()
                self.fields.append(n)
                self.list_data = [toks.int() for _ in range(n)]
            elif ftype == REAL_LIST:
                n = toks.int()
                self.fields.append(n)
                self.list_data = [toks.real() for _ in range(n)]
            else:  # STRING_LIST
                n = toks.int()
                self.fields.append(n)
                self.list_data = [toks.string() for _ in range(n)]
        c = toks.comment()
        if c is not None:
            self.comment_buf = c

    def _read_binary_line(self, t, vi, x):
        f = self.f
        self.fields = []
        self.list_data = None
        for ftype in vi.field_types:
            if ftype == REAL:
                self.fields.append(struct.unpack("<d", f.read(8))[0])
            elif ftype == CHAR:
                self.fields.append(f.read(1).decode("latin1"))
            else:
                self.fields.append(ltf_read(f))
        if t == self.group_type and self.group_index:
            self.fields[0] = (self.group_index[self.group + 1]
                              - self.group_index[self.group])
        if t == self.group_type:
            self.group += 1
        if vi.list_elt_size:
            ft = vi.field_types[vi.list_field]
            list_len = self.fields[vi.list_field]
            if list_len > 0:
                vi.accum_total += list_len
                if list_len > vi.accum_max:
                    vi.accum_max = list_len
                if ft == INT_LIST:
                    first = ltf_read(f)
                    used = f.read(1)[0]
                    eff = list_len - 1
                else:
                    used = vi.list_elt_size
                    eff = list_len
                if ft == STRING_LIST:
                    # stored as ASCII " len str" pairs
                    out = []
                    for _ in range(list_len):
                        tok = b""
                        c = f.read(1)
                        while c == b" ":
                            c = f.read(1)
                        while c not in (b" ", b""):
                            tok += c
                            c = f.read(1)
                        n = int(tok)
                        out.append(f.read(n).decode("latin1"))
                    self.list_data = out
                elif x & 0x1:
                    nbits = ltf_read(f)
                    raw = f.read((nbits + 7) >> 3)
                    if vi.list_codec == DNA_CODEC:
                        payload = uncompress_dna(raw, nbits >> 1)
                    else:
                        payload = vi.list_codec.decode(nbits, raw)
                    self.list_data = self._expand_list(ft, payload, first
                                                       if ft == INT_LIST
                                                       else None, used,
                                                       list_len)
                else:
                    raw = f.read(eff * used)
                    self.list_data = self._expand_list(
                        ft, raw, first if ft == INT_LIST else None, used,
                        list_len)
            else:
                self.list_data = (b"" if ft in (STRING, DNA) else [])
        # peek for a trailing binary comment line
        b = self._peek()
        if b:
            peek = b[0]
            pt = self._binary_unpack.get(peek) if peek & 0x80 else chr(peek)
            if pt == "/":
                keep_t, keep_fields, keep_list = (self.lineType, self.fields,
                                                  self.list_data)
                self.read_line()
                comment = self.list_data
                self.lineType, self.fields, self.list_data = (
                    keep_t, keep_fields, keep_list)
                self.comment_buf = (comment.decode("latin1")
                                    if isinstance(comment, bytes) else comment)

    @staticmethod
    def _expand_list(ft, payload, first, used, list_len):
        if ft in (STRING, DNA):
            return bytes(payload)
        if ft == INT_LIST:
            # decompactIntList (ONElib.c:803-845): sign-extend + prefix sum
            vals = [first]
            for i in range(list_len - 1):
                chunk = payload[i * used:(i + 1) * used]
                v = int.from_bytes(chunk, "little")
                if used < 8 and chunk and (chunk[-1] & 0x80):
                    v |= (-1 << (8 * used))
                vals.append(v)
            for i in range(1, len(vals)):
                vals[i] += vals[i - 1]
            return vals
        if ft == REAL_LIST:
            return list(np.frombuffer(payload, "<f8"))
        return payload

    # -------------- accessors --------------

    def one_int(self, i):
        return self.fields[i]

    def one_real(self, i):
        return self.fields[i]

    def one_char(self, i):
        return self.fields[i]

    def one_len(self):
        for i, v in enumerate(self.info[self.lineType].field_types):
            if v in LIST_TYPES:
                return self.fields[i]
        return 0

    def one_string(self):
        d = self.list_data
        return d.decode("latin1") if isinstance(d, bytes) else d

    def one_string_bytes(self):
        return self.list_data

    def one_int_list(self):
        return self.list_data

    def one_string_list(self):
        return self.list_data

    def read_comment(self):
        return self.comment_buf


def _compact_int_list(vals):
    """compactIntList (ONElib.c:749-801): returns (payload bytes, usedBytes);
    payload covers elements 1..n-1 as diffs truncated to usedBytes each."""
    diffs = [vals[i] - vals[i - 1] for i in range(1, len(vals))]
    mask = 0
    for d in diffs:
        mask |= d if d >= 0 else -(d + 1)
    mask >>= 7
    used = 1
    while used < 8 and mask:
        mask >>= 8
        used += 1
    out = bytearray()
    for d in diffs:
        out += struct.pack("<q", d)[:used]
    return bytes(out), used


# ------------------------------------------------------------------
# seqio integration: the embedded 'seq' schema (seqio.c:350-364)
# ------------------------------------------------------------------

SEQ_SCHEMA_TEXT = (
    "1 3 def 1 0  schema for seqio\n"
    ".\n"
    "P 3 seq SEQUENCE\n"
    "S 3 irp   read pairs\n"
    "S 3 pbr   pacbio reads\n"
    "S 3 10x   10X Genomics data\n"
    "S 3 ctg   contigs from an assembly\n"
    "S 3 kmr   kmers\n"
    "D g 2 3 INT 6 STRING  group: count, name (e.g. use for flow cell/lane"
    " grouping)\n"
    "D S 1 3 DNA           sequence: the DNA string\n"
    "D I 1 6 STRING        id: (optional) sequence identifier\n"
    "D Q 1 6 STRING        quality: Q values (ascii string = q+33)\n")

_seq_schema = None


def seq_schema() -> OneSchema:
    global _seq_schema
    if _seq_schema is None:
        _seq_schema = OneSchema.from_text(SEQ_SCHEMA_TEXT)
    return _seq_schema


def read_one_seq(data: bytes, convert, is_qual, want_ids):
    """ONE path of seqIOopenRead/seqIOread (seqio.c:110-131,237-264).

    NB the reference's ONE reader never stores 'I' id lines, so ids come
    back empty; we reproduce that."""
    import io as _io
    from .seqio import SeqBatch, _full256
    vf = OneFile.open_read(_io.BytesIO(data), seq_schema(), "seq")
    if vf is None:
        raise IOError("failed to open ONE seq stream")
    seqs = []
    quals = []
    cur_q = None
    t = vf.read_line()
    while t is not None and t != "S":
        t = vf.read_line()
    while t == "S":
        seqs.append(vf.list_data)
        cur_q = None
        t = vf.read_line()
        while t is not None and t != "S":
            if t == "Q" and is_qual:
                cur_q = vf.list_data
            t = vf.read_line()
        quals.append(cur_q)
    lens = np.array([len(s) for s in seqs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    if seqs:
        codes = np.frombuffer(b"".join(seqs), np.uint8)
    else:
        codes = np.zeros(0, np.uint8)
    if convert is not None:
        codes = _full256(convert)[codes].astype(np.int16)
        if (codes >= 0).all():
            codes = codes.astype(np.uint8)
    qarr = None
    if is_qual and any(q is not None for q in quals):
        qs = [(np.frombuffer(q, np.uint8) - 33).astype(np.uint8)
              if q is not None else np.zeros(l, np.uint8)
              for q, l in zip(quals, lens)]
        qarr = np.concatenate(qs) if qs else np.zeros(0, np.uint8)
    ids = [""] * len(seqs) if want_ids else None
    descs = [None] * len(seqs) if want_ids else None
    return SeqBatch(codes=codes, offsets=offsets, ids=ids, descs=descs,
                    quals=qarr)




class ParallelOneSeqWriter:
    """Parallel writing of ONE .1seq file — the green-field equivalent of
    ONElib's master/slave threaded file handles (ONElib.c:1394-1412,
    1544-1575, 2104-2128), which let nthreads writers share one file with
    mutex-guarded codec training.

    Design difference, deliberate: the reference's codec trains on whatever
    data the racing slaves accumulate first, so its output depends on
    thread timing.  Here each worker's codec state is *seeded* with the
    exact cumulative histogram/byte-count its section would see in file
    order, so training fires at the same line and builds the same codec as
    a sequential write — the output is byte-identical to OneSeqWriter,
    deterministically, for any worker count.

    Workers encode contiguous record sections into memory buffers
    concurrently; the master stitches sections, rebases the object index,
    merges the per-linetype stats, and writes the footer."""

    @staticmethod
    def write(path_or_f, records, is_qual=False, n_threads=4,
              filetype="seq", provenance_cmd=None):
        """records: sequence of (seq_id, desc, seq_bytes, qual_or_None)."""
        import concurrent.futures
        import io as _io

        records = list(records)
        master = OneFile.open_write_new(path_or_f, seq_schema(), filetype,
                                        is_binary=True)
        cmd = (provenance_cmd if provenance_cmd is not None
               else (" ".join(sys.argv) if sys.argv else "-"))
        master.add_provenance("seqio", "1.0", cmd or "-")
        master.write_header()

        n_threads = max(1, min(n_threads, len(records) or 1))
        bounds = [len(records) * i // n_threads
                  for i in range(n_threads + 1)]

        def lines_of(rec):
            seq_id, desc, seq, qual = rec
            if isinstance(seq, str):
                seq = seq.encode("latin1")
            out = [("S", None, seq)]
            if seq_id:
                out.append(("I", None, seq_id.encode("latin1")))
                if desc:
                    out.append(("/", None, desc.encode("latin1")))
            if qual is not None and is_qual:
                q = (np.asarray(qual, np.int16) + 33).astype(np.uint8)
                out.append(("Q", None, q.tobytes()))
            return out

        # cumulative codec state (hist + trained bytes) at each section
        # start, per trainable linetype — the seed that makes worker w see
        # exactly the file-order prefix the sequential writer would
        seeds = [dict() for _ in range(n_threads)]
        state = {}
        for w in range(n_threads):
            for t, (h, tack, fired) in state.items():
                seeds[w][t] = (h.copy(), tack, fired)
            for rec in records[bounds[w]:bounds[w + 1]]:
                for t, _f, data in lines_of(rec):
                    vi = master.info[t]
                    if vi.list_codec is DNA_CODEC or not vi.list_elt_size:
                        continue
                    h, tack, fired = state.get(
                        t, (np.zeros(256, np.uint64), 0, False))
                    if not fired:
                        h = h + np.bincount(
                            np.frombuffer(data, np.uint8),
                            minlength=256).astype(np.uint64)
                        tack += len(data)
                        if tack > master.codec_training_size:
                            fired = True
                    state[t] = (h, tack, fired)

        def write_section(w):
            buf = _io.BytesIO()
            vf = OneFile.open_write_new(buf, seq_schema(), filetype,
                                        is_binary=True)
            vf.is_header_out = True
            vf.is_last_line_binary = (w != 0)  # header above ends in ASCII
            for t, (h, tack, fired) in seeds[w].items():
                vi = vf.info[t]
                if fired:
                    c = HuffCodec()
                    c.hist = h.copy()
                    c.create_codec(1)
                    vi.list_codec = c
                    vi.is_use_list_codec = True
                else:
                    c = HuffCodec()
                    c.hist = h.copy()
                    if h.any():
                        c.state = HuffCodec.FILLED
                    vi.list_codec = c
                    vi.list_tack = tack
            for rec in records[bounds[w]:bounds[w + 1]]:
                for t, _f, data in lines_of(rec):
                    if t == "/":
                        vf.write_comment(data.decode("latin1"))
                    else:
                        vf.write_line(t, [], data)
            return vf, buf.getvalue()

        base = master.f.tell()
        with concurrent.futures.ThreadPoolExecutor(n_threads) as ex:
            parts = list(ex.map(write_section, range(n_threads)))

        for vf, blob in parts:
            for i in vf.object_index:
                master.object_index.append(base + i)
            master.object += vf.object
            for t, vi in vf.info.items():
                mi = master.info[t]
                mi.accum_count += vi.accum_count
                mi.accum_total += vi.accum_total
                mi.accum_max = max(mi.accum_max, vi.accum_max)
                if vi.is_use_list_codec and not mi.is_use_list_codec:
                    mi.list_codec = vi.list_codec
                    mi.is_use_list_codec = True
            master.f.write(blob)
            base += len(blob)
            master.is_last_line_binary = vf.is_last_line_binary
        master.info["!"].accum_count = 1  # counted once, in the header
        master.close()


class OneSeqWriter:
    """ONE path of seqIOopenWrite/seqIOwrite (seqio.c:381-397,476-503)."""

    def __init__(self, f, is_qual, filetype="seq"):
        self.vf = OneFile.open_write_new(f, seq_schema(), filetype,
                                         is_binary=True)
        self.is_qual = is_qual
        cmd = " ".join(sys.argv) if sys.argv else "-"
        self.vf.add_provenance("seqio", "1.0", cmd or "-")
        self.vf.write_header()

    def write(self, seq_id, desc, seq, qual=None):
        if isinstance(seq, str):
            seq = seq.encode("latin1")
        self.vf.write_line("S", [], seq)
        if seq_id:
            self.vf.write_line("I", [], seq_id.encode("latin1"))
            if desc:
                self.vf.write_comment(desc)
        if qual is not None and self.is_qual:
            q = (np.asarray(qual, np.int16) + 33).astype(np.uint8)
            self.vf.write_line("Q", [], q.tobytes())

    def close(self):
        self.vf.close()
