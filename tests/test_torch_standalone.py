"""The port stands alone: no module of ``modimizer_tpu_torch`` (and not
``chip_smoke.py``) imports jax or the JAX package (the subprocess also
runs the mesh modules, ``parallel/mesh.py``, ``ops/route.py`` and
``ops/merge.py``, through ``sharded_merge``), and the port's copies of
the host modules (``core``, ``io``, ``native``, ``utils``, ``cli``, the
scanner's host methods) behave as the JAX package's originals: Seqhash
fields, ``scan_bo``, the sequence readers, the native host scan and the
``MODIMIZER_SCAN=host`` CLI's ``.mod`` bytes, the ``Array``/``DICT``
containers of ``io/carray``, and the four host-only CLIs (composition,
modtype, seqconvert, seqhoco) byte for byte against the JAX package's.  Also the constants of the division-free emit
test that ``csrc/scan_compact.cu`` takes, emulated with Python ints against
``h % w == 0``, and ``MODIMIZER_BLK`` refused above the kernel's limit."""

import ast
import gzip
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import modimizer_tpu

modimizer_tpu.configure_jax()

from modimizer_tpu.cli import modutils as jax_cli  # noqa: E402
from modimizer_tpu.core.seqhash import Seqhash as JaxSeqhash  # noqa: E402
from modimizer_tpu.io import carray as jax_carray  # noqa: E402
from modimizer_tpu.io import seqio as jax_seqio  # noqa: E402
from modimizer_tpu.io import stream_seq as jax_stream  # noqa: E402
from modimizer_tpu.ops import seqhash as jax_ops  # noqa: E402
from modimizer_tpu_torch.cli import modutils as port_cli  # noqa: E402
from modimizer_tpu_torch.core.seqhash import Seqhash  # noqa: E402
from modimizer_tpu_torch.io import carray  # noqa: E402
from modimizer_tpu_torch.io import seqio, stream_seq  # noqa: E402
from modimizer_tpu_torch.ops import seqhash as port_ops  # noqa: E402
from modimizer_tpu_torch.ops.packed import emit_test  # noqa: E402
from tests.util import random_fasta, random_fastq, strip_timing  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                    (REPO / "modimizer_tpu_torch").rglob("*.py")
                    ) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "modimizer_tpu")
IMPORTERS = ("import_module", "__import__", "run_module")


def _forbidden(name):
    return name is not None and name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_neither_jax_nor_the_jax_package(rel):
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            arg = node.args[0]
            if (name in IMPORTERS and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) and _forbidden(arg.value)):
                bad.append(arg.value)
    assert not bad, "%s imports %s" % (rel, bad)


_NO_JAX = r"""
import importlib, os, pkgutil, sys
import modimizer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(modimizer_tpu_torch.__path__,
                                              "modimizer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("parallel.mesh", "ops.route", "ops.merge", "parallel.multihost",
             "ops.minimizer", "parallel.chain", "cli.composition",
             "cli.modtype", "cli.seqconvert", "cli.seqhoco"):
    assert "modimizer_tpu_torch." + name in names, name
from modimizer_tpu_torch.cli import modasm, modmap, modrep, modutils
modutils.main(sys.argv[1:], device="cpu")
modmap.main(["-K", "16", "-W", "13", "-f", "g.fa", "-q", "r.fa"],
            device="cpu")
os.environ["MODIMIZER_OVERLAPS"] = "device"
modasm.main(["-m", "p.mod", "-f", "r.fa", "-S", "-b", "-u"], device="cpu")
modrep.main(["-R", "g.fa", "p.mod", "-s2", "r.fa", "p.mod"], device="cpu")
from modimizer_tpu_torch.core.modset import Modset
from modimizer_tpu_torch.parallel.mesh import build_mesh
from modimizer_tpu_torch.parallel.sharded import sharded_merge
ms = Modset.read("p.mod")
assert sharded_merge(ms, ms, build_mesh("cpu"))[0].tolist() == \
    ms.value[1:ms.max + 1].tolist()
import numpy as np
from modimizer_tpu_torch.core.seqhash import Seqhash
from modimizer_tpu_torch.ops.minimizer import minimizer_scan
from modimizer_tpu_torch.parallel.chain import chain_records
from modimizer_tpu_torch.parallel.multihost import MultiHostModsetBuilder
sh = Seqhash.create(16, 16, 17)
codes = np.random.default_rng(1).integers(0, 4, 3000).astype(np.uint8)
assert len(minimizer_scan(sh, codes, chunk=1024, device="cpu")[1]) > 100
b = MultiHostModsetBuilder(sh, build_mesh("cpu"), chunk_per_dev=1 << 12)
b.feed_stream(codes, np.array([0, 3000]))
assert len(b.finalize()[0]) > 100


class Ref:
    rev = loc = np.arange(40, dtype=np.uint32)
    id = np.zeros(40, np.uint32)
    class ms:
        info = np.full(40, 2, np.uint8)


recs = chain_records(Ref, np.arange(1, 9, dtype=np.uint32),
                     np.arange(8) * 10, np.array([0, 8]), device="cpu")
assert recs == [[(0, 70, 1, 8, 0, 8, 1)]], recs
from modimizer_tpu_torch.cli import composition, seqconvert
composition.main(["-b", "r.fa"])
seqconvert.main(["-fq", "-o", "c.fq", "r.fa"])
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "modimizer_tpu")]
assert not bad, bad
sys.stderr.write("STANDALONE_OK %d\n" % len(names))
"""


def test_port_runs_without_jax_or_the_jax_package(tmp_path):
    """Every port module imports, and the four CLIs run on device="cpu",
    with neither jax nor the JAX package in sys.modules."""
    random_fasta(tmp_path / "r.fa", 40, 300, seed=5, genome_len=3000)
    random_fasta(tmp_path / "g.fa", 1, 3000, seed=5, genome_len=3000)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("MODIMIZER_SCAN", None)
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "-c", "20", "16", "16", "17",
         "-a", str(tmp_path / "r.fa"), "-s", "4", "18", "40", "-w",
         str(tmp_path / "p.mod")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "STANDALONE_OK" in r.stderr
    assert int(r.stderr.split("STANDALONE_OK")[1].split()[0]) > 30
    assert "added 40 sequences" in r.stdout
    assert "hashes from 1 reference sequences" in r.stdout     # modmap -f
    assert "\nQ\tread0\t300\t" in r.stdout                   # modmap -q
    assert "RS 40 sequences" in r.stdout                       # modasm -S
    assert "found " in r.stderr and "n1 " in r.stdout          # modrep -s2


# ---- the copies against the originals ----

@pytest.mark.parametrize("k,w,seed", [(16, 16, 17), (19, 31, 17), (1, 1, 3),
                                      (31, 1000, 99), (11, 10, 12345)])
def test_seqhash_create_matches(k, w, seed):
    a, b = Seqhash.create(k, w, seed), JaxSeqhash.create(k, w, seed)
    for f in ("k", "w", "seed", "mask", "shift1", "shift2", "factor1",
              "factor2", "patternRC"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.to_bytes() == b.to_bytes() and a.report() == b.report()


@pytest.mark.parametrize("w", [1, 2, 10, 16, 31, 100, 511, 512, 4096,
                               1 << 40])
def test_scan_bo_matches(w):
    assert port_ops.scan_bo(w) == jax_ops.scan_bo(w)
    assert port_ops.BLK_COMPACT == jax_ops.BLK_COMPACT


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    d = tmp_path_factory.mktemp("standalone_seqs")
    random_fasta(d / "r.fa", 50, 400, seed=1, genome_len=5000)
    random_fastq(d / "r.fq", 30, 200, seed=3)
    (d / "r.fa.gz").write_bytes(gzip.compress((d / "r.fa").read_bytes()))
    (d / "r.fq.gz").write_bytes(gzip.compress((d / "r.fq").read_bytes()))
    return d


@pytest.mark.parametrize("name", ["r.fa", "r.fq", "r.fa.gz", "r.fq.gz"])
@pytest.mark.parametrize("index", [False, True], ids=["text", "index"])
def test_read_seq_file_matches(seqs, name, index):
    conv = (seqio.dna2index_n0(), jax_seqio.dna2index_n0()) if index else (
        None, None)
    got, gt = seqio.read_seq_file(str(seqs / name), conv[0], is_qual=True)
    want, wt = jax_seqio.read_seq_file(str(seqs / name), conv[1],
                                       is_qual=True)
    assert gt == wt
    assert np.array_equal(got.codes, want.codes)
    assert np.array_equal(got.offsets, want.offsets)
    assert got.ids == want.ids and got.descs == want.descs
    assert (got.quals is None) == (want.quals is None)
    if got.quals is not None:
        assert np.array_equal(got.quals, want.quals)


@pytest.mark.parametrize("name", ["r.fa", "r.fq.gz"])
def test_iter_seq_batches_matches(seqs, name):
    got = list(stream_seq.iter_seq_batches(str(seqs / name),
                                           seqio.dna2index_n0()))
    want = list(jax_stream.iter_seq_batches(str(seqs / name),
                                            jax_seqio.dna2index_n0()))
    assert len(got) == len(want) > 0
    for (gc, go), (wc, wo) in zip(got, want):
        assert np.array_equal(gc, wc) and np.array_equal(go, wo)


def _stream(seed, n_reads=80):
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 900, n_reads)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    codes = rng.integers(0, 4, offsets[-1]).astype(np.uint8)
    codes[1000:1300] = 0            # a poly-A run
    return codes, offsets


@pytest.mark.parametrize("k,w", [(16, 16), (19, 31), (5, 3)])
def test_scanner_host_methods_match(k, w):
    sh = JaxSeqhash.create(k, w, 17)
    port = port_ops.ModimizerScanner(sh, chunk=1 << 13, host=True)
    jax = jax_ops.ModimizerScanner(sh, chunk=1 << 13, host_threshold=1 << 62)
    assert port.device is None
    with pytest.raises(RuntimeError, match="host scan alone"):
        port.scan_kmers_batches([(np.zeros(100, np.uint8),
                                  np.array([0, 100], np.int64))])
    assert (port.bo, port.cap, port._wide()) == (jax.bo, jax.cap,
                                                 jax._wide())
    codes, offsets = _stream(k * 100 + w)
    for a, b in zip(port._scan_host(codes, offsets),
                    jax._scan_host(codes, offsets)):
        assert np.array_equal(a, b)
    for a, b in zip(port._rescan_rows(8192, 8192, codes, offsets),
                    jax._rescan_rows(8192, 8192, codes, offsets)):
        assert np.array_equal(a, b)
    batch = jax_seqio.SeqBatch(codes=codes.astype(np.int8), offsets=offsets)
    for a, b in zip(port.scan_batch(batch), jax.scan_batch(batch)):
        assert np.array_equal(a, b)
    kms = port.scan_kmers(codes, offsets)
    assert np.array_equal(kms, jax.scan_kmers(codes, offsets))
    for a, b in zip(port_ops.first_encounter_unique(kms),
                    jax_ops.first_encounter_unique(kms)):
        assert np.array_equal(a, b)
    gpos = np.arange(0, len(codes), 7, dtype=np.int64)
    for a, b in zip(port_ops._validity_filter(gpos, offsets, k),
                    jax_ops._validity_filter(gpos, offsets, k)):
        assert np.array_equal(a, b)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdout, sys.stderr
    try:
        sys.stdout, sys.stderr = out, err
        main([str(a) for a in argv])
    finally:
        sys.stdout, sys.stderr = old
    return strip_timing(out.getvalue())


@pytest.mark.parametrize("params", [["20", "16", "16", "17"],
                                    ["20", "19", "31", "17"]],
                         ids=["k16w16", "k19w31"])
@pytest.mark.parametrize("src", ["r.fa", "r.fq.gz"])
def test_host_path_cli_matches_jax_host_path(seqs, tmp_path, monkeypatch,
                                             params, src):
    """The port's CLI on its own native host scan (MODIMIZER_SCAN=host, no
    device) against the JAX CLI's host path: stdout ('added' lines
    included), .mod, -wt and -H bytes, and -P painting."""
    monkeypatch.setenv("MODIMIZER_SCAN", "host")
    outs = {}
    for tag, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        outs[tag] = _run(main, ["-c"] + params + [
            "-a", seqs / src, "-x", seqs / "r.fq",
            "-w", tmp_path / (tag + ".mod"), "-wt", tmp_path / (tag + ".txt"),
            "-H", tmp_path / (tag + ".his"), "-P", seqs / "r.fa"])
    assert "added 50 sequences" in outs["port"] or src != "r.fa"
    assert "added " in outs["port"] and "painting " in outs["port"]
    assert outs["port"] == outs["jax"]
    for ext in (".mod", ".txt", ".his"):
        assert ((tmp_path / ("port" + ext)).read_bytes()
                == (tmp_path / ("jax" + ext)).read_bytes()), ext


def test_carray_containers_match():
    """io/carray's Array and DICT: the same growth, probe layout and
    serialized bytes as the JAX package's, and each reads the other's."""
    names = ["chr%d" % i for i in range(700)] + ["x" * 40, "chr1 dup"]
    mine, theirs = io.BytesIO(), io.BytesIO()
    for mod, f in ((carray, mine), (jax_carray, theirs)):
        a = mod.CArray(4, 4, np.uint32)
        for i in (0, 3, 9, 1000, 5000):
            a.set(i, np.uint32(i * 7 + 1))
        a.write(f)
        d = mod.CDict(16)
        assert [d.add(n) for n in names] == [(i, True) for i in
                                             range(len(names))]
        assert d.add("chr5") == (5, False) and d.find("nope")[0] is None
        d.write(f)
        mod.CArray.from_values(range(3000), np.int32).write(f)
    assert mine.getvalue() == theirs.getvalue()
    assert carray._hash_string(b"chr20", 11, True) == \
        jax_carray._hash_string(b"chr20", 11, True)
    assert (carray.ARRAY_MAGIC, carray._ARR_HDR.format) == (
        jax_carray.ARRAY_MAGIC, jax_carray._ARR_HDR.format)
    for reader in (carray, jax_carray):
        f = io.BytesIO(theirs.getvalue())
        a = reader.CArray.read(f, np.uint32)
        d = reader.CDict.read(f)
        assert (a.dim, a.max, int(a.get(5000))) == (5001, 5001, 35001)
        assert d.max == len(names) and d.name(701) == "chr1 dup"
        assert d.find("chr699")[0] == 699


@pytest.mark.parametrize("blk,ok", [(32768, True), (65536, False)])
def test_modimizer_blk_above_the_kernel_limit_is_refused(blk, ok):
    """MODIMIZER_BLK is refused at import above 2^15, the most positions
    scan_compact's compaction block takes."""
    env = dict(os.environ, PYTHONPATH=str(REPO), MODIMIZER_BLK=str(blk))
    r = subprocess.run(
        [sys.executable, "-c", "import modimizer_tpu_torch.ops.consts as c; "
         "print(c.BLK_COMPACT, c.MAX_BLK)"],
        env=env, capture_output=True, text=True, timeout=120)
    if ok:
        assert r.returncode == 0 and r.stdout.split() == [str(blk), "32768"]
    else:
        assert r.returncode != 0
        assert ("MODIMIZER_BLK=65536: scan_compact takes at most 32768 "
                "positions a compaction block" in r.stderr)


def test_trace_region_writes_a_torch_profiler_trace(tmp_path, monkeypatch):
    from modimizer_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "_trace_dir", str(tmp_path))
    monkeypatch.setattr(profiling, "_trace_active", [False])
    sh = Seqhash.create(16, 16, 17)
    codes, offsets = _stream(1)
    scanner = port_ops.ModimizerScanner(sh, chunk=1 << 13, device="cpu")
    assert len(scanner.scan_kmers(codes, offsets)) > 0
    traces = list(tmp_path.glob("modimizer_trace.*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    with profiling.trace_region():      # the first call only
        pass
    assert len(list(tmp_path.glob("*.json"))) == 1


# ---- the emit test's constants (ops/packed.emit_test) ----

EMIT_W = [1, 2, 3, 10, 16, 31, (1 << 31) - 1, 1 << 32, (1 << 32) + 1,
          1 << 62, (1 << 64) - 1]


def _holds(h, c, bits):
    """The kernel's predicate with Python ints: rotr(h * minv, rot) <=
    limit in ``bits``-bit words."""
    m = (1 << bits) - 1
    t = (h * c.minv) & m
    r = ((t >> c.rot) | (t << ((bits - c.rot) % bits))) & m
    return r <= c.limit


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("w", EMIT_W)
def test_emit_test_equals_modulo(w, bits):
    c = emit_test(w, bits)
    assert 0 <= c.minv < 1 << bits and 0 <= c.rot < bits
    hs = {0, 1, w - 1, w, w + 1, 2 * w, (1 << 32) - 1, (1 << 62) - 1,
          3 * w, (1 << bits) - 1}
    rng = np.random.default_rng(w % (1 << 32))
    hs |= {int(x) for x in rng.integers(0, 1 << 62, 64, dtype=np.int64)}
    hs |= {w * int(q) for q in rng.integers(0, 1 << 20, 16)}
    for h in sorted(x for x in hs if 0 <= x < 1 << bits):
        assert _holds(h, c, bits) == (h % w == 0), (w, h)


# ---- the four host-only CLIs against the JAX package's ----

class _Bytes:
    """A text stream with a ``buffer``, over one bytes buffer."""

    def __init__(self, b):
        self.buffer = b

    def write(self, s):
        self.buffer.write(s.encode() if isinstance(s, str) else s)

    def flush(self):
        pass


def _run_cli(package, tool, argv):
    """``package.cli.tool.main(argv)``: (exit code, stdout bytes, stderr)."""
    import importlib
    mod = importlib.import_module("%s.cli.%s" % (package, tool))
    out, err = io.BytesIO(), io.BytesIO()
    old = sys.stdout, sys.stderr
    code = 0
    try:
        sys.stdout, sys.stderr = _Bytes(out), _Bytes(err)
        mod.main([str(a) for a in argv])
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.stdout, sys.stderr = old
    return (code, strip_timing(out.getvalue().decode("latin1")),
            strip_timing(err.getvalue().decode("latin1")))


def _one_masked(b: bytes) -> bytes:
    """A ONE file with its provenance timestamp (19 bytes after ' 19 ')
    masked."""
    i = b.find(b" 19 ", 0, 500)
    return b if i < 0 else b[:i + 4] + b"T" * 19 + b[i + 23:]


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_clis")
    random_fasta(d / "r.fa", 40, 350, seed=5, genome_len=4000)
    random_fastq(d / "r.fq", 25, 150, seed=6)
    (d / "r.fq.gz").write_bytes(gzip.compress((d / "r.fq").read_bytes()))
    (d / "homo.fa").write_text(">h1 some desc\nAAAACCCgggTTTTAcgtACGT\n"
                               ">h2\nGGGGGGGGGGAAAAA\n>h3\nacgT\n")
    random_fasta(d / "ref.fa", 3, 4000, seed=4)
    (d / "sites.1ins").write_text(
        "1 3 ins 1 1\nc 0 5 read0\nI 100 200\nI 300 420\n"
        "c 0 5 read2\nI 10 50\n")
    (d / "bad.1ins").write_text("1 3 ins 1 1\nc 0 5 nope1\nI 1 2\n")
    (d / "samples.1smp").write_text(
        "1 3 smp 1 1\nN 2 s1\nF 7 a.fq.gz\nC 30.000000\n"
        "N 5 samp2\nF 7 b.fq.gz\nC 12.500000\n")
    return d


# (tool, arguments, files written); OUT is the run's own output prefix
HOST_CLI_CASES = [
    ("composition", ["-b", "-l", "r.fa"], []),
    ("composition", ["-b", "-q", "r.fq"], []),
    ("composition", ["-b", "-l", "-q", "r.fq.gz"], []),
    ("seqconvert", ["-fq", "-o", "OUT.fq", "r.fa"], ["OUT.fq"]),
    ("seqconvert", ["-fa", "-o", "OUT.fa", "r.fq"], ["OUT.fa"]),
    ("seqconvert", ["-fa", "-z", "-o", "OUT.fa.gz", "r.fq.gz"],
     ["OUT.fa.gz"]),
    ("seqconvert", ["-b", "-o", "OUT.bin", "r.fa"], ["OUT.bin"]),
    ("seqconvert", ["-b", "-Q", "20", "-o", "OUT.bin", "r.fq"], ["OUT.bin"]),
    ("seqconvert", ["-1", "-o", "OUT.1seq", "r.fq"], ["OUT.1seq"]),
    ("seqhoco", ["homo.fa"], []),
    ("seqhoco", ["r.fq"], []),
    ("modtype", ["ref.fa", "sites.1ins", "samples.1smp"], []),
    ("modtype", ["ref.fa", "bad.1ins", "samples.1smp"], []),
]


@pytest.mark.parametrize("tool,argv,files", HOST_CLI_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(HOST_CLI_CASES)])
def test_host_cli_copy_matches_jax(cli_data, monkeypatch, tool, argv, files):
    """The port's copy of each host-only CLI against the JAX package's:
    exit code, stdout and stderr (timing lines dropped) and every written
    file, byte for byte (a ONE file's provenance timestamp masked)."""
    monkeypatch.chdir(cli_data)
    runs = {}
    for package in ("modimizer_tpu_torch", "modimizer_tpu"):
        tag = package.split("_")[-1]
        args = [a.replace("OUT", tag) for a in argv]
        runs[package] = (_run_cli(package, tool, args),
                         [_one_masked((cli_data / f.replace("OUT", tag))
                                      .read_bytes()) for f in files])
    (port, port_files), (jax, jax_files) = (runs["modimizer_tpu_torch"],
                                            runs["modimizer_tpu"])
    assert port == jax
    assert port_files == jax_files
    assert any(port) or port_files      # the run produced something
