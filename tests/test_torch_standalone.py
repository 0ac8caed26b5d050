"""The port stands alone: no module of ``modimizer_tpu_torch`` (and not
``chip_smoke.py``) imports jax or the JAX package, and the port's copies of
the host modules (``core``, ``io``, ``native``, ``utils``, ``cli``, the
scanner's host methods) behave as the JAX package's originals: Seqhash
fields, ``scan_bo``, the sequence readers, the native host scan and the
``MODIMIZER_SCAN=host`` CLI's ``.mod`` bytes.  Also the constants of the
division-free emit test that ``csrc/scan_compact.cu`` takes, emulated with
Python ints against ``h % w == 0``."""

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
from modimizer_tpu.io import seqio as jax_seqio  # noqa: E402
from modimizer_tpu.io import stream_seq as jax_stream  # noqa: E402
from modimizer_tpu.ops import seqhash as jax_ops  # noqa: E402
from modimizer_tpu_torch.cli import modutils as port_cli  # noqa: E402
from modimizer_tpu_torch.core.seqhash import Seqhash  # noqa: E402
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
import importlib, pkgutil, sys
import modimizer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(modimizer_tpu_torch.__path__,
                                              "modimizer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from modimizer_tpu_torch.cli import modutils
modutils.main(sys.argv[1:], device="cpu")
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "modimizer_tpu")]
assert not bad, bad
sys.stderr.write("STANDALONE_OK %d\n" % len(names))
"""


def test_port_runs_without_jax_or_the_jax_package(tmp_path):
    random_fasta(tmp_path / "r.fa", 40, 300, seed=5)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("MODIMIZER_SCAN", None)
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "-c", "20", "16", "16", "17",
         "-a", str(tmp_path / "r.fa"), "-w", str(tmp_path / "p.mod")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "STANDALONE_OK" in r.stderr
    assert int(r.stderr.split("STANDALONE_OK")[1].split()[0]) > 30
    assert "added 40 sequences" in r.stdout


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
