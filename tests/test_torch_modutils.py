"""The port's modutils (main(..., device="cpu"): the plain versions of the
kernels) vs the JAX package's modutils on its native host path: .mod
bytes, -wt text and stdout must be identical."""

import gzip
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.util import random_fasta, random_fastq, strip_timing

REPO = Path(__file__).resolve().parent.parent
PARAMS = [["20", "16", "16", "17"], ["20", "19", "31", "17"]]


def _run(main, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdout, sys.stderr
    try:
        sys.stdout, sys.stderr = out, err
        ret = main([str(a) for a in argv], **kw)
    finally:
        sys.stdout, sys.stderr = old
    return out.getvalue(), ret


def run_port(argv, monkeypatch):
    from modimizer_tpu_torch.cli import modutils
    monkeypatch.delenv("MODIMIZER_SCAN", raising=False)
    out, scanner = _run(modutils.run, argv, device="cpu")
    assert scanner.used_device and scanner.device.type == "cpu"
    return out, scanner


def run_jax_host(argv, monkeypatch):
    from modimizer_tpu.cli import modutils
    monkeypatch.setenv("MODIMIZER_SCAN", "host")
    try:
        return _run(modutils.main, argv)
    finally:
        monkeypatch.delenv("MODIMIZER_SCAN")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_modutils")
    random_fasta(d / "reads.fa", 50, 400, seed=1, genome_len=5000)
    random_fastq(d / "reads.fq", 30, 200, seed=3)
    (d / "reads.fa.gz").write_bytes(
        gzip.compress((d / "reads.fa").read_bytes()))
    random_fasta(d / "ref.fa", 3, 2000, seed=4)
    return d


@pytest.mark.parametrize("params", PARAMS, ids=["k16w16", "k19w31"])
@pytest.mark.parametrize("src", ["reads.fa", "reads.fq", "reads.fa.gz"])
def test_add_write_matches_jax_host(data, tmp_path, params, src,
                                    monkeypatch):
    outs = {}
    for tag, run in (("port", run_port), ("jax", run_jax_host)):
        argv = (["-c"] + params + ["-a", data / src, "-a", data / "reads.fa",
                                   "-w", tmp_path / (tag + ".mod"),
                                   "-wt", tmp_path / (tag + ".txt"),
                                   "-H", tmp_path / (tag + ".his")])
        outs[tag] = strip_timing(run(argv, monkeypatch)[0])
    assert "added 50 sequences" in outs["port"]
    assert outs["port"] == outs["jax"]
    for ext in (".mod", ".txt", ".his"):
        assert ((tmp_path / ("port" + ext)).read_bytes()
                == (tmp_path / ("jax" + ext)).read_bytes()), ext


def test_add10x_and_refpaint_match_jax_host(data, tmp_path, monkeypatch):
    outs = {}
    for tag, run in (("port", run_port), ("jax", run_jax_host)):
        argv = (["-c"] + PARAMS[0] + ["-x", data / "reads.fq",
                                      "-a", data / "reads.fa",
                                      "-w", tmp_path / (tag + ".mod"),
                                      "-P", data / "ref.fa"])
        outs[tag] = strip_timing(run(argv, monkeypatch)[0])
    assert "painting read0 length 2000" in outs["port"]
    assert outs["port"] == outs["jax"]
    assert ((tmp_path / "port.mod").read_bytes()
            == (tmp_path / "jax.mod").read_bytes())


def test_device_mode_without_cuda_raises(data, monkeypatch):
    import torch
    from modimizer_tpu_torch.cli import modutils
    if torch.cuda.is_available():
        pytest.skip("checks the policy of a machine without CUDA")
    monkeypatch.setenv("MODIMIZER_SCAN", "device")
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(modutils.main, ["-c"] + PARAMS[0] + ["-a", data / "reads.fa"])


_NO_JAX = r"""
import sys
from modimizer_tpu_torch.cli import modutils
modutils.main(sys.argv[1:], device="cpu")
assert "jax" not in sys.modules, "jax was imported"
sys.stderr.write("NO_JAX_OK\n")
"""


def test_port_cli_never_imports_jax(data, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("MODIMIZER_SCAN", None)
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "-c"] + PARAMS[1]
        + ["-a", str(data / "reads.fa"), "-w", str(tmp_path / "p.mod")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stderr
    assert "added 50 sequences" in r.stdout
