"""The port's modmap CLI (``modimizer_tpu_torch.cli.modmap.main(argv,
device="cpu")``: the scan and the sorted-table lookup on the kernels' plain
versions; and on ``MODIMIZER_SCAN=host``) against the JAX CLI's host path,
on tests/test_modmap_parity.py's reference and queries at its shapes (-K 16
-W 13 -S 7 -B 20): ``-f -q``, ``-f -v -q``, ``-f -w`` then ``-r -q``.
stdout without timing lines, and the ``.mod`` and ``.ref`` bytes; each
package reads the other's files."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

from modimizer_tpu.cli import modmap as jax_modmap  # noqa: E402
from modimizer_tpu_torch.cli import modmap as port_modmap  # noqa: E402
from modimizer_tpu_torch.parallel import lookup  # noqa: E402
from tests.util import strip_timing  # noqa: E402

PARAMS = ["-K", "16", "-W", "13", "-S", "7", "-B", "20"]


def run(main, argv, cwd=None, **kw):
    """stdout of main(argv, **kw) in this process, timing lines dropped."""
    out = io.StringIO()
    old = os.getcwd()
    try:
        if cwd:
            os.chdir(cwd)
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            main([str(a) for a in argv], **kw)
    finally:
        os.chdir(old)
    return strip_timing(out.getvalue())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_modmap_parity.py's data: three reference sequences, one
    holding a copy of a segment of another (so copy-2 mods exist); 30
    queries cut from them, some reverse-complemented, and 5 random ones."""
    d = tmp_path_factory.mktemp("modmap_torch")
    rng = np.random.default_rng(33)
    bases = np.array(list("ACGT"))
    chr1 = "".join(bases[rng.integers(0, 4, size=20000)])
    seg = chr1[2000:3500]
    chr2 = ("".join(bases[rng.integers(0, 4, size=5000)]) + seg
            + "".join(bases[rng.integers(0, 4, size=5000)]))
    chr3 = "".join(bases[rng.integers(0, 4, size=8000)])
    with open(d / "ref.fa", "w") as f:
        f.write(f">chr1\n{chr1}\n>chr2\n{chr2}\n>chr3 third\n{chr3}\n")
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    chrs = [chr1, chr2, chr3]
    with open(d / "query.fa", "w") as f:
        for i in range(30):
            src = chrs[int(rng.integers(0, 3))]
            s = int(rng.integers(0, len(src) - 2000))
            q = src[s:s + 2000]
            if rng.random() < 0.4:
                q = "".join(comp[c] for c in reversed(q))
            f.write(f">q{i}\n{q}\n")
        for i in range(5):
            f.write(f">junk{i}\n"
                    + "".join(bases[rng.integers(0, 4, size=1500)]) + "\n")
    return d


@pytest.fixture
def finds(monkeypatch):
    """Counts DeviceTable.find calls (the device lookup of -q)."""
    calls = []
    real = lookup.DeviceTable.find

    def find(self, q):
        calls.append(len(q))
        return real(self, q)

    monkeypatch.setattr(lookup.DeviceTable, "find", find)
    return calls


@pytest.mark.parametrize("verbose", [False, True], ids=["q", "vq"])
@pytest.mark.parametrize("path", ["cpu", "host"])
def test_query_matches_jax_host_path(data, monkeypatch, finds, verbose,
                                     path):
    argv = PARAMS + ["-f", data / "ref.fa"] + (["-v"] if verbose else []) + [
        "-q", data / "query.fa"]
    want = run(jax_modmap.main, argv)
    if path == "host":
        monkeypatch.setenv("MODIMIZER_SCAN", "host")
    got = run(port_modmap.main, argv, device="cpu")
    assert "copy 1," in got and "\nQ\tq0\t2000\t" in got
    assert got == want
    # the device scan looks the queries up in the device table; the host
    # scan in the host table
    assert (len(finds) == 1 and finds[0] > 0) if path == "cpu" else not finds


def test_write_read_bytes_and_cross_load(data, tmp_path, finds):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    argv_w = PARAMS + ["-f", data / "ref.fa", "-w", "refidx"]
    assert (run(jax_modmap.main, argv_w, cwd=jdir)
            == run(port_modmap.main, argv_w, cwd=pdir, device="cpu"))
    for ext in (".mod", ".ref"):
        assert ((jdir / ("refidx" + ext)).read_bytes()
                == (pdir / ("refidx" + ext)).read_bytes()), ext
    argv_q = ["-r", "refidx", "-q", data / "query.fa"]
    want = run(jax_modmap.main, argv_q, cwd=jdir)
    assert want.startswith("Q\tq0\t2000\t")
    assert run(port_modmap.main, argv_q, cwd=jdir, device="cpu") == want
    assert run(jax_modmap.main, argv_q, cwd=pdir) == want
    assert run(port_modmap.main, argv_q, cwd=pdir, device="cpu") == want
    assert len(finds) == 2


def test_query_needs_a_device(data, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    monkeypatch.delenv("MODIMIZER_SCAN", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(port_modmap.main, PARAMS + ["-f", data / "ref.fa"])
