"""The port's modrep CLI (``modimizer_tpu_torch.cli.modrep.main(argv,
device="cpu")``, and on ``MODIMIZER_SCAN=host``) against the JAX CLI on
tests/test_modrep_parity.py's dataset (tandem-repeat reads with 1 %
substitutions, every third reverse-complemented, one junk read last), its
modsets built by the JAX modutils: ``-R ref mod -s1/-s2/-s3 reads mod``,
stdout and stderr (timing lines dropped)."""

import contextlib
import io
import re

import numpy as np
import pytest

import modimizer_tpu

modimizer_tpu.configure_jax()

from modimizer_tpu.cli import modrep as jax_modrep  # noqa: E402
from modimizer_tpu.cli import modutils as jax_modutils  # noqa: E402
from modimizer_tpu_torch.cli import modrep as port_modrep  # noqa: E402

BASES = np.array(list("ACGT"))
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def run(main, argv, **kw):
    """(stdout, stderr) of main(argv, **kw) in this process, the rusage
    lines blanked."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main([str(a) for a in argv], **kw)
    return out.getvalue(), re.sub(r"user\t[^\n]*", "<RUSAGE>",
                                  err.getvalue())


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("modrep_torch")
    rng = np.random.default_rng(23)
    unit = "".join(BASES[rng.integers(0, 4, size=2000)])
    (d / "ref.fa").write_text(">u\n" + unit + "\n")

    def mutate(s, rate):
        a = np.frombuffer(s.encode(), np.uint8).copy()
        idx = np.nonzero(rng.random(len(a)) < rate)[0]
        a[idx] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                               len(idx))]
        return a.tobytes().decode()

    with open(d / "reads.fa", "w") as f:
        for i in range(60):
            s = mutate(unit * 5, 0.01)
            if i % 3 == 0:
                s = "".join(COMP[c] for c in reversed(s))
            f.write(f">q{i}\n{s}\n")
        f.write(">junk\n" + "".join(BASES[rng.integers(0, 4, size=3000)])
                + "\n")
    for stem, src in (("refmod", "ref.fa"), ("readmod", "reads.fa")):
        run(jax_modutils.main, ["-c", "20", "16", "16", "17", "-a", d / src,
                                "-w", d / (stem + ".mod")])
    return d


@pytest.mark.parametrize("path", ["cpu", "host"])
@pytest.mark.parametrize("mode", ["-s3", "-s1", "-s2"])
def test_modrep_matches_jax(dataset, monkeypatch, mode, path):
    d = dataset
    args = ["-R", d / "ref.fa", d / "refmod.mod",
            mode, d / "reads.fa", d / "readmod.mod"]
    want = run(jax_modrep.main, args)
    if path == "host":
        monkeypatch.setenv("MODIMIZER_SCAN", "host")
    got = run(port_modrep.main, args, device="cpu")
    assert got == want
    assert "found " in got[1] and len(got[0]) > 10
