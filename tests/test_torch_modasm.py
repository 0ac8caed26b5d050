"""The port's modasm CLI (``modimizer_tpu_torch.cli.modasm.main(argv,
device="cpu")``) against the JAX CLI's host path (the native serial
findOverlaps walk), on tests/test_overlaps_pre.py's reads and modset: the
port with ``MODIMIZER_OVERLAPS=device`` (the overlap self-join's plain
version feeding the native *_pre engines) and ``=host``, on the arg lists
of tests/test_overlaps_pre.py; ``-w`` then ``-r`` (the ``.mod`` and
``.readset`` bytes; each package reads the other's files); and the port's
size rule for the device overlaps."""

import contextlib
import io

import pytest
import torch

import modimizer_tpu

modimizer_tpu.configure_jax()

from modimizer_tpu.cli import modasm as jax_modasm  # noqa: E402
from modimizer_tpu_torch.cli import modasm as port_modasm  # noqa: E402
from modimizer_tpu_torch.parallel import overlaps  # noqa: E402
from tests.test_torch_overlaps import overlaps_pre_dataset  # noqa: E402
from tests.util import strip_timing  # noqa: E402

ARGS = [["-b", "-S", "-c", "-S"], ["-o2", "7"], ["-b", "-o2", "3"], ["-u"],
        ["-b", "-u"]]


def run(main, argv, path, **kw):
    """stdout of main(argv, **kw) in this process, timing lines dropped.
    The native engines write to the stdout file descriptor, so stdout is a
    real file here."""
    with open(path, "w") as f, contextlib.redirect_stdout(f), \
            contextlib.redirect_stderr(io.StringIO()):
        main([str(a) for a in argv], **kw)
    with open(path) as f:
        return strip_timing(f.read())


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return overlaps_pre_dataset(tmp_path_factory.mktemp("modasm_torch"))


@pytest.fixture
def self_joins(monkeypatch):
    """Counts overlap_counts calls (the device phase 1)."""
    calls = []
    real = overlaps.overlap_counts

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(overlaps, "overlap_counts", counted)
    return calls


@pytest.mark.parametrize("mode", ["device", "host"])
@pytest.mark.parametrize("args", ARGS, ids=[" ".join(a) for a in ARGS])
def test_modasm_matches_jax_host_path(dataset, tmp_path, monkeypatch,
                                      self_joins, args, mode):
    argv = ["-m", dataset / "X.mod", "-f", dataset / "reads.fa"] + args
    monkeypatch.setenv("MODIMIZER_OVERLAPS", "host")
    want = run(jax_modasm.main, argv, tmp_path / "jax.out")
    monkeypatch.setenv("MODIMIZER_OVERLAPS", mode)
    got = run(port_modasm.main, argv, tmp_path / "port.out", device="cpu")
    assert got == want
    assert "RR" in got or "cluster" in got or "RS" in got
    n_phase1 = sum(a in ("-b", "-c", "-o2", "-u") for a in args)
    assert len(self_joins) == (n_phase1 if mode == "device" else 0)


def test_write_read_bytes_and_cross_load(dataset, tmp_path, monkeypatch):
    monkeypatch.setenv("MODIMIZER_OVERLAPS", "host")
    src = ["-m", dataset / "X.mod", "-f", dataset / "reads.fa", "-w"]
    run(jax_modasm.main, src + [tmp_path / "jax"], tmp_path / "j.out")
    run(port_modasm.main, src + [tmp_path / "port"], tmp_path / "p.out",
        device="cpu")
    for ext in (".mod", ".readset"):
        assert ((tmp_path / ("jax" + ext)).read_bytes()
                == (tmp_path / ("port" + ext)).read_bytes()), ext
    use = ["-S", "-b", "-c", "-S", "-o2", "5"]
    want = run(jax_modasm.main, ["-r", tmp_path / "jax"] + use,
               tmp_path / "a.out")
    assert want.count("RS ") > 4
    assert run(jax_modasm.main, ["-r", tmp_path / "port"] + use,
               tmp_path / "b.out") == want
    monkeypatch.setenv("MODIMIZER_OVERLAPS", "device")
    assert run(port_modasm.main, ["-r", tmp_path / "jax"] + use,
               tmp_path / "c.out", device="cpu") == want


class _RS:
    def __init__(self, device, tot_hit):
        self.device = None if device is None else torch.device(device)
        self.tot_hit = tot_hit


@pytest.mark.parametrize("device,tot_hit,mode,want", [
    ("cuda", 1 << 20, None, True), ("cuda", (1 << 20) - 1, None, False),
    ("cpu", 1 << 30, None, False), (None, 1 << 30, None, False),
    ("cuda", 10, "device", True), (None, 10, "device", True),
    ("cuda", 1 << 30, "host", False)])
def test_use_device_overlaps_rule(monkeypatch, device, tot_hit, mode, want):
    """The JAX CLI's size rule on the card: a scan on a CUDA device and
    2^20 hits or more; MODIMIZER_OVERLAPS overrides it."""
    if mode is None:
        monkeypatch.delenv("MODIMIZER_OVERLAPS", raising=False)
    else:
        monkeypatch.setenv("MODIMIZER_OVERLAPS", mode)
    assert port_modasm._use_device_overlaps(_RS(device, tot_hit)) is want


def test_readset_scan_on_the_host_keeps_no_device(dataset, tmp_path,
                                                   monkeypatch, self_joins):
    """With the native host scan the readset holds no device; a forced
    device phase 1 then runs on the CLI's device."""
    monkeypatch.setenv("MODIMIZER_SCAN", "host")
    monkeypatch.setenv("MODIMIZER_OVERLAPS", "device")
    argv = ["-m", dataset / "X.mod", "-f", dataset / "reads.fa", "-b", "-S"]
    got = run(port_modasm.main, argv, tmp_path / "p.out", device="cpu")
    monkeypatch.setenv("MODIMIZER_OVERLAPS", "host")
    assert got == run(jax_modasm.main, argv, tmp_path / "j.out")
    assert len(self_joins) == 1 and "RS " in got
