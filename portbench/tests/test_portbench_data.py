"""The generators: the same seed gives the same inputs, every seed the
same sizes, as the configuration files say."""

import numpy as np
import pytest

from bench_data import make_inputs, sampled_reads, write_inputs
from conftest import tiny


@pytest.mark.parametrize("cell", ["ecoli_hifi30x.build", "grch38_chr20.map"])
def test_inputs_are_the_seeds_and_sized_by_the_config(spec, cell):
    cfg = tiny(spec.config(spec.cell(cell)))
    a, b = make_inputs(cfg, 2 ** 33 + 5), make_inputs(cfg, 2 ** 33 + 5)
    c = make_inputs(cfg, 7)
    for key in ("genome", "reads"):
        assert np.array_equal(a[key], b[key])
        assert a[key].shape == c[key].shape
        assert not np.array_equal(a[key], c[key])
        assert a[key].dtype == np.uint8 and a[key].max() <= 3
    assert a["genome"].shape == (cfg["genome_len"],)
    assert a["reads"].shape == (cfg["n_reads"], cfg["read_len"])


def test_reads_are_sampled_substituted_and_reverse_complemented():
    rng = np.random.default_rng(1)
    g = rng.integers(0, 4, 5000, dtype=np.uint8)
    reads = sampled_reads(np.random.default_rng(2), g, 60, 400, 0.02, 3)
    win = np.lib.stride_tricks.sliding_window_view(g, 400)
    for i, r in enumerate(reads):
        fwd = r if i % 3 != 2 else 3 - r[::-1]
        best = (win != fwd).sum(1).min()
        assert best <= 400 * 0.02 * 3          # a few substitutions only
    diff = [(win != (r if i % 3 != 2 else 3 - r[::-1])).sum(1).min()
            for i, r in enumerate(reads)]
    assert 0.5 * 0.02 * 400 < np.mean(diff) < 1.0 * 0.02 * 400


def test_config_files_hold_the_sizes_of_their_sources(spec):
    c = spec.config(spec.cell("ecoli_hifi30x.build"))
    assert (c["genome_len"], c["n_reads"], c["read_len"]) == (4_641_652,
                                                              9_283, 15_000)
    assert c["n_reads"] * c["read_len"] >= 1 << 25  # counted on the card
    m = spec.config(spec.cell("grch38_chr20.map"))
    assert (m["genome_len"], m["k"], m["w"]) == (64_444_167, 24, 31)


def test_fasta_files_hold_the_codes(tmp_path, spec):
    cfg = tiny(spec.config(spec.cell("grch38_chr20.map")))
    inputs = make_inputs(cfg, 3)
    paths = write_inputs(inputs, cfg, ["genome", "reads"], str(tmp_path))
    lines = open(paths["reads"], "rb").read().split(b"\n")
    assert lines[0] == b">r0" and lines[2] == b">r1"
    assert lines[1] == np.frombuffer(b"ACGT", np.uint8)[
        inputs["reads"][0]].tobytes()
    g = open(paths["genome"], "rb").read().split(b"\n")
    assert g[0] == b">" + cfg["genome_name"].encode()
    assert len(g[1]) == cfg["genome_len"]
