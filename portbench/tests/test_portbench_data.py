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


def test_spread_reads_keep_every_seeds_lengths(spec, tmp_path):
    cell = spec.cell("ecoli_hifi30x.asm")
    traffic = spec.traffic(cell)
    spread = dict(traffic["read_lengths"], inverted=0.05)
    traffic = dict(traffic, read_lengths=spread)
    cfg = tiny(spec.config(cell), n_reads=200, read_len=15_000,
               genome_len=100_000)
    a, b = make_inputs(cfg, 2 ** 33 + 5, traffic), make_inputs(cfg, 9,
                                                               traffic)
    for x in (a, b):
        lens = x["read_lens"]
        assert lens.min() >= spread["min"] and lens.max() <= spread["max"]
        assert x["reads"].shape == (200, lens.max())
        # the padding is zeros; every seed has the same lengths
        pad = np.arange(x["reads"].shape[1]) >= lens[:, None]
        assert not x["reads"][pad].any()
        # the inverted duplicates: the second half folds back on the first
        folded = 0
        for i, n in enumerate(lens):
            r = x["reads"][i, :n]
            r = r if i % cfg["rc_every"] != cfg["rc_every"] - 1 \
                else 3 - r[::-1]
            half = (n + 1) // 2
            folded += np.array_equal(r[half:], (3 - r[:half][::-1])[:n - half])
        assert folded == 10
    assert np.array_equal(np.sort(a["read_lens"]), np.sort(b["read_lens"]))
    assert not np.array_equal(a["read_lens"], b["read_lens"])
    assert abs(a["read_lens"].mean() / cfg["read_len"] - 1) < 0.05
    assert np.array_equal(make_inputs(cfg, 9, traffic)["reads"], b["reads"])
    paths = write_inputs(a, cfg, ["reads"], str(tmp_path))
    seqs = open(paths["reads"], "rb").read().split(b"\n")[1::2]
    assert [len(q) for q in seqs] == a["read_lens"].tolist()
