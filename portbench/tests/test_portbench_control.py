"""The control (the reference with its k-mers carried in 32 bits, in the
program's place) must fail each cell's check: here at test size, and on
the card at the cells' own sizes."""

import pytest

from conftest import tiny
from control import control_numbers


@pytest.mark.parametrize("cell", ["ecoli_hifi30x.build", "grch38_chr20.map",
                                  "ecoli_hifi30x.asm"])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7, 3_000_000_019])
def test_the_control_fails_at_test_size(spec, cell, seed):
    # at test size the 38- and 48-bit k-mers still exceed 32 bits
    cfg = tiny(spec.config(spec.cell(cell)), n_reads=60)
    numbers, limits = control_numbers(spec, cell, seed, "cpu", cfg)
    assert any(v > limits[n] for n, v in numbers.items()), numbers


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["ecoli_hifi30x.build", "grch38_chr20.map",
                                  "grch38_chr20.map_mesh4",
                                  "ecoli_hifi30x.asm"])
def test_the_control_fails_at_the_cells_size(spec, cuda_card, cell):
    for seed in (11, 12, 13):
        numbers, limits = control_numbers(spec, cell, seed, cuda_card)
        assert any(v > limits[n] for n, v in numbers.items()), numbers
