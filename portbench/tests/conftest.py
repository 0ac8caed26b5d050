"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q`` from
the checkout's root.  Tests marked ``chip`` need a CUDA card and skip
without one (the check is made inside the test, never at import)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="session")
def spec():
    from bench_harness import Spec
    return Spec(os.path.join(ROOT, "BENCHMARK.json"))


def tiny(cfg, **sizes):
    """A configuration cut to CPU-test size."""
    out = dict(cfg)
    out.update({"genome_len": 40_000, "n_reads": 40, "read_len": 2_000},
               **sizes)
    return out
