"""modimizer_tpu_torch — the modimizer scan on PyTorch and CUDA (Hopper).

A port of ``modimizer_tpu`` (JAX/XLA/Pallas on a TPU) to PyTorch, with the
scan+compact and densify steps as CUDA C++ kernels written for sm_90a
(``csrc/``).  The package stands alone: it imports neither jax nor
``modimizer_tpu``, and keeps its own copies of the host modules it runs
(``core``, ``io``, ``native``, ``utils``, ``cli.common``) at the same paths.

Idiom: plain functions on tensors, an explicit ``torch.device`` passed in
(never guessed inside an op), no randomness on the device.  Every kernel has
a plain PyTorch version beside it; a wrapper takes the plain version only for
a tensor that lies on the CPU, and for a CUDA tensor launches the kernel or
raises.
"""

import os

# Some virtualized hosts execute numpy's AVX512 code paths pathologically
# slowly; disable them when this package is imported before numpy is.
os.environ.setdefault(
    "NPY_DISABLE_CPU_FEATURES",
    "AVX512F AVX512CD AVX512_SKX AVX512_CLX AVX512_CNL AVX512_ICL")

# numpy madvises THP hugepages on every >= 4 MB allocation; under the
# [madvise] defrag policy the first touch of such a region does direct
# memory compaction (2.1 s of system time for one scan's output buffers on a
# fragmented host, against 0.07 s of plain 4 KB faults).  One-shot CLI
# processes never amortize that, so default it off; MODIMIZER_HUGEPAGES=1
# restores numpy's default.
if os.environ.get("MODIMIZER_HUGEPAGES") != "1":
    os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    try:
        from numpy._core import multiarray as _np_ma
        _np_ma._set_madvise_hugepage(False)
    except (ImportError, AttributeError):  # older numpy: env knob above
        pass

__version__ = "0.1.0"


def require_cuda():
    """Return the first CUDA device, or raise when PyTorch sees none."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "modimizer_tpu_torch: CUDA is not available (torch %s, built for "
            "CUDA %s); pass device=torch.device('cpu') to run the plain "
            "PyTorch versions of the kernels, or set MODIMIZER_SCAN=host for "
            "the native host scan"
            % (torch.__version__, torch.version.cuda))
    return torch.device("cuda", torch.cuda.current_device())
