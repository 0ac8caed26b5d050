"""modimizer_tpu_torch — the modimizer scan on PyTorch and CUDA (Hopper).

A port of the device half of ``modimizer_tpu`` (JAX/XLA/Pallas on a TPU) to
PyTorch, with the scan+compact and densify steps as CUDA C++ kernels written
for sm_90a (``csrc/``).  The host-only modules of ``modimizer_tpu`` (``core``,
``io``, ``native``, ``cli.common``, ``utils.timers``) never import jax; this
package imports them instead of copying them, and never imports jax itself.

Idiom: plain functions on tensors, an explicit ``torch.device`` passed in
(never guessed inside an op), no randomness on the device.  Every kernel has
a plain PyTorch version beside it; a wrapper takes the plain version only for
a tensor that lies on the CPU, and for a CUDA tensor launches the kernel or
raises.
"""

__version__ = "0.1.0"


def require_cuda():
    """Return the first CUDA device, or raise when PyTorch sees none."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "modimizer_tpu_torch: CUDA is not available (torch %s, built for "
            "CUDA %s); pass device=torch.device('cpu') to run the plain "
            "PyTorch versions of the kernels"
            % (torch.__version__, torch.version.cuda))
    return torch.device("cuda", torch.cuda.current_device())
