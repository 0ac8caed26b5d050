"""The shard mesh over ``torch.distributed`` (port of the JAX package's
``build_mesh``, ``modimizer_tpu/parallel/sharded.py:54``).

The JAX mesh is one controller driving n devices along one axis,
``shard``.  The port is SPMD: one process a device (torchrun's layout),
each a rank of a process group, and every rank calls the same methods with
the same arguments.  A ``Mesh`` is the rank's device and group with the
collectives the sharded paths use: ``all_to_all`` of ``[n*cap]`` routing
buffers (JAX's tiled ``lax.all_to_all`` on axis 0), ``all_gather``, and
the all-reduces behind every decision that must come out the same on every
rank (``any``, ``sum``, ``max``).

A mesh without a group is one rank with no collective: the exchange is the
identity and a gather adds a leading axis of one.  A mesh over a group of
one rank still calls each collective.
"""

import os

import torch
import torch.distributed as dist

from .. import require_cuda


def as_device(device, who="modimizer_tpu_torch"):
    """``who``'s one device: a torch.device or its name, or a list of one
    (the JAX package's one-device mesh); None takes the CUDA card."""
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise ValueError(
                "%s: %d devices in one process; the port runs one process a "
                "device: pass build_mesh(device, group) on each rank"
                % (who, len(device)))
        device = device[0]
    return require_cuda() if device is None else torch.device(device)


class Mesh:
    """One rank of the shard mesh: ``n`` ranks, this one ``rank``, its
    ``device``, and the process ``group`` (None: one rank, no
    collectives)."""

    def __init__(self, device, group=None):
        self.device = torch.device(device)
        self.group = group
        self.n = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)

    @property
    def distributed(self):
        return self.group is not None

    def all_to_all(self, x):
        """Block o of ``x`` ([n * cap, ...], split along axis 0) goes to
        rank o; returns the n blocks received, in rank order."""
        if self.group is None:
            return x
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self.group)
        return out

    def all_gather(self, x):
        """[n, *x.shape]: every rank's ``x``, in rank order."""
        if self.group is None:
            return x.unsqueeze(0)
        parts = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.stack(parts)

    def _reduce(self, x, op):
        if self.group is None:
            return int(x)
        t = torch.as_tensor(x, device=self.device).to(torch.int64).reshape(1)
        dist.all_reduce(t, op=op, group=self.group)
        return int(t.item())

    def any(self, flag) -> bool:
        """Whether ``flag`` (a bool tensor or value) is set on any rank."""
        return bool(self._reduce(flag, dist.ReduceOp.MAX))

    def sum(self, x) -> int:
        return self._reduce(x, dist.ReduceOp.SUM)

    def max(self, x) -> int:
        return self._reduce(x, dist.ReduceOp.MAX)

    def barrier(self):
        """Wait for every rank (an all-reduce of nothing)."""
        self.sum(0)


def _local_rank(group):
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank(group) % torch.cuda.device_count()


def as_mesh(mesh) -> Mesh:
    """A Mesh as it is; a device (or its name, a list of one, or None for
    the CUDA card) as the one-rank mesh on it."""
    return mesh if isinstance(mesh, Mesh) else build_mesh(mesh)


def build_mesh(device=None, group=None) -> Mesh:
    """The mesh of this process.  Without a group: one rank on ``device``
    (None takes the CUDA card), the one-device path.  With a group (an
    initialised ``torch.distributed`` group, e.g. ``dist.group.WORLD``):
    its ranks, on ``device`` when one is named (the CPU for gloo), else on
    ``cuda:<local rank>``; never the CPU unless named."""
    if group is None:
        return Mesh(as_device(device, "build_mesh"))
    if device is None:
        require_cuda()
        device = torch.device("cuda", _local_rank(group))
    else:
        device = as_device(device, "build_mesh")
    return Mesh(device, group)
