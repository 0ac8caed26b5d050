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

The CLIs join torchrun's group through ``torchrun_main``: under torchrun's
variables the whole command list runs on every rank with the mesh of all
ranks, and ranks above 0 print nothing.
"""

import contextlib
import datetime
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


TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


def torchrun_mesh(device=None):
    """Under torchrun's environment: (the mesh over its ranks, whether this
    call initialised the process group); else (None, False).  The group is
    NCCL on the card ``cuda:<LOCAL_RANK>``, or gloo when ``device`` names
    the CPU."""
    if not all(v in os.environ for v in TORCHRUN_VARS):
        return None, False
    cpu = device is not None and torch.device(device).type == "cpu"
    owned = not dist.is_initialized()
    if owned:
        if not cpu:
            require_cuda()      # never gloo on the CPU unless asked
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        # a rank that fails leaves the others in a collective: they give up
        # after the timeout
        dist.init_process_group("gloo" if cpu else "nccl",
                                timeout=datetime.timedelta(seconds=600))
    return build_mesh("cpu" if cpu else None, group=dist.group.WORLD), owned


def torchrun_main(run, argv, device=None):
    """A CLI's ``run(argv, device)``, or under torchrun ``run(argv,
    mesh.device, mesh=mesh)`` on every rank with stdout sent to
    ``os.devnull`` above rank 0; the group is destroyed only if this call
    initialised it."""
    mesh, owned = torchrun_mesh(device)
    if mesh is None:
        return run(argv, device)
    try:
        with contextlib.ExitStack() as stack:
            if mesh.rank:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            return run(argv, mesh.device, mesh=mesh)
    finally:
        if owned:
            dist.destroy_process_group()
