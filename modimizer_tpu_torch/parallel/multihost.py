"""Multi-process sharded modset build (port of ``modimizer_tpu/parallel/
multihost.py``; BASELINE config 4: count a read set that is split across
processes).

Each process (one a device, a rank of a ``torch.distributed`` group) feeds
its own shard of the read stream (its own files) through the routed
builder of ``parallel/sharded.py``.  Exactness is kept the same way as in
one process: every emitted k-mer carries its global stream position (each
shard has a global base offset), so the finalized table is in
first-encounter order of the concatenated global stream whichever rank
scanned what.

The JAX version stitches host-local arrays into global ones
(``_globalize``) and gathers results with ``process_allgather``
(``_fetch``, ``finalize``).  Here every rank holds its own tensors: the
exchange is the mesh's ``all_to_all`` and the gather is the builder's own
``finalize``.
"""

import datetime

import numpy as np
import torch.distributed as dist

from .sharded import ShardedModsetBuilder


TIMEOUT = datetime.timedelta(seconds=600)


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str = None):
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, through a TCP store at ``coordinator`` ("host:port" or
    "tcp://host:port"; rank 0 serves it).  backend: "nccl" (the default,
    one CUDA card a rank) or "gloo" (the CPU).  A rank that fails leaves
    the others in a collective: they give up after ``TIMEOUT``.
    Returns the group (``dist.group.WORLD``)."""
    init = coordinator if "://" in coordinator else "tcp://" + coordinator
    dist.init_process_group(backend or "nccl", init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return dist.group.WORLD


class MultiHostModsetBuilder(ShardedModsetBuilder):
    """ShardedModsetBuilder whose ranks each feed their own shard of the
    stream; ``save``, ``restore`` and ``finalize`` are the builder's (the
    same snapshot layout: a snapshot of either package's builder resumes
    here on a mesh of its size, and the other way round)."""

    def feed_stream(self, codes: np.ndarray, offsets: np.ndarray,
                    base: int = 0):
        """codes/offsets: THIS rank's shard of the global stream; base: its
        global position.  The rank scans its shard in chunks of C.  Shards
        may be uneven: the step count is the maximum over the ranks, and a
        rank that runs out of data feeds empty (all-invalid) chunks, so
        the collectives stay in lockstep."""
        C = self.chunk
        n_steps = self.mesh.max(max(1, -(-len(codes) // C)))
        self._feed(codes, offsets, base, [s * C for s in range(n_steps)])
