"""modmap on the PyTorch port: reference indexing + query seeding/mapping
(reference: modmap.c; port of ``modimizer_tpu/cli/modmap.py``).

Seeding is batched on the device: the port's scanner, then, when that scan
ran on a device (the card, or an explicit CPU device), a sorted-table
lookup on the same device (``parallel.lookup.DeviceTable``, the CUDA kernel
``find_sorted`` on the card); on the native host scan
(``MODIMIZER_SCAN=host``) the lookup is the host table's ``find_batch``, as
in the JAX CLI.  The greedy colinear chaining over copy1/copy2 seeds
(modmap.c:216-276) runs in the native runtime (``mm_query_emit``),
reproduced literally including its quirks (U32 wraparound in the
diagonal-difference test, the n2>2 final-block gate).

Under torchrun (``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set, one
process a card) every rank parses and scans the reference and the queries
on its own card and runs every command; the table is a ``DeviceTable`` on
the mesh of all ranks (rank r keeps the k-mers it owns) and each ``-q``
batch is one SPMD ``find`` over it, the JAX CLI's table over every device
of its process.  Rank 0 alone chains and writes stdout, ``-o`` and ``-w``.

    python -m modimizer_tpu_torch.cli.modmap -K 24 -W 31 -f ref.fa -q reads.fa
    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m modimizer_tpu_torch.cli.modmap -K 24 -W 31 -f ref.fa -q reads.fa
"""

import sys

import numpy as np

from ..core.modset import Modset
from ..core.reference import Reference
from ..core.seqhash import Seqhash
from ..io import seqio
from ..ops.seqhash import ModimizerScanner
from ..parallel.mesh import torchrun_main
from ..utils import profiling
from ..utils.timers import Timer
from .common import cli_guard, Args, OutFile, die


def usage(params, num_threads):
    e = sys.stderr.write
    e("Usage: modmap <commands>\n")
    e("Commands are executed in order - set parameters before using them!\n")
    e("  -K | --kmer <kmer size> [%d]\n" % params["k"])
    e("  -W | --window <window> [%d]\n" % params["w"])
    e("  -S | --seed <random number seed> [%d]\n" % params["s"])
    e("  -B | --tableBits <hash index table bitcount> [%d]\n" % params["B"])
    e("  -v | --verbose : toggle verbose mode\n")
    e("  -t | --threads <number of threads for parallel ops> [%d]\n" % num_threads)
    e("  -o | --output <output filename> : '-' for stdout\n")
    e("  -f | --referenceFasta <reference fasta file>\n")
    e("  -w | --referenceWrite <file stem> : writes reference hash files\n")
    e("  -r | --referenceRead <file stem> : read reference hash files\n")
    e("  -q | --query <query fasta file>\n")


def _lookup(ref: Reference, scanner, kmers, mesh=None):
    """The query k-mers' modset ids, 0 where absent: after a scan on a
    device, one sorted-table binary search per query on that device, or
    on the ``mesh`` of several ranks (``parallel.lookup.DeviceTable``);
    after the native host scan, the host table's probe loop
    (native/modset_native.cpp).  On a mesh every rank must take the same
    branch: the ranks that scanned on the device would wait in the
    table's exchange for the others."""
    ms = ref.ms
    if mesh is not None:
        on_device = mesh.sum(int(scanner.used_device))
        if on_device not in (0, mesh.n):
            die("%d of %d ranks scanned the queries on the device and the "
                "others on the host: set MODIMIZER_SCAN alike on every rank",
                on_device, mesh.n)
    if not scanner.used_device:
        return ms.find_batch(kmers)
    table, group = ref.device_table, None if mesh is None else mesh.group
    if (table is None or table.device != scanner.device
            or table.mesh.group is not group):
        from ..parallel.lookup import DeviceTable
        ref.device_table = DeviceTable(
            ms.value[1:ms.max + 1],
            np.arange(1, ms.max + 1, dtype=np.uint32), ms.hasher,
            device=scanner.device if mesh is None else mesh)
    return ref.device_table.find(kmers)


def query_process(ref: Reference, filename, out, is_verbose, device=None,
                  mesh=None):
    """queryProcess (modmap.c:188-281): seeding batched on ``device`` (the
    scanner's) + the table lookup there, or on ``mesh`` (every rank
    passes all the queries); the greedy colinear chaining automaton and
    Q/M emission run in the native runtime (``emit``), on rank 0 only."""
    ms = ref.ms
    try:
        with profiling.stage("map.parse"):
            batch, _t = seqio.read_seq_file(filename, seqio.dna2index_n0(),
                                            is_qual=False, want_ids=True)
    except (IOError, ValueError, FileNotFoundError):
        die("failed to read query sequence file %s", filename)
    scanner = ModimizerScanner(ms.hasher, want_isf=False, device=device)
    with profiling.stage("map.scan"):
        kmers, rid, rpos, _f = scanner.scan_batch(batch)
    with profiling.stage("map.lookup"):
        sidx = _lookup(ref, scanner, kmers, mesh)
    if mesh is None or mesh.rank == 0:
        emit(ref, batch, rid, rpos, sidx, out, is_verbose)


def emit(ref: Reference, batch, rid, rpos, sidx, out, is_verbose):
    """The chaining and the Q/M lines (mm_query_emit), written through
    ``out``'s and stdout's file descriptors."""
    ms = ref.ms
    n = batch.n
    seed_off = np.searchsorted(rid, np.arange(n + 1)).astype(np.int64)
    spos = np.ascontiguousarray(rpos, np.int64)
    sidx = np.ascontiguousarray(sidx, np.uint32)

    def blob(strings):
        offs = np.zeros(len(strings) + 1, np.int64)
        parts = []
        total = 0
        for i, name in enumerate(strings):
            b = name.encode("latin1") + b"\0"
            parts.append(b)
            offs[i] = total
            total += len(b)
        offs[-1] = total
        return b"".join(parts), offs

    names, name_off = blob([ref.dict.name(i) for i in range(ref.dict.max)])
    qids, qid_off = blob(batch.ids)
    qlen = np.ascontiguousarray(batch.lengths, np.int64)

    import sys as _sys
    import tempfile
    _sys.stdout.flush()
    out.flush()

    def fd_of(stream):
        """Real fd, or a spool file when the stream has none (tests)."""
        try:
            return stream.fileno(), None
        except (AttributeError, OSError, ValueError):
            tmp = tempfile.TemporaryFile()
            return tmp.fileno(), tmp

    fd_out, spool_out = fd_of(out.f)
    if out.f is _sys.stdout:
        fd_so, spool_so = fd_out, None  # one stream: keep line interleaving
    else:
        fd_so, spool_so = fd_of(_sys.stdout)
    from ..native import lib as native_lib
    with profiling.stage("map.chain"):
        native_lib().mm_query_emit(
            seed_off, sidx, spos, np.ascontiguousarray(ms.info, np.uint8),
            np.ascontiguousarray(ref.rev, np.uint32),
            np.ascontiguousarray(ref.loc, np.uint32),
            np.ascontiguousarray(ref.offset, np.uint32),
            np.ascontiguousarray(ref.id, np.uint32),
            len(ref.rev), names, name_off, qids, qid_off, qlen, n,
            int(is_verbose), fd_out, fd_so)
    for spool, target in ((spool_out, out.f), (spool_so, _sys.stdout)):
        if spool is not None:
            spool.seek(0)
            target.write(spool.read().decode("latin1"))
            spool.close()


def main(argv=None, device=None):
    """Run modmap commands in order.  device: a torch.device (or its name)
    for the scans and the lookup; None takes the CUDA card and raises
    without one.  ``device="cpu"`` runs the kernels' plain versions;
    MODIMIZER_SCAN=host asks for the native host scan and lookup.  Under
    torchrun the ranks look up on their mesh and rank 0 writes (see the
    module doc)."""
    torchrun_main(run, sys.argv[1:] if argv is None else argv, device)


@cli_guard
def run(argv, device=None, mesh=None):
    """main()'s body; on a ``mesh`` the -q lookup runs on it and only rank
    0 chains and writes files."""
    argv = list(argv)
    writer = mesh is None or mesh.rank == 0
    out = OutFile()
    timer = Timer()
    timer.update(sys.stdout)
    params = {"k": 19, "w": 31, "s": 17, "B": 28}
    num_threads = 1
    is_verbose = False

    if not argv:
        usage(params, num_threads)

    ref = None
    args = Args(argv)
    while args:
        if not args.current.startswith("-"):
            die("option/command %s does not start with '-': run without arguments for usage",
                args.current)
        args.echo_command()

        if (m := args.match("-K", "--kmer", 2)):
            params["k"] = int(m[1])
        elif (m := args.match("-W", "--window", 2)):
            params["w"] = int(m[1])
        elif (m := args.match("-S", "--seed", 2)):
            params["s"] = int(m[1])
        elif (m := args.match("-B", "--tableBits", 2)):
            params["B"] = int(m[1])
        elif (m := args.match("-t", "--threads", 2)):
            sys.stderr.write("  can't set thread number - not compiled with OMP\n")
        elif args.match("-v", "--verbose", 1):
            is_verbose = not is_verbose
        elif (m := args.match("-o", "--output", 2)):
            out.set(m[1] if writer else "-")
        elif (m := args.match("-f", "--referenceFasta", 2)):
            if params["k"] <= 0 or params["w"] <= 0:
                die("k %d, w %d must be > 0", params["k"], params["w"])
            hasher = Seqhash.create(params["k"], params["w"], params["s"])
            out.write("  modmap initialised with k = %d, w = %d, random seed = %d\n"
                      % (params["k"], params["w"], params["s"]))
            ms = Modset(hasher, params["B"], 0)
            ref = Reference(ms, 1 << 26)
            try:
                ref.fasta_read(m[1], out, is_add=True, device=device)
            except IOError:
                die("failed to read reference sequence file %s", m[1])
            except ValueError as e:
                die("%s", str(e))
        elif (m := args.match("-q", "--query", 2)):
            if not ref:
                die("need to read a reference before processing query sequences")
            import os
            if not os.path.exists(m[1]):
                die("failed to open query file %s", m[1])
            query_process(ref, m[1], out, is_verbose, device, mesh)
        elif (m := args.match("-r", "--referenceRead", 2)):
            ref = Reference.read(m[1])
        elif (m := args.match("-w", "--referenceWrite", 2)):
            if writer:
                ref.write(m[1])
            if mesh is not None:
                mesh.barrier()  # a later -r reads it on every rank
        else:
            die("unkown command %s - run without arguments for usage",
                args.current)

        timer.update(out.f)

    out.write("total resources used: ")
    timer.total(out.f)
    if not out.is_stdout:
        sys.stdout.write("total resources used: ")
        timer.total(sys.stdout)


if __name__ == "__main__":
    main()
