"""modutils on the PyTorch port: the modset lifecycle tool with ``-a``,
``-x`` and ``-P`` scanning through ``modimizer_tpu_torch``'s scanner.

Same ordered-command surface and output text as ``modimizer_tpu.cli.
modutils`` (and the reference modutils.c), on the port's own copies of the
host modules (``core``, ``io``, ``native``, ``utils``, ``cli.common``).  As
in the JAX CLI, an input of ``DEVICE_COUNT_THRESHOLD`` (2^25) bases or more
bound for the device is read whole and counted on the device
(``parallel.sharded.ShardedModsetBuilder``), and only its unique k-mers
with their counts are replayed into the table; smaller inputs, or any with
``MODIMIZER_NO_DEVICE_COUNT`` set, go through the streaming scanner.  The
output is byte-identical either way, and to the native host scan's
(``MODIMIZER_SCAN=host``).

Under torchrun (``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set, one
process a card) every rank parses the whole input and runs every command;
the device count runs on the mesh of all ranks (rank r scans chunk s + r*C
of the stream), the JAX CLI's ``build_mesh()`` over every device, and rank
0 alone writes stdout and every file.

    python -m modimizer_tpu_torch.cli.modutils -c 26 16 16 17 -a reads.fa -w X.mod
    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m modimizer_tpu_torch.cli.modutils -c 26 16 16 17 -a reads.fa -w X.mod
"""

import os
import sys

import numpy as np
import torch

from ..core.modset import Modset
from ..core.seqhash import Seqhash
from ..io import seqio
from ..ops.seqhash import ModimizerScanner
from ..parallel.mesh import build_mesh, torchrun_main
from ..parallel.sharded import ShardedModsetBuilder
from ..utils import profiling
from ..utils.timers import Timer
from .common import Args, OutFile, cli_guard, die, finish


def usage():
    e = sys.stderr.write
    e("Usage: modutils <commands>\n")
    e("Commands are executed in order - set parameters before using them!\n")
    e("  -v | --verbose : toggle verbose mode\n")
    e("  -o | --output <output filename> : '-' for stdout\n")
    e("  -c | --modcreate table_bits{28} kmer{19} mod{31} seed{17}: can truncate parameters\n")
    e("  -w | --write <mod file> : custom binary\n")
    e("  -r | --read <mod file>\n")
    e("  -wt | --writetext <text file> : kmer,count,flags tab-separated\n")
    e("  -rt | --readtext <text file>  : hasher params in header line\n")
    e("  -a | --add <read file> : add kmers from read file\n")
    e("  -x | --add10x <10x read file> : add kmers from 10x read file\n")
    e("  -m | --merge <mod file> : add kmers from read file; writes depths\n")
    e("  -p | --prune <min> <max> : remove mod entries < min or >= max\n")
    e("  -s | --setcopy <copy1min> <copy2min> <copyMmin> : reset mod copy\n")
    e("  -sM | --setcopyM <copyMmin> : set copyM if depth > copyMmin\n")
    e("  -H | --hist <outfile> : print depth histogram\n")
    e("  -d | --depth <outfile> <mod file>* : print depth per mod [also in other files]\n")
    e("  -P | --refpaint <ref seqfile> : print depth per mod along a reference sequence\n")
    e("command -c or -r must come before other commands from -w onwards\n")
    e("read files can be fasta or fastq, gzipped or not\n")
    e("example usage\n")
    e("  modutils -c 30 19 31 17 -a XR1.fa.gz -a XR2.fa.gz -w X.mod\n")
    e("  modutils -c 30 19 31 17 -a YR1.fa.gz -a YR2.fa.gz -w Y.mod\n")
    e("  modutils -r X.mod -m Y.mod -w XY1.mod -H XY.his\n")
    e("then look at histogram XY.his and decide on thresholds, then\n")
    e("  modutils -r XY1.mod -p 5 200 -s 10 50 100 -w XY2.mod\n")
    e("  modutils -r XY2.mod -d XY.depths X.mod Y.mod\n")
    e("XY.depths will have columns: hash, depth_in_XY2, depth_inX, depth_in_Y\n")


DEVICE_COUNT_THRESHOLD = 1 << 25  # streams >= 32 Mbase count on device


def _est_stream_len(filename) -> int:
    """Cheap decompressed-size estimate for routing (file size; gzip ISIZE
    trailer, mod 2^32, for gzipped input).  -1 if the file is unreadable."""
    try:
        sz = os.path.getsize(filename)
        with open(filename, "rb") as f:
            if f.read(2) == b"\x1f\x8b" and sz >= 4:
                f.seek(-4, 2)
                sz = int.from_bytes(f.read(4), "little")
        return sz
    except OSError:
        return -1


def depth_histogram(ms: Modset, f):
    h = ms.depth_histogram()
    for i in range(len(h)):
        if h[i]:
            f.write("DP\t%d\t%d\n" % (i, h[i]))


def report_depths(ms: Modset, others, f):
    """modutils reportDepths (modutils.c:65-77)."""
    n = ms.max
    vals = ms.value[1:n + 1]
    cols = [other.find_batch(vals) for other in others]
    for i in range(n):
        f.write("MH\t%x\t%d\t%d" % (int(vals[i]), int(ms.info[i + 1] & 3),
                                    int(ms.depth[i + 1])))
        for j, other in enumerate(others):
            idx = cols[j][i]
            f.write("\t%d" % (int(other.depth[idx]) if idx else 0))
        f.write("\n")


def _count_on_device(scanner: ModimizerScanner, n_bases: int) -> bool:
    """The JAX CLI's rule (modimizer_tpu/cli/modutils.py:84-88,139-140):
    a stream of DEVICE_COUNT_THRESHOLD bases or more that the scanner would
    scan on its torch device is counted there whole."""
    return (scanner.device is not None and not scanner.host
            and n_bases >= DEVICE_COUNT_THRESHOLD
            and not os.environ.get("MODIMIZER_NO_DEVICE_COUNT"))


def add_sequence_file(ms: Modset, scanner: ModimizerScanner, filename, out,
                      is10x=False, builders=None, mesh=None) -> bool:
    """modutils addSequenceFile (modutils.c:33-51).  Inputs counted on the
    device (``_count_on_device``) are read whole, counted by the builder
    and replayed once as unique k-mers with counts; other FASTA/FASTQ
    inputs bound for the device take the parse-ahead streaming path
    (parsing overlaps the device scan and the table replay); the rest (the
    host scan, 10x, other formats) read the whole file and go through
    scan_kmers.  Same table
    either way.  When ``builders`` is a list, the input's builder is
    appended to it, or None when the scanner scanned it.  ``mesh``: the
    mesh the device count runs on (None: the scanner's device alone)."""
    builder = None
    est = _est_stream_len(filename)
    if est < 0:
        return False
    if (not is10x and not _count_on_device(scanner, est)
            and not scanner.host):
        from ..io.stream_seq import iter_seq_batches
        try:
            it = iter_seq_batches(filename, seqio.dna2index_n0())
            first = next(it, None)
        except ValueError:
            pass        # not FASTA/FASTQ: generic whole-file path below
        except IOError:
            return False
        else:
            n_seq = tot_len = 0

            def _batches():
                nonlocal n_seq, tot_len
                for cb, ob in ([first] if first is not None else []):
                    n_seq += len(ob) - 1
                    tot_len += len(cb)
                    yield cb, ob
                for cb, ob in it:
                    n_seq += len(ob) - 1
                    tot_len += len(cb)
                    yield cb, ob

            n_hash = scanner.scan_kmers_batches(_batches(),
                                                consumer=ms.add_batch)
            if builders is not None:
                builders.append(None)
            out.write("added %d sequences total length %d total hashes %d,"
                      " new max %d\n" % (n_seq, tot_len, n_hash, ms.max))
            return True
    try:
        with profiling.stage("read"):
            batch, _t = seqio.read_seq_file(filename, seqio.dna2index_n0(),
                                            is_qual=False, want_ids=False)
    except (IOError, ValueError, FileNotFoundError):
        return False
    offsets = np.asarray(batch.offsets, np.int64)
    codes = batch.codes
    tot_len = len(codes)
    if is10x:
        # odd records (1-based) skip a 23bp barcode (modutils.c:44)
        parts, lens = [], []
        for i in range(batch.n):
            s0 = offsets[i] + (23 if i % 2 == 0 else 0)
            s = codes[min(s0, offsets[i + 1]):offsets[i + 1]]
            parts.append(s)
            lens.append(len(s))
        codes = np.concatenate(parts) if parts else np.zeros(0, np.int8)
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    if _count_on_device(scanner, len(codes)):
        builder = ShardedModsetBuilder(
            ms.hasher, mesh or build_mesh(scanner.device))
        builder.feed_stream(codes, offsets)
        uniq, counts = builder.finalize()
        n_hash = builder.total_emitted
        with profiling.stage("count.replay"):
            ms.add_batch(uniq, counts)
    else:
        n_hash = scanner.scan_kmers(codes, offsets, consumer=ms.add_batch)
    if builders is not None:
        builders.append(builder)
    out.write("added %d sequences total length %d total hashes %d, new max %d\n"
              % (batch.n, tot_len, n_hash, ms.max))
    return True


def main(argv=None, device=None):
    """Run modutils commands in order.  device: a torch.device (or its
    name) for the scan; None takes the CUDA card and raises without one.
    ``device="cpu"`` runs the kernels' plain versions; MODIMIZER_SCAN=host
    asks for the native host scan (no card needed).  Under torchrun the
    ranks count on their mesh and rank 0 writes (see the module doc)."""
    torchrun_main(run, sys.argv[1:] if argv is None else argv, device)


@cli_guard
def run(argv, device=None, builders=None, mesh=None):
    """main()'s body; returns the scanner of the last scan command (for its
    counters), or None when no command scanned.  When ``builders`` is a
    list, each -a/-x input appends to it the builder that counted it on the
    device, or None (``add_sequence_file``).  On a ``mesh`` of several
    ranks the device count runs on it and only rank 0 writes files."""
    argv = list(argv)
    if not argv:
        usage()
    if device is not None:
        device = torch.device(device)
    writer = mesh is None or mesh.rank == 0

    def open_out(name):
        """A written file: ``name`` on the writing rank, else nowhere."""
        return open(name if writer else os.devnull, "w")

    out = OutFile()
    timer = Timer()
    timer.update(sys.stdout)

    ms = None
    scanner = None
    args = Args(argv)

    def get_scanner():
        nonlocal scanner
        if scanner is None or scanner.sh is not ms.hasher:
            scanner = ModimizerScanner(ms.hasher, device=device)
        return scanner

    while args:
        if not args.current.startswith("-"):
            die("option/command %s does not start with '-': run without arguments for usage",
                args.current)
        args.echo_command()

        if args.match("-v", "--verbose", 1):
            pass
        elif (m := args.match("-o", "--output", 2)):
            out.set(m[1] if writer else "-")
        elif ms is None and args.match("-c", "--create", 1):
            B, k, w, s = 28, 19, 31, 17
            vals = []
            while args and not args.current.startswith("-") and len(vals) < 4:
                vals.append(args.current)
                args.i += 1
            try:
                if len(vals) > 0:
                    B = int(vals[0])
                    if not B or B < 20 or B > 34:
                        die("bad modbuild B %s", vals[0])
                if len(vals) > 1:
                    k = int(vals[1])
                    if not k or k < 1:
                        die("bad modbuild k %s", vals[1])
                if len(vals) > 2:
                    w = int(vals[2])
                    if not w:
                        die("bad modbuild w %s", vals[2])
                if len(vals) > 3:
                    s = int(vals[3])
                    if not s:
                        die("bad modbuild w %s", vals[3])
            except ValueError:
                die("bad modbuild parameter")
            sh = Seqhash.create(k, w, s)
            out.write(sh.report())
            ms = Modset(sh, B, 0)
        elif ms is None and (m := args.match("-r", "--read", 2)):
            try:
                ms = Modset.read(m[1])
            except (IOError, FileNotFoundError):
                die("failed to open mod file %s", m[1])
            ms.summary(out)
        elif ms is not None and (m := args.match("-w", "--write", 2)):
            if writer:
                ms.write(m[1])
        elif ms is None and (m := args.match("-rt", "--readtext", 2)):
            try:
                f = open(m[1])
            except OSError:
                die("failed to open text file %s", m[1])
            with f:
                ms = Modset.read_text(f)
            ms.summary(out)
        elif ms is not None and (m := args.match("-wt", "--writetext", 2)):
            try:
                f = open_out(m[1])
            except OSError:
                die("failed to open text file %s", m[1])
            with f:
                ms.write_text(f)
        elif ms is not None and (m := args.match("-p", "--prune", 3)):
            ms.depth_prune(int(m[1]), int(m[2]))
            ms.summary(out)
        elif ms is not None and (m := args.match("-s", "--setcopy", 4)):
            ms.set_copy_thresholds(int(m[1]), int(m[2]), int(m[3]))
            ms.summary(out)
        elif ms is not None and (m := args.match("-sM", "--setcopyM", 2)):
            ms.set_copyM_threshold(int(m[1]))
            ms.summary(out)
        elif ms is not None and (m := args.match("-a", "--add", 2)):
            if not add_sequence_file(ms, get_scanner(), m[1], out,
                                     builders=builders, mesh=mesh):
                die("failed to open sequence file %s", m[1])
            ms.summary(out)
        elif ms is not None and (m := args.match("-x", "--add10x", 2)):
            if not add_sequence_file(ms, get_scanner(), m[1], out, is10x=True,
                                     builders=builders, mesh=mesh):
                die("failed to open sequence file %s", m[1])
            ms.summary(out)
        elif ms is not None and (m := args.match("-m", "--merge", 2)):
            try:
                ms2 = Modset.read(m[1])
            except (IOError, FileNotFoundError):
                die("failed to open mod file %s", m[1])
            ms2.summary(out)
            if not ms.merge(ms2):
                sys.stderr.write(
                    "modset %s incompatible with current - unable to merge\n" % m[1])
            ms.summary(out)
        elif ms is not None and (m := args.match("-H", "--hist", 2)):
            try:
                f = open_out(m[1])
            except OSError:
                die("failed to open histogram file %s", m[1])
            with f:
                depth_histogram(ms, f)
        elif ms is not None and (m := args.match("-d", "--depths", 2)):
            try:
                fd = open_out(m[1])
            except OSError:
                die("failed to open depths file %s", m[1])
            others = []
            for name in args.take_while_not_flag():
                try:
                    other = Modset.read(name)
                except (IOError, FileNotFoundError):
                    die("failed to open mod file %s", name)
                others.append(other)
                other.summary(out)
            with fd:
                report_depths(ms, others, fd)
        elif ms is not None and (m := args.match("-P", "--refpaint", 2)):
            try:
                batch, _t = seqio.read_seq_file(m[1], seqio.dna2index_n0(),
                                                is_qual=False, want_ids=True)
            except (IOError, ValueError, FileNotFoundError):
                die("failed to open ref seq file %s", m[1])
            kmers, rid, rpos, _isF = get_scanner().scan_batch(batch)
            idx = ms.find_batch(kmers)
            lens = batch.lengths
            for i in range(batch.n):
                sys.stdout.write("painting %s length %d\n"
                                 % (batch.ids[i], int(lens[i])))
                sel = rid == i
                for p, ix in zip(rpos[sel], idx[sel]):
                    if ix:
                        sys.stdout.write("  %d\t%d\n" % (int(p), int(ms.depth[ix])))
        else:
            die("unknown command %s - run without arguments for usage", args.current)

        timer.update(out.f)

    finish(out, timer)
    return scanner


if __name__ == "__main__":
    main()
