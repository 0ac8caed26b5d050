"""modasm on the PyTorch port: long-read overlap/assembly engine
(reference: modasm.c; port of ``modimizer_tpu/cli/modasm.py``).

Readset construction runs the port's scanner on the device + batched table
lookup (core/readset.py); findOverlaps phase 1 for -b/-c/-o2/-u runs as a
self-join on the device (parallel/overlaps.py, the CUDA kernel
``overlap_pairs`` on the card) when ``_use_device_overlaps`` says so, and
feeds the native *_pre phase-2 engines; otherwise, and for the other
irregular per-read analyses, the native C++ runtime
(native/modasm_native.cpp) walks the readset.  Both give the same bytes.
Unlike modutils/modmap, the reference modasm does NOT echo COMMAND lines
(modasm.c:1534-1536 are commented out).

    python -m modimizer_tpu_torch.cli.modasm -m X.mod -f reads.fa -b -c -u
"""

import sys

import numpy as np

from ..core.modset import Modset
from ..core.readset import Readset
from ..utils import profiling
from ..utils.timers import Timer
from .common import cli_guard, Args, OutFile, die, finish

TOPBIT = 0x80000000


def _use_device_overlaps(rs) -> bool:
    """Overlap-discovery backend policy, the JAX CLI's size rule: device
    phase 1 when the readset's scan ran on a CUDA device and it holds
    2^20 hits or more; on small inputs the serial native walk wins.
    Override with MODIMIZER_OVERLAPS=device|host."""
    import os
    mode = os.environ.get("MODIMIZER_OVERLAPS", "auto")
    if mode == "device":
        return True
    if mode == "host":
        return False
    return (rs.device is not None and rs.device.type == "cuda"
            and rs.tot_hit >= (1 << 20))


def _find_overlaps(rs, name, out_f, *front, device=None):
    """findOverlaps for the native engine ``name``: phase 1 on the device of
    the readset's scan (else ``device``, the CLI's), then the phase-2
    engine ``name``_pre, when ``_use_device_overlaps`` says so; else the
    native walk ``name``.  Stage timers (MODIMIZER_STAGES=1): asm.phase1,
    asm.phase2, asm.walk; counter phase2.pairs (the candidate rows the
    answer pass of -b and -c answered)."""
    if _use_device_overlaps(rs):
        with profiling.span("asm.phase1"):
            cy, ch, co = rs.device_overlap_candidates(
                device=rs.device if rs.device is not None else device)
        with profiling.span("asm.phase2"):
            pairs = rs.native_call(name + "_pre", out_f, *front, cy, ch, co)
        if pairs is not None:
            profiling.count("phase2.pairs", pairs)
    else:
        with profiling.span("asm.walk"):
            rs.native_call(name, out_f, *front)


def usage(num_threads):
    e = sys.stderr.write
    e("Usage: modasm <commands>\n")
    e("Commands are executed in order - set parameters before using them!\n")
    e("  -v | --verbose : toggle verbose mode\n")
    e("  -t | --threads <number of threads for parallel ops> [%d]\n"
      % num_threads)
    e("  -o | --output <output filename> : '-' for stdout\n")
    e("  -m | --modset <mod file>\n")
    e("  -f | --seqfile <file of reads: fasta/q, can be gzipped, or binary>\n")
    e("  -w | --write <file stem> : writes assembly files\n")
    e("  -r | --read <file stem> : read assembly files\n")
    e("  -S | --stats : give readset stats\n")
    e("  -o1 | --overlap1 <read> : find overlaps for given read\n")
    e("  -o2 | --overlap2 <k> : give overlap stats for every k'th read\n")
    e("  -o3 | --overlap3 <read1> <read2> : print details of overlap\n")
    e("  -b | --markBadReads : identify and categorise bad reads\n")
    e("  -c | --markContained : identify contained reads\n")
    e("  -a1 | --assemble1 <read> : assemble starting from given read\n")
    e("  -a2 | --assemble2 <mod> : assemble starting from given mod\n")
    e("  -u | --cluster : single linkage cluster reads using good overlaps\n")
    e("  -C | --cleanmods : set repeat and minor allele flags\n")
    e("  -T | --testmods <minDepth> <maxDepth> : set copy0 if not read-LD"
      " consistent\n")
    e("  -R | --ref <ref seq file> : set rDNA info\n")
    e("  -rb | --resetbits <n> : various cookery operations - see code\n")
    e("  -P | --readProperties : info about reads\n")
    sys.exit(0)


def ref_flag(rs: Readset, filename, out, device=None):
    """refFlag (modasm.c:752-777): scan of the rDNA reference on
    ``device``, then the native flag/read passes."""
    import ctypes
    import os
    from ..io import seqio
    from ..ops.seqhash import ModimizerScanner
    if not os.path.exists(filename):
        die("failed to open ref seq file %s", filename)
    batch, _t = seqio.read_seq_file(filename, seqio.dna2index_n0(),
                                    is_qual=False, want_ids=False)
    scanner = ModimizerScanner(rs.ms.hasher, device=device)
    kmers, _rid, rpos, _f = scanner.scan_batch(batch)
    sidx = rs.ms.find_batch(kmers)
    found = sidx != 0
    idx = np.ascontiguousarray(sidx[found], np.uint32)
    pos = np.ascontiguousarray(rpos[found], np.int32)
    rs.ensure_mod_info()
    from ..native import lib as native_lib
    sys.stdout.flush()
    out.flush()
    try:
        fd_out = out.f.fileno()
    except (AttributeError, OSError):
        fd_out = sys.stdout.fileno()
    v = rs._view(fd_out, sys.stdout.fileno())
    native_lib().rs_ref_flag(ctypes.byref(v), idx, pos, len(idx))


@cli_guard
def main(argv=None, device=None):
    """Run modasm commands in order.  device: a torch.device (or its name)
    for the scans and the overlap self-join; None takes the CUDA card and
    raises without one.  ``device="cpu"`` runs the kernels' plain
    versions; MODIMIZER_SCAN=host asks for the native host scan."""
    argv = list(sys.argv[1:] if argv is None else argv)
    out = OutFile()
    timer = Timer()
    timer.update(sys.stdout)
    num_threads = 1
    is_verbose = False

    if not argv:
        usage(num_threads)

    ms = None
    rs = None

    def need_rs():
        if rs is None:
            die("no readset loaded - use -f or -r first")
        return rs

    args = Args(argv)
    while args:
        if not args.current.startswith("-"):
            die("option/command %s does not start with '-': run without"
                " arguments for usage", args.current)

        if (m := args.match("-t", "--threads", 2)):
            sys.stderr.write(
                "  can't set thread number - not compiled with OMP\n")
        elif args.match("-v", "--verbose", 1):
            is_verbose = not is_verbose
        elif (m := args.match("-o", "--output", 2)):
            out.set(m[1])
        elif (m := args.match("-m", "--modset", 2)):
            import os
            if not os.path.exists(m[1]):
                die("failed to open mod file %s", m[1])
            ms = Modset.read(m[1])
            if ms.max >= TOPBIT:
                die("too many entries in modset")
            ms.summary(out)
        elif (m := args.match("-f", "--seqfile", 2)):
            if ms:
                rs = Readset(ms)
                try:
                    rs.file_read(m[1], device=device)
                except (IOError, FileNotFoundError, ValueError):
                    die("failed to open read sequence file %s", m[1])
            else:
                sys.stderr.write(
                    "** need to read a modset before a sequence file\n")
        elif (m := args.match("-r", "--read", 2)):
            import os
            if not os.path.exists(m[1] + ".mod"):
                die("can't open file %s.mod", m[1])
            if not os.path.exists(m[1] + ".readset"):
                die("can't open file %s.readset", m[1])
            rs = Readset.read(m[1])
            ms = rs.ms
        elif (m := args.match("-w", "--write", 2)):
            need_rs().write(m[1])
        elif args.match("-S", "--stats", 1):
            need_rs().stats(out)
        elif (m := args.match("-o1", "--overlaps1", 2)):
            need_rs().native_call("rs_find_overlaps", out.f, int(m[1]), 2)
        elif (m := args.match("-o2", "--overlaps2", 2)):
            _find_overlaps(need_rs(), "rs_overlaps_every", out.f, int(m[1]),
                           device=device)
        elif (m := args.match("-o3", "--overlap", 3)):
            need_rs().native_call("rs_print_overlap", out.f,
                                  int(m[1]), int(m[2]))
        elif args.match("-b", "--markBadReads", 1):
            _find_overlaps(need_rs(), "rs_mark_bad", out.f, device=device)
        elif args.match("-c", "--markContained", 1):
            _find_overlaps(need_rs(), "rs_mark_contained", out.f,
                           device=device)
        elif (m := args.match("-a1", "--assemble1", 2)):
            need_rs().native_call("rs_assemble_from_read", out.f, int(m[1]))
        elif (m := args.match("-a2", "--assemble2", 3)):
            need_rs().native_call("rs_assemble_from_mod", out.f,
                                  int(m[1]), int(m[2]), int(is_verbose))
        elif args.match("-u", "--cluster", 1):
            _find_overlaps(need_rs(), "rs_cluster", out.f, device=device)
        elif args.match("-C", "--cleanmods", 1):
            need_rs().native_call("rs_clean_mods", out.f)
        elif (m := args.match("-T", "--testmods", 3)):
            # the modInfo check lives in the native engine AFTER the YY/ZZ
            # side files are created, matching the reference's file-then-die
            # order (modasm.c:604-609)
            need_rs().native_call("rs_test_mods", out.f, int(m[1]), int(m[2]))
        elif (m := args.match("-R", "--ref", 2)):
            ref_flag(need_rs(), m[1], out, device)
        elif (m := args.match("-rb", "--resetbits", 2)):
            r = need_rs()
            r.ensure_mod_info()
            r.native_call("rs_reset_bits", out.f, int(m[1]))
        elif args.match("-P", "--readProperties", 1):
            need_rs().native_call("rs_read_properties", out.f)
        else:
            die("unkown command %s - run without arguments for usage",
                args.current)

        timer.update(out.f)

    finish(out, timer)


if __name__ == "__main__":
    main()
