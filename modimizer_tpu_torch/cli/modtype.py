"""modtype: SV genotyping-by-breakpoint-kmers scaffold (reference: modtype.c).

The port's copy of ``modimizer_tpu/cli/modtype.py``: host code on the
port's own ``io``, ``utils`` and ``cli.common``.

The reference's main analysis is unimplemented — main() reads the reference
FASTA, the insertion-sites ONE file and the samples ONE file, then stops
(modtype.c:240-245).  We reproduce that surface exactly, on top of the
native ONE-code subset (io/onecode.py) and the batched sequence reader.
"""

import sys

from ..io import seqio
from ..io.carray import CDict
from ..io.onecode import OneFile, OneSchema
from ..utils.timers import Timer
from .common import cli_guard, Args, OutFile, die, finish

# embedded schema, verbatim (modtype.c:40-60)
SCHEMA_TEXT = (
    "1 3 def 1 0  schema for modtype\n"
    ".\n"
    "P 3 var                    variant file\n"
    "S 3 ins                    insertion file\n"
    "G c 2 3 INT 6 STRING          chromosome\n"
    "O I 2 3 INT 3 INT             insertion between left_pos and right_pos\n"
    "D A 1 4 CHAR                  0 for ref ancestral, 1 for alt ancestral\n"
    "D G 1 6 STRING                genotype: 0, 1 or 2 as a char per sample\n"
    "D K 2 4 CHAR 3 DNA            L|R, reference kmer up to left/right"
    " position\n"
    "D k 2 4 CHAR 3 DNA            L|R, insertion kmer following left/right"
    " position\n"
    "D L 1 8 INT_LIST              per sample numbers of left breakpoint"
    " insertion spans\n"
    "D R 1 8 INT_LIST              per sample numbers of right breakpoint"
    " insertion spans\n"
    "D F 1 8 INT_LIST              per sample numbers of reference spans\n"
    ".\n"
    "P 3 smp                    sample file\n"
    "O N 1 6 STRING                sample name\n"
    "D F 1 6 STRING                filename\n"
    "D C 1 4 REAL                  coverage\n"
    ".\n"
    "P 3 nul                    empty file - comments only\n")


def usage(num_threads):
    e = sys.stderr.write
    e("Usage: modtype OPTIONS <reference> <sitefile> <samplefile>\n")
    e("  -v | --verbose : toggle verbose mode\n")
    e("  -t | --threads <number of threads for parallel ops> [%d]\n"
      % num_threads)
    e("  -o | --output <output filename> : '-' for stdout\n")
    sys.exit(1)


class Reference:
    """referenceRead (modtype.c:99-121)."""

    def __init__(self, filename):
        try:
            batch, _t = seqio.read_seq_file(filename, None, is_qual=False,
                                            want_ids=True)
        except (IOError, FileNotFoundError, ValueError):
            die("failed to open reference sequence file %s", filename)
        self.names = CDict(64)
        self.len = []
        tot_len = 0
        for i, name in enumerate(batch.ids):
            _id, is_new = self.names.add(name)
            if not is_new:
                die("duplicate sequence name %s in reference", name)
            self.len.append(int(batch.lengths[i]))
            tot_len += int(batch.lengths[i])
        sys.stderr.write(
            "  reference read %d sequences total length %d from %s\n"
            % (len(self.len), tot_len, filename))


def sites_read(filename, schema, ref):
    """sitesRead (modtype.c:125-155)."""
    vf = OneFile.open_read(filename, schema, "ins")
    if not vf:
        die("failed to open sites file %s", filename)
    sites = []
    chrom = None
    cmax = 0
    while vf.read_line() is not None:
        t = vf.lineType
        if t == "c":
            found, _pos = ref.names.find(vf.one_string())
            if found is None:
                die("bad contig/chrom name %s at line %d in %s",
                    vf.one_string(), vf.line, filename)
            chrom = found
            cmax = ref.len[chrom]
        elif t == "I":
            left, right = vf.one_int(0), vf.one_int(1)
            if left >= right:
                die("positions out of order at line %d in site file %s",
                    vf.line, filename)
            if left < 0:
                die("left position %d at line %d in %s is < 0", left,
                    vf.line, filename)
            if right > cmax:
                die("right position %d at line %d in %s is > %d", right,
                    vf.line, filename, cmax)
            sites.append((chrom, left, right))
    return sites


def samples_read(filename, schema):
    """samplesRead (modtype.c:159-187)."""
    vf = OneFile.open_read(filename, schema, "smp")
    if not vf:
        die("failed to open samples file %s", filename)
    names = CDict(256)
    samples = []
    cur = None
    while vf.read_line() is not None:
        t = vf.lineType
        if t == "N":
            _k, is_new = names.add(vf.one_string())
            if not is_new:
                die("duplicate sample name %s", vf.one_string())
            cur = {"fileName": None, "coverage": 0.0}
            samples.append(cur)
        elif t == "F":
            cur["fileName"] = vf.one_string()
        elif t == "C":
            cur["coverage"] = vf.one_real(0)
    sys.stderr.write("read %d samples from %s\n" % (names.max, filename))
    return samples


@cli_guard
def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    out = OutFile()
    timer = Timer()
    timer.update(sys.stdout)
    num_threads = 1
    schema = OneSchema.from_text(SCHEMA_TEXT)

    if not argv:
        usage(num_threads)

    args = Args(argv)
    while args.remaining() > 3:
        if not args.current.startswith("-"):
            die("option/command %s does not start with '-': run without"
                " arguments for usage", args.current)
        if args.match("-v", "--verbose", 1):
            pass
        elif args.match("-t", "--threads", 2):
            sys.stderr.write(
                "  can't set thread number - not compiled with OMP\n")
        elif (m := args.match("-o", "--output", 2)):
            out.set(m[1])
        else:
            die("unkown command %s - run without arguments for usage",
                args.current)
        timer.update(out.f)

    if args.remaining() != 3:
        die("missing three file names after options - run without args for"
            " usage")
    ref_file, site_file, sample_file = args.argv[args.i:args.i + 3]

    ref = Reference(ref_file)
    sites_read(site_file, schema, ref)
    samples_read(sample_file, schema)

    finish(out, timer)


if __name__ == "__main__":
    main()
