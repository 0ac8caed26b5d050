"""seqconvert: any->{fasta,fastq,binary,ONE} converter (reference: seqconvert.c).

The port's copy of ``modimizer_tpu/cli/seqconvert.py``: host code on the
port's own ``io``, ``utils`` and ``cli.common``.
"""

import sys

import numpy as np

from ..io import seqio
from ..utils.timers import Timer
from .common import cli_guard, die


def usage():
    e = sys.stderr.write
    e("Usage: seqconvert [-fa|fq|b|1] [-Q T] [-z] [-S] [-o outfile] [infile]\n")
    e("   .gz ending outfile name implies gzip compression\n")
    e("   -fa output as fasta, -fq as fastq, -b as binary, -1 as ONEcode\n")
    e("      else .fa or .fq in outfile name imply fasta, fastq else binary\n")
    e("   -Q sets the quality threshold for single bit quals in -b option [0]\n")
    e("   -S silent - else it reports to stderr on what it is doing\n")
    e("   NB gzip is not compatible with binary\n")
    e("   if no infile then use stdin\n")
    e("   if no -o option then use stdout and -z implies gzip\n")


@cli_guard
def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    timer = Timer()
    timer.update(sys.stderr)

    if not argv or argv[0] in ("-h", "--help"):
        usage()
        sys.exit(0)

    ftype = seqio.UNKNOWN
    verbose = True
    is_gzip = False
    in_name, out_name = "-", "-z"
    qual_thresh = 0
    while argv:
        a = argv.pop(0)
        if a == "-fa":
            ftype = seqio.FASTA
        elif a == "-fq":
            ftype = seqio.FASTQ
        elif a == "-b":
            ftype = seqio.BINARY
        elif a == "-1":
            ftype = seqio.ONE
        elif a == "-Q" and argv:
            qual_thresh = int(argv.pop(0))
        elif a == "-z":
            is_gzip = True
        elif a == "-o" and argv:
            out_name = argv.pop(0)
        elif a == "-S":
            verbose = False
        elif not argv and not a.startswith("-"):
            in_name = a
        else:
            die("unknown option %s - run without arguments for help\n", a)

    if out_name == "-z" and not is_gzip:
        out_name = "-"
    try:
        wr = seqio.SeqWriter(out_name, ftype, None, qual_thresh)
    except IOError:
        die("failed to open output file %s", out_name)
    is_qual = ((wr.type == seqio.BINARY and qual_thresh > 0)
               or wr.type == seqio.FASTQ or wr.type == seqio.ONE)
    try:
        batch, in_type = seqio.read_seq_file(in_name, None, is_qual=is_qual,
                                             want_ids=True)
    except (IOError, ValueError, FileNotFoundError):
        die("failed to open input file %s", in_name)
    if verbose:
        sys.stderr.write("reading from file type %s" % seqio.TYPE_NAMES[in_type])
        if in_type == seqio.BINARY:
            sys.stderr.write("  with %d sequences totLen %d"
                             % (batch.n, int(batch.lengths.sum())))
        sys.stderr.write("\n")

    for i in range(batch.n):
        seq = batch.seq(i)
        if in_type == seqio.BINARY:
            # stored as codes; reconstruct text like the intended read path
            seq = seq.view(np.uint8)
        qual = batch.qual(i) if (batch.quals is not None and is_qual) else None
        sid = batch.ids[i] if batch.ids and batch.ids[i] else None
        desc = batch.descs[i] if batch.descs and batch.descs[i] else None
        wr.write(sid, desc, seq.view(np.uint8).tobytes(), qual)
    wr.close()

    if verbose:
        sys.stderr.write(
            "written %d sequences to file type %s, total length %d, max length %d\n"
            % (wr.n_seq, seqio.TYPE_NAMES[wr.type], wr.tot_seq, wr.max_seq))
        timer.total(sys.stderr)


if __name__ == "__main__":
    main()
