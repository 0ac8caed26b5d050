"""composition: sequence-file statistics (reference: composition.c).

The port's copy of ``modimizer_tpu/cli/composition.py``: host code on the
port's own ``io``, ``utils`` and ``cli.common``.
"""

import sys

import numpy as np

from ..io import seqio
from ..utils.timers import Timer
from .common import cli_guard, die

LENGTH_BINS = 20


def usage():
    e = sys.stderr.write
    e("Usage: composition [opts] <filename>\n")
    e("  will read fasta, fastq, bam/sam/cram, 1code, custom-binary.  Use filename '-' for stdin (not 1code binary)\n")
    e("  options:\n")
    e("    -b : show base counts\n")
    e("    -q : show quality counts\n")
    e("    -t : show time and memory used\n")
    e("    -l : show length distribution in up to %d quadratic bins\n" % LENGTH_BINS)


@cli_guard
def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    want_bases = want_quals = is_time = want_lengths = False
    if not argv:
        usage()
        return
    while argv and argv[0].startswith("-") and argv[0] != "-":
        a = argv.pop(0)
        if a == "-b":
            want_bases = True
        elif a == "-q":
            want_quals = True
        elif a == "-t":
            is_time = True
        elif a == "-l":
            want_lengths = True
        else:
            usage()
            return

    timer = Timer()
    if is_time:
        timer.update(sys.stdout)

    fn = argv[0] if argv else "-"
    try:
        batch, ftype = seqio.read_seq_file(fn, None, is_qual=True,
                                           want_ids=False)
    except (IOError, ValueError, FileNotFoundError):
        die("failed to open sequence file %s\n", fn)

    is_qual = ftype in (seqio.FASTQ, seqio.BINARY) and batch.quals is not None
    lens = batch.lengths
    n = batch.n
    tot_len = int(lens.sum()) if n else 0
    len_min = int(lens.min()) if n else 0
    len_max = int(lens.max()) if n else 0
    w = sys.stdout.write
    # n == 0: C's 0.0/0 is the x86 default QNaN with the sign bit set, and
    # glibc printf renders it "-nan" (verified against the reference)
    avg = ("%.2f" % (tot_len / n)) if n else "-nan"
    w("%s file, %d sequences >= 0, %d total, %s average, %d min, %d max\n"
      % (seqio.TYPE_NAMES[ftype], n, tot_len, avg, len_min, len_max))

    if want_bases:
        from ..native import byte_hist256
        counts = byte_hist256(batch.codes)
        w("bases\n")
        unprint = 0
        for i in range(256):
            if counts[i]:
                ch = chr(i)
                if ch.isprintable() and i < 127 and i >= 32:
                    w("  %c %d %4.1f %%\n" % (ch, counts[i],
                                              counts[i] * 100.0 / tot_len))
                else:
                    unprint += int(counts[i])
        if unprint:
            w(" unprintable %d %4.1f %%\n" % (unprint, unprint * 100.0 / tot_len))

    if want_quals and is_qual:
        w("qualities\n")
        from ..native import byte_hist256
        qc = byte_hist256(batch.quals)
        cum = 0
        for i in range(256):
            cum += int(qc[i])
            if qc[i]:
                w(" %3d %d %4.1f %% %5.1f %%\n"
                  % (i, qc[i], qc[i] * 100.0 / tot_len, cum * 100.0 / tot_len))

    if want_lengths and n:
        bins = (10.0 * np.sqrt(lens.astype(np.float64))).astype(np.int64)
        nbins = int(bins.max()) + 1
        length_count = np.bincount(bins, minlength=nbins)
        length_sum = np.bincount(bins, weights=lens.astype(np.float64),
                                 minlength=nbins).astype(np.int64)
        if len_min < len_max:
            tot50 = 0
            i = 0
            while i < nbins and tot50 < 0.5 * tot_len:
                tot50 += int(length_sum[i])
                i += 1
            w("approximate N50 %d\n" % ((i * (i + 1)) // 100))
            w("length distribution (quadratic bins)\n")
            s = 0
            d = nbins // 20
            if d == 0:
                d = 1  # reference divides by zero here for maxLen < 4
            for i in range(nbins):
                s += int(length_count[i])
                if s and not ((nbins - 1 - i) % d):
                    w("  %d\t%d\n" % ((i * i) // 100, s))
                    s = 0

    if is_time:
        timer.total(sys.stdout)


if __name__ == "__main__":
    main()
