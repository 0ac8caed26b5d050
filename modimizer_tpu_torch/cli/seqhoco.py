"""seqhoco: homopolymer compression to gzipped FASTA stdout (reference: seqhoco.c).

The port's copy of ``modimizer_tpu/cli/seqhoco.py``: host code on the
port's own ``io``, ``utils`` and ``cli.common``.

Parity notes: the comparison is case-insensitive and keeps the first-seen
character's original case (seqhoco.c:30).  The reference's loop also reads
ONE PAST the sequence end (seqhoco.c:30 `*++s`); for FASTA/FASTQ input the
byte there is deterministic — seqio's in-place conversion leaves
convert['\\n'] = -2 = 0xfe at seq[seqLen] (seqio.c:322-324) — so every
output sequence carries a trailing 0xfe byte, which we replicate exactly
(verified across single-line/multi-line FASTA and FASTQ).  For binary/ONE
input the reference output is unconditioned garbage (2-bit codes compared
as text, out-of-bounds trailing byte); there we emit the evident intent:
clean hoco text, no trailing byte.
"""

import sys

import numpy as np

from ..io import seqio
from .common import cli_guard, die


@cli_guard
def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    fn = argv[0] if argv else "-"
    try:
        batch, ftype = seqio.read_seq_file(fn, seqio.dna2textConv,
                                           is_qual=False, want_ids=True)
    except (IOError, ValueError, FileNotFoundError):
        die("failed to read sequence file %s", fn)
    # the reference's one-past-the-end read (see module docstring)
    trailer = b"\xfe" if ftype in (seqio.FASTA, seqio.FASTQ) else b""
    wr = seqio.SeqWriter("-z", seqio.FASTA, seqio.dna2textConv, 0)
    for i in range(batch.n):
        seq = batch.seq(i).view(np.uint8)
        if len(seq) == 0:
            break  # reference stops at the first empty sequence (seqhoco.c:26)
        upper = np.where((seq >= ord("a")) & (seq <= ord("z")), seq - 32, seq)
        keep = np.ones(len(seq), bool)
        keep[1:] = upper[1:] != upper[:-1]  # case-insensitive run collapse
        hoco = seq[keep]  # keep first-seen original case
        wr.write(batch.ids[i] or None, None, hoco.tobytes() + trailer, None)
    wr.close()


if __name__ == "__main__":
    main()
