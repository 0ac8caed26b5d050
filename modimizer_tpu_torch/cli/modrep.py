"""modrep on the PyTorch port: rDNA / tandem-repeat read analysis
(reference: modrep.c; port of ``modimizer_tpu/cli/modrep.py``).

    python -m modimizer_tpu_torch.cli.modrep -R unit.fa unit.mod -s1 reads.fa reads.mod

The k-mer scans run on the device through the port's scanner
(ops/seqhash; the CUDA kernels scan_compact and densify on the card; the
lookups are the host table's) in two stream passes — one over
the raw reads for the orientation vote against the single-sequence reference,
one over the orientation-corrected good reads for hit collection — replacing
the reference's per-read rolling iterators (modrep.c:195-233).  The co-
occurrence analyses (move-to-front pre/post adjacency lists, block grouping)
are small host-side structures reproduced exactly.

NB the reference allocates its per-mod array with ms->max entries although
mod ids run 1..max (modrep.c:186): hits on the last-inserted mod write past
the array and -s1 segfaults once that mod reaches buildPrePost.  We size
max+1 and stay well-defined; outputs are identical whenever the reference
itself survives.
"""

import sys

import numpy as np

from ..core.modset import Modset
from ..ops.seqhash import ModimizerScanner
from ..utils.timers import Timer
from .common import cli_guard, Args, OutFile, die

BOUNDARY = [1, 961, 1951, 2961]  # modrep.c:493-496


def usage():
    e = sys.stderr.write
    e("Usage: modrep <commands>\n")
    e("Commands are executed in order - set parameters before using them!\n")
    e("  -v | --verbose : toggle verbose mode\n")
    e("  -o | --output <output_filename> : '-' for stdout\n")
    e("  -R | --ref <seq_file> <mod_file>\n")
    e("  -s1 | --seq1 <seq_file> <mod_file>: analyse reads\n")
    e("  -s2 | --seq2 <seq_file> <mod_file>: analyse reads\n")
    e("  -s3 | --seq3 <seq_file> <mod_file>: analyse reads\n")
    sys.exit(0)


class Ref:
    """refCreate (modrep.c:27-63): single-sequence reference mod->pos map."""

    def __init__(self, seq_file, mod_file, device=None):
        import os
        from ..io import seqio
        if not os.path.exists(mod_file):
            die("failed to open mod file %s", mod_file)
        self.ms = Modset.read(mod_file)
        n_mods = self.ms.max + 1
        self.pos = np.zeros(n_mods, np.int32)
        self.isF = np.zeros(n_mods, bool)
        self.len = 0
        try:
            batch, _t = seqio.read_seq_file(seq_file, seqio.dna2index_n0(),
                                            is_qual=False, want_ids=False)
        except (IOError, FileNotFoundError, ValueError):
            die("can't open reference sequence file %s", seq_file)
        if batch.n == 0:
            die("can't read reference sequence")
        if batch.n > 1:
            die("multiple sequences in ref file - only one allowed")
        self.device = device
        scanner = ModimizerScanner(self.ms.hasher, device=device)
        kmers, _rid, rpos, isF = scanner.scan_batch(batch)
        sidx = self.ms.find_batch(kmers)
        n = 0
        for t in range(len(sidx)):
            index = int(sidx[t])
            if not index:
                continue
            loc = int(rpos[t])
            if self.pos[index]:
                die("duplicate mod entry at position %d in ref", loc)
            self.pos[index] = loc
            self.isF[index] = bool(isF[t])
            if loc >= self.len:
                self.len = loc + 1
            n += 1
        sys.stderr.write("found %d of %d locations in ref length %d\n"
                         % (n, self.ms.max, int(batch.lengths[0])))


def _scan_and_find(ms_hasher, batch, ms, device=None):
    """Scan a batch with ms_hasher on ``device``, look kmers up in ms;
    returns per-kmer (read_id, pos, isF, index) in stream order."""
    scanner = ModimizerScanner(ms_hasher, device=device)
    kmers, rid, rpos, isF = scanner.scan_batch(batch)
    sidx = ms.find_batch(kmers)
    return rid, rpos, isF, sidx


def _orient_reads(ref: Ref, batch):
    """The per-read orientation vote (modrep.c:196-209): first 100 found-in-
    reference mods, seqF/seqR counts.  Returns (n, seqF, seqR) per read."""
    rid, _rpos, isF, sidx = _scan_and_find(ref.ms.hasher, batch, ref.ms,
                                           ref.device)
    found = sidx != 0
    rid_f = rid[found]
    same = isF[found] == ref.isF[sidx[found]]
    n_reads = batch.n
    n = np.zeros(n_reads, np.int32)
    seqF = np.zeros(n_reads, np.int32)
    seqR = np.zeros(n_reads, np.int32)
    bounds = np.searchsorted(rid_f, np.arange(n_reads + 1))
    for r in range(n_reads):
        a = bounds[r]
        b = min(bounds[r + 1], a + 100)  # vote stops at n == 100
        n[r] = b - a
        s = same[a:b]
        seqF[r] = int(s.sum())
        seqR[r] = (b - a) - seqF[r]
    return n, seqF, seqR


def _good_batch(batch, n, seqF, seqR, report_bad, out_write):
    """Filter bad reads, reverse-complement where seqF < seqR, and return
    (good SeqBatch-ish stream, original indices, flipped mask)."""
    from ..io.seqio import SeqBatch
    codes_out = []
    keep = []
    flipped = []
    for r in range(batch.n):
        if n[r] < 100 or (seqF[r] > 10 and seqR[r] > 10):
            if report_bad:
                out_write("BADREAD %5d len %5d n %d F %4d R %4d\n"
                          % (r + 1, int(batch.lengths[r]), int(n[r]),
                             int(seqF[r]), int(seqR[r])))
            continue
        s = np.ascontiguousarray(batch.seq(r)).view(np.uint8)
        if seqF[r] < seqR[r]:
            # reverse complement (modrep.c:215-220); 3-c == c^3 for 2-bit codes
            s = np.bitwise_xor(s[::-1], np.uint8(3))
            flipped.append(True)
        else:
            flipped.append(False)
        keep.append(r)
        codes_out.append(s)
    if codes_out:
        codes = np.concatenate(codes_out)
        lens = np.array([len(c) for c in codes_out], np.int64)
    else:
        codes = np.zeros(0, np.uint8)
        lens = np.zeros(0, np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    gb = SeqBatch(codes=codes, offsets=offsets)
    return gb, keep, flipped


class Hits:
    """Move-to-front adjacency list (addHit, modrep.c:129-148)."""

    __slots__ = ("k", "n", "x")

    def __init__(self):
        self.k = []
        self.n = []
        self.x = []

    def add(self, k, dx):
        ks = self.k
        for i in range(len(ks)):
            if ks[i] == k:
                self.n[i] += 1
                self.x[i] += dx
                if i and self.n[i] > self.n[0]:  # move to front
                    for a in (self.k, self.n, self.x):
                        a.insert(0, a.pop(i))
                return
        ks.append(k)
        self.n.append(1)
        self.x.append(dx)


class Mods:
    """Per-mod state arrays (Mod struct, modrep.c:92-95), sized max+1."""

    def __init__(self, n):
        self.n = np.zeros(n, np.int64)
        self.nPre = np.zeros(n, np.int64)
        self.nPost = np.zeros(n, np.int64)
        self.pre = [None] * n
        self.post = [None] * n


def clean_mods(mods: Mods, read_hits, ms_max, n_reads, out_write):
    """cleanMods (modrep.c:97-127): iterates i < ms->max (id max excluded)."""
    thresh = n_reads // 2
    nMod0 = nMod1 = nMod2 = nMod3 = 0
    for i in range(ms_max):
        if not mods.n[i]:
            nMod0 += 1
        elif mods.n[i] < 5:
            mods.n[i] = 0
            nMod1 += 1
        elif mods.n[i] > thresh:
            mods.n[i] = 0
            nMod2 += 1
        else:
            if mods.pre[i] is None:
                mods.pre[i] = Hits()
                mods.post[i] = Hits()
            nMod3 += 1
    out_write("NMOD mod0 %d modSmall %d modBig %d modGood %d\n"
              % (nMod0, nMod1, nMod2, nMod3))
    for hits in read_hits:
        hits[:] = [h for h in hits if mods.n[h[0]]]


def build_pre_post(mods: Mods, read_hits, ms_max):
    """buildPrePost (modrep.c:150-168)."""
    for i in range(ms_max):
        if mods.pre[i] is not None:
            mods.pre[i] = Hits()
            mods.post[i] = Hits()
            mods.nPre[i] = 0
            mods.nPost[i] = 0
    for hits in read_hits:
        for j in range(1, len(hits)):
            k0, x0 = hits[j - 1]
            k1, x1 = hits[j]
            dx = x1 - x0
            mods.post[k0].add(k1, dx)
            mods.nPost[k0] += 1
            mods.pre[k1].add(k0, dx)
            mods.nPre[k1] += 1


def _drop_redundant_and_bad(mods: Mods, ms_max):
    """The pre/post-based elimination pass (modrep.c:374-391)."""
    for i in range(ms_max):
        if not mods.n[i]:
            continue
        pre, post = mods.pre[i], mods.post[i]
        k0 = pre.k[0] if pre.k else 0
        n0 = pre.n[0] if pre.n else 0
        if pre.k and n0 == mods.n[i] and n0 == mods.nPost[k0]:
            mods.n[i] = 0  # no new info in this mod
            continue
        isBad = True
        nThresh = mods.n[i] // 2
        for j in range(len(pre.k)):
            if isBad and pre.n[j] >= 5 and (
                    pre.n[j] > nThresh or
                    pre.n[j] > mods.nPost[pre.k[j]] // 2):
                isBad = False
        for j in range(len(post.k)):
            if isBad and post.n[j] >= 5 and (
                    post.n[j] > nThresh or
                    post.n[j] > mods.nPre[post.k[j]] // 2):
                isBad = False
        if isBad:
            mods.n[i] = 0


def _collect_hits(good_batch, ref: Ref, ms: Modset):
    """Second scan: hits of the good, orientation-corrected reads against
    ms (scanned with the REFERENCE hasher, modrep.c:223,318)."""
    rid, rpos, _isF, sidx = _scan_and_find(ref.ms.hasher, good_batch, ms,
                                           ref.device)
    found = sidx != 0
    rid_f = rid[found]
    idx_f = sidx[found].astype(np.int64)
    pos_f = rpos[found].astype(np.int64)
    bounds = np.searchsorted(rid_f, np.arange(good_batch.n + 1))
    return idx_f, pos_f, bounds


def analyze3(seq_file, mod_file, ref: Ref, out_write, timer):
    """analyzeSequences3 (modrep.c:170-268)."""
    import os
    from ..io import seqio
    if not os.path.exists(mod_file):
        die("failed to open mod file %s", mod_file)
    ms = Modset.read(mod_file)
    try:
        batch, _t = seqio.read_seq_file(seq_file, seqio.dna2index_n0(),
                                        is_qual=False, want_ids=False)
    except (IOError, FileNotFoundError, ValueError):
        die("can't open sequence file %s", seq_file)
    n, seqF, seqR = _orient_reads(ref, batch)
    gb, keep, _flip = _good_batch(batch, n, seqF, seqR, True, out_write)
    idx_f, pos_f, bounds = _collect_hits(gb, ref, ms)

    mods = Mods(ms.max + 1)
    np.add.at(mods.n, idx_f, 1)
    read_hits = []
    for r in range(gb.n):
        a, b = bounds[r], bounds[r + 1]
        ks = idx_f[a:b]
        uniq, counts = np.unique(ks, return_counts=True)
        dup = counts > 1
        np.add.at(mods.nPre, uniq[dup], counts[dup] - 1)
        read_hits.append(list(zip(ks.tolist(), pos_f[a:b].tolist())))

    sys.stderr.write("read %d reads, %d bad, %d good: "
                     % (batch.n, batch.n - len(keep), len(keep)))
    dupsel = mods.nPre[:ms.max] > 0
    nDup = int(dupsel.sum())
    tDup = int(mods.nPre[:ms.max][dupsel].sum())
    nMod = ms.max - nDup
    mods.n[:ms.max][dupsel] = 0
    sys.stderr.write("mods total %d good %d dup %d avdup %.1f\n"
                     % (ms.max, nMod, nDup, tDup / nDup if nDup else 0.))
    timer.update(sys.stderr)

    minMax = 0
    for hits in read_hits:
        mx = 0
        for k, _x in hits:
            if mods.n[k] > mx:
                mx = int(mods.n[k])
        if not minMax or mx < minMax:
            minMax = mx
    sys.stderr.write("minimum max for a read is %d\n" % minMax)


def analyze1(seq_file, mod_file, ref: Ref, out_write, timer):
    """analyzeSequences1 (modrep.c:272-489)."""
    import os
    from ..io import seqio
    if not os.path.exists(mod_file):
        die("failed to open mod file %s", mod_file)
    ms = Modset.read(mod_file)
    try:
        batch, _t = seqio.read_seq_file(seq_file, seqio.dna2index_n0(),
                                        is_qual=False, want_ids=False)
    except (IOError, FileNotFoundError, ValueError):
        die("can't open sequence file %s", seq_file)
    n, seqF, seqR = _orient_reads(ref, batch)
    gb, keep, _flip = _good_batch(batch, n, seqF, seqR, False, out_write)
    idx_f, pos_f, bounds = _collect_hits(gb, ref, ms)

    mods = Mods(ms.max + 1)
    np.add.at(mods.n, idx_f, 1)
    read_hits = []
    read_ids = []  # original read index r->i
    for r in range(gb.n):
        a, b = bounds[r], bounds[r + 1]
        read_hits.append(list(zip(idx_f[a:b].tolist(), pos_f[a:b].tolist())))
        read_ids.append(keep[r])

    sys.stderr.write("read %d reads, %d bad, %d good: "
                     % (batch.n, batch.n - len(keep), len(keep)))
    timer.update(sys.stderr)

    clean_mods(mods, read_hits, ms.max, len(read_hits), out_write)

    # pack runs closer than k (modrep.c:357-369)
    K = ms.hasher.k
    for hits in read_hits:
        xNext = 0
        kept = []
        for k, x in hits:
            if x >= xNext:
                kept.append((k, x))
                xNext = x + K
            else:
                mods.n[k] -= 1
        hits[:] = kept
    clean_mods(mods, read_hits, ms.max, len(read_hits), out_write)

    build_pre_post(mods, read_hits, ms.max)
    _drop_redundant_and_bad(mods, ms.max)
    clean_mods(mods, read_hits, ms.max, len(read_hits), out_write)

    # drop reads containing links with support < 5 (modrep.c:395-415)
    build_pre_post(mods, read_hits, ms.max)
    n_before = len(read_hits)
    kept_reads = []
    kept_ids = []
    for hits, rid0 in zip(read_hits, read_ids):
        weak = False
        for j in range(1, len(hits)):
            post = mods.post[hits[j - 1][0]]
            kj = hits[j][0]
            found = False
            for kp in range(len(post.k)):
                if post.k[kp] == kj:
                    found = True
                    if post.n[kp] < 5:
                        weak = True
                    break
            if not found:
                die("assert failed in modrep weak-link scan")
            if weak:
                break
        if not weak:
            kept_reads.append(hits)
            kept_ids.append(rid0)
    sys.stderr.write("reduced %d reads to %d reads\n"
                     % (n_before, len(kept_reads)))
    read_hits, read_ids = kept_reads, kept_ids

    # rebuild mods.n -- NB the reference skips each read's last hit
    # (modrep.c:421: loop from j=1 with h at hits[0])
    mods.n[:] = 0
    for hits in read_hits:
        for j in range(1, len(hits)):
            mods.n[hits[j - 1][0]] += 1
    clean_mods(mods, read_hits, ms.max, len(read_hits), out_write)

    build_pre_post(mods, read_hits, ms.max)
    _drop_redundant_and_bad(mods, ms.max)
    clean_mods(mods, read_hits, ms.max, len(read_hits), out_write)

    # report (modrep.c:449-480)
    build_pre_post(mods, read_hits, ms.max)
    for i in range(ms.max):
        if not mods.n[i]:
            continue
        parts = ["MOD %d n %d pre %d (" % (i, mods.n[i], mods.nPre[i])]
        pre, post = mods.pre[i], mods.post[i]
        for j in range(len(pre.k)):
            parts.append(" %d:%d|%d:%d" % (pre.k[j], pre.n[j],
                                           mods.nPost[pre.k[j]],
                                           pre.x[j] // pre.n[j]))
        parts.append(") post %d (" % mods.nPost[i])
        for j in range(len(post.k)):
            parts.append(" %d:%d|%d:%d" % (post.k[j], post.n[j],
                                           mods.nPre[post.k[j]],
                                           post.x[j] // post.n[j]))
        parts.append(")\n")
        out_write("".join(parts))

    # sort by hit-id sequence (readOrder, modrep.c:79-90; stable like glibc
    # msort) and print BLOCK transitions + READ lines
    order = sorted(range(len(read_hits)),
                   key=lambda i: tuple(k for k, _x in read_hits[i]))
    block = 0
    prev_key = None
    for pos_i, i in enumerate(order):
        key = tuple(k for k, _x in read_hits[i])
        if pos_i and key != prev_key:
            prev = order[pos_i - 1]
            out_write("BLOCK %3d" % block)
            block = 0
            out_write("".join("\t%5d" % k for k, _x in read_hits[prev]))
            out_write("\n")
        block += 1
        out_write("READ %5d n %3d mods" % (read_ids[i], len(read_hits[i])))
        out_write("".join("\t%5d" % k for k, _x in read_hits[i]))
        out_write("\n")
        prev_key = key


def analyze2(seq_file, mod_file, ref: Ref, out_write):
    """analyzeSequences2 (modrep.c:498-539): boundary-spanning read counts."""
    import os
    from ..io import seqio
    if not os.path.exists(mod_file):
        die("failed to open mod file %s", mod_file)
    Modset.read(mod_file)  # read and discard, like the reference
    try:
        batch, _t = seqio.read_seq_file(seq_file, seqio.dna2index_n0(),
                                        is_qual=False, want_ids=False)
    except (IOError, FileNotFoundError, ValueError):
        die("can't open sequence file %s", seq_file)
    rid, _rpos, _isF, sidx = _scan_and_find(ref.ms.hasher, batch, ref.ms,
                                            ref.device)
    counts = [0, 0, 0, 0]
    bounds = np.searchsorted(rid, np.arange(batch.n + 1))
    for r in range(batch.n):
        ks = set(sidx[bounds[r]:bounds[r + 1]].tolist())
        is_b = [b in ks for b in BOUNDARY]
        for t in range(4):
            if is_b[t] and is_b[(t + 1) % 4]:
                counts[t] += 1
    out_write("n1 %d n2 %d n3 %d n4 %d\n" % tuple(counts))


@cli_guard
def main(argv=None, device=None):
    """Run modrep commands in order.  device: a torch.device (or its name)
    for the scans; None takes the CUDA card and raises without one.
    ``device="cpu"`` runs the kernels' plain versions; MODIMIZER_SCAN=host
    asks for the native host scan."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        usage()
    out = OutFile()
    timer = Timer()
    timer.update(sys.stdout)
    # modrep prints everything through printf -> stdout; -o only swaps the
    # (unused) outFile, so we keep writing to stdout like the reference
    stdout_write = sys.stdout.write

    ref = None
    args = Args(argv)
    while args:
        if not args.current.startswith("-"):
            die("option/command %s does not start with '-': run without"
                " arguments for usage", args.current)
        args.echo_command()

        if args.match("-v", "--verbose", 1):
            pass
        elif (m := args.match("-o", "--output", 2)):
            out.set(m[1])
        elif (m := args.match("-R", "--ref", 3)):
            ref = Ref(m[1], m[2], device)
        elif (m := args.match("-s1", "--seq1", 3)):
            if not ref:
                die("you must read reference data with -R before command -s")
            analyze1(m[1], m[2], ref, stdout_write, timer)
        elif (m := args.match("-s2", "--seq2", 3)):
            if not ref:
                die("you must read reference data with -R before command -s")
            analyze2(m[1], m[2], ref, stdout_write)
        elif (m := args.match("-s3", "--seq3", 3)):
            if not ref:
                die("you must read reference data with -R before command -s")
            analyze3(m[1], m[2], ref, stdout_write, timer)
        else:
            die("unknown option %s", args.current)

    sys.stderr.write("total resources used: ")
    timer.total(sys.stderr)


if __name__ == "__main__":
    main()
