"""What ``modutils -c B k w s -a reads.fa -s c1 c2 cM`` must produce: the
table (each distinct canonical modimizer in order of first occurrence,
its depth and its copy flags) and the lines it prints, timing lines
left out (the reference C tool's modutils.c and modset.c)."""

import numpy as np

from .seqhash_ref import emit_reads, first_seen, hash_factors


def copy_flags(depth, thresholds):
    """modutils -s c1 c2 cM: copy 0 below c1, 1 below c2, 2 below cM,
    else 3 (M)."""
    c1, c2, cm = thresholds
    return np.select([depth < c1, depth < c2, depth < cm], [0, 1, 2],
                     3).astype(np.uint8)


def summary_lines(k, w, seed, bits, depth, info):
    """modsetSummary's text for a table of these depths and flags."""
    n = len(depth)
    out = ["SH k %d  w/m %d  s %d" % (k, w, seed)]
    head = "MS table bits %d size %d number of entries %d" % (bits, 1 << bits,
                                                            n)
    if not n:
        return out + [head]
    hist = np.bincount(depth, minlength=int(depth.max()) + 1)
    tot = int((np.arange(len(hist)) * hist).sum())
    half = tot // 2
    n50 = len(hist)
    cum = 0
    for j, h in enumerate(hist):
        cum += j * int(h)
        if half - cum < 0:
            n50 = j
            break
    copies = np.bincount(info & 3, minlength=4)
    line = "MS average depth %.1f N50 depth %d" % (tot / n, n50)
    if copies[0] < n:
        line += " copy0 %d copy1 %d copy2 %d copyM %d" % tuple(copies)
    return out + [head + " total count %d" % tot, line]


def table(reads, cfg, device, kmer_bits=64, lens=None):
    """The table of ``reads`` ([n, L] uint8 codes, each ``lens[i]`` long):
    per emitting position (stream order) the read, the position and the
    canonical k-mer (u64); the distinct k-mers in order of first
    occurrence, their depths and copy flags, and each position's id (1 +
    its k-mer's rank).  ``kmer_bits`` 32 keys the table by the k-mers' low
    32 bits (the control)."""
    f1, _f2 = hash_factors(cfg["hash_seed"])
    read, pos, km = emit_reads(reads, cfg["k"], cfg["w"], f1, device, lens)
    key = km & np.uint64(0xFFFFFFFF) if kmer_bits == 32 else km
    kmers, counts, ids = first_seen(key)
    depth = np.minimum(counts, 0xFFFF).astype(np.uint16)
    return {"read": read, "pos": pos, "km": km, "kmers": kmers,
            "depth": depth, "info": copy_flags(depth, cfg["copy_thresholds"]),
            "ids": ids}


def build(reads, cfg, device, kmer_bits=64, lens=None):
    """The expected table and text of one build job on ``reads`` ([n, L]
    uint8 codes, each ``lens[i]`` long, all L where None): {"kmers",
    "depth", "info" (numpy, in id order), "lines", "rows" (positions
    emitted), "bases"}.  ``kmer_bits`` 32 computes the control: the k-mers
    counted by their low 32 bits."""
    k, w, seed, bits = cfg["k"], cfg["w"], cfg["hash_seed"], cfg["table_bits"]
    t = table(reads, cfg, device, kmer_bits, lens)
    n, L = reads.shape
    total = n * L if lens is None else int(lens.sum())
    lines = ["SH k %d  w/m %d  s %d" % (k, w, seed)]
    lines.append("added %d sequences total length %d total hashes %d, new "
                 "max %d" % (n, total, len(t["km"]), len(t["kmers"])))
    lines += summary_lines(k, w, seed, bits, t["depth"],
                           np.zeros_like(t["info"]))
    lines += summary_lines(k, w, seed, bits, t["depth"], t["info"])
    return {"kmers": t["kmers"], "depth": t["depth"], "info": t["info"],
            "lines": lines, "rows": len(t["km"]), "bases": total}
