"""The benchmark's inputs, made from ``--seed`` alone: a uniform random
genome and reads sampled from it, as a configuration file sizes them
(the generators of the port's smoke run, ``write_fasta`` and
``sampled_reads``, made vectorised).

Every seed gives the same sizes; only the bases differ.  A read is the
genome from a uniform start, a fraction ``sub_rate`` of its bases drawn
anew (so about three quarters of those change), and every
``rc_every``-th read reverse-complemented."""

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def genome(rng, length):
    """Uniform random bases (codes 0..3), no N and no repeats."""
    return rng.integers(0, 4, length, dtype=np.uint8)


def sampled_reads(rng, seq, n, length, sub_rate, rc_every):
    """[n, length] uint8 codes: reads of ``seq`` at uniform starts."""
    starts = rng.integers(0, len(seq) - length + 1, n)
    reads = np.lib.stride_tricks.sliding_window_view(seq, length)[starts]
    n_sub = rng.binomial(n * length, sub_rate)
    at = rng.integers(0, n * length, n_sub)
    reads.reshape(-1)[at] = rng.integers(0, 4, n_sub, dtype=np.uint8)
    rc = np.arange(n) % rc_every == rc_every - 1
    reads[rc] = 3 - reads[rc, ::-1]
    return reads


def make_inputs(cfg, seed):
    """{"genome": codes, "reads": [n, L] codes} for configuration ``cfg``
    and ``seed``."""
    rng = np.random.default_rng(seed)
    g = genome(rng, cfg["genome_len"])
    return {"genome": g,
            "reads": sampled_reads(rng, g, cfg["n_reads"], cfg["read_len"],
                                   cfg["sub_rate"], cfg["rc_every"])}


def write_fasta(path, names, seqs):
    """One record a sequence, its bases on one line."""
    with open(path, "wb") as f:
        for name, codes in zip(names, seqs):
            f.write(b">" + name.encode() + b"\n")
            f.write(ACGT[codes].tobytes())
            f.write(b"\n")


def write_inputs(inputs, cfg, needed, directory):
    """Write the FASTA files a job reads: "genome" (one record named
    cfg["genome_name"]) and "reads" (r0, r1, ...).  {input: path}."""
    paths = {}
    for name in needed:
        path = "%s/%s.fa" % (directory, name)
        if name == "genome":
            write_fasta(path, [cfg["genome_name"]], [inputs["genome"]])
        else:
            reads = inputs["reads"]
            write_fasta(path, ("r%d" % i for i in range(len(reads))), reads)
        paths[name] = path
    return paths
