"""The benchmark's inputs, made from ``--seed`` alone: a uniform random
genome and reads sampled from it, as a configuration file sizes them
(the generators of the port's smoke run, ``write_fasta`` and
``sampled_reads``, made vectorised).

Every seed gives the same sizes; only the bases differ.  A read is the
genome from a uniform start, a fraction ``sub_rate`` of its bases drawn
anew (so about three quarters of those change), and every
``rc_every``-th read reverse-complemented.  Every read has the
configuration's ``read_len``, unless the traffic file gives
``"read_lengths"``: then the lengths spread around it (``read_lengths``:
the same set of lengths for every seed, in the seed's order) and a share
of the reads fold back on themselves (``inverted``).  Reads of unequal
lengths are held padded with zeros, ``"read_lens"`` giving each one's
length.

A traffic file names the inputs its jobs read, each of one kind
(``KINDS``): ``"genome"`` and ``"reads"`` are FASTA files, ``"modset"``
is the binary modset (``.mod``) that ``modutils -c {table_bits} {k} {w}
{hash_seed} -a {reads} -s {copy_thresholds} -w`` would write, made by
the plain reference (``reference/build_ref.py``, ``reference/
modset_file.py``) and nothing of the port."""

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


def read_lengths(n, mean, spread):
    """The n read lengths of every seed: n evenly spaced quantiles of a
    lognormal of this mean and ``spread["sigma"]``, rounded and clipped to
    [``spread["min"]``, ``spread["max"]``]."""
    from statistics import NormalDist
    s = spread["sigma"]
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    lens = np.rint(mean * np.exp(s * z - s * s / 2))
    return np.clip(lens, spread["min"], spread["max"]).astype(np.int64)


def spread_reads(rng, seq, lens, sub_rate, rc_every, inverted):
    """([n, max(lens)] uint8 codes padded with 0, their lengths): reads of
    ``seq`` of the lengths ``lens`` in the seed's order, at uniform starts,
    substituted as ``sampled_reads`` does.  A share ``inverted`` of them
    (a fixed count, the seed's reads) is an inverted duplicate: its first
    half, then that half's reverse complement back over it, as a molecule
    read through a missing adapter.  Every ``rc_every``-th read is
    reverse-complemented last."""
    lens = rng.permutation(lens)
    n = len(lens)
    starts = rng.integers(0, len(seq) - lens + 1)
    off = np.concatenate([[0], np.cumsum(lens)])
    flat = np.concatenate([seq[s:s + n_] for s, n_ in zip(starts, lens)])
    n_sub = rng.binomial(len(flat), sub_rate)
    at = rng.integers(0, len(flat), n_sub)
    flat[at] = rng.integers(0, 4, n_sub, dtype=np.uint8)
    folded = set(rng.choice(n, int(round(n * inverted)),
                            replace=False).tolist())
    reads = np.zeros((n, int(lens.max())), np.uint8)
    for i in range(n):
        r = reads[i, :lens[i]]
        r[:] = flat[off[i]:off[i + 1]]
        if i in folded:
            half = (lens[i] + 1) // 2
            r[half:] = (3 - r[:half][::-1])[:lens[i] - half]
        if i % rc_every == rc_every - 1:
            r[:] = 3 - r[::-1]
    return reads, lens


def make_inputs(cfg, seed, traffic=None):
    """{"genome": codes, "reads": [n, L] codes, "read_lens": [n]} for
    configuration ``cfg``, ``seed`` and the traffic's ``read_lengths``
    (every read ``read_len`` long where it has none)."""
    rng = np.random.default_rng(seed)
    g = genome(rng, cfg["genome_len"])
    spread = (traffic or {}).get("read_lengths")
    if spread is None:
        reads = sampled_reads(rng, g, cfg["n_reads"], cfg["read_len"],
                              cfg["sub_rate"], cfg["rc_every"])
        lens = np.full(len(reads), cfg["read_len"], np.int64)
    else:
        reads, lens = spread_reads(
            rng, g, read_lengths(cfg["n_reads"], cfg["read_len"], spread),
            cfg["sub_rate"], cfg["rc_every"], spread["inverted"])
    return {"genome": g, "reads": reads, "read_lens": lens}


def bases(inputs, name):
    """The bases of input ``name`` (the unit of a cell's rate)."""
    if name == "reads":
        return int(inputs["read_lens"].sum())
    return int(np.prod(inputs[name].shape))


def write_fasta(path, names, seqs):
    """One record a sequence, its bases on one line."""
    with open(path, "wb") as f:
        for name, codes in zip(names, seqs):
            f.write(b">" + name.encode() + b"\n")
            f.write(ACGT[codes].tobytes())
            f.write(b"\n")


# the kinds of input a traffic file may name, and their files' suffixes
KINDS = {"genome": ".fa", "reads": ".fa", "modset": ".mod"}


def input_paths(needed, directory):
    """{input: the path of its file in ``directory``}."""
    unknown = set(needed) - set(KINDS)
    if unknown:
        raise ValueError("no input of the kind %s (kinds: %s)"
                         % (", ".join(sorted(unknown)), ", ".join(KINDS)))
    return {name: "%s/%s%s" % (directory, name, KINDS[name])
            for name in needed}


def write_modset(path, reads, lens, cfg):
    """The modset of ``reads`` as modutils -a ... -s ... -w writes it: the
    plain reference's table, on the CUDA card where there is one.  Its
    blocks of rows would set the card's peak of memory, which is the
    program's to set: the peak is reset once they are freed."""
    import torch
    from reference.build_ref import build
    from reference.modset_file import write_modset as write
    device = "cuda" if torch.cuda.is_available() else "cpu"
    t = build(reads, cfg, device, lens=lens)
    write(path, t["kmers"], t["depth"], t["info"], cfg["k"], cfg["w"],
          cfg["hash_seed"], cfg["table_bits"])
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def write_inputs(inputs, cfg, needed, directory):
    """Write the files a job reads: "genome" (a FASTA of one record named
    cfg["genome_name"]), "reads" (a FASTA of r0, r1, ...) and "modset"
    (the reads' modset).  {input: path}."""
    paths = input_paths(needed, directory)
    for name, path in paths.items():
        if name == "genome":
            write_fasta(path, [cfg["genome_name"]], [inputs["genome"]])
        elif name == "reads":
            reads, lens = inputs["reads"], inputs["read_lens"]
            write_fasta(path, ("r%d" % i for i in range(len(reads))),
                        (r[:n] for r, n in zip(reads, lens)))
        else:
            write_modset(path, inputs["reads"], inputs["read_lens"], cfg)
    return paths
