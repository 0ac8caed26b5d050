"""An assembly job (``modasm -m X.mod -f reads.fa`` and its commands):
the modset and the readset as the job leaves them, phase 1's candidates
as each findOverlaps pass gets them from the card, and the lines it
prints."""

import numpy as np

from checks import lines_wrong, rows_wrong, text_lines
from reference import asm_ref

SPY = ("modimizer_tpu_torch.cli.modasm", "_find_overlaps", 0)
# phase 1 on the device: per read, its candidates (read, U16 count) in
# the order phase 2 walks them; a job's host walk returns none
RETURNS = ("modimizer_tpu_torch.core.readset",
           "Readset.device_overlap_candidates")
LIMITS = {"table_rows_wrong": 0, "hits_wrong": 0, "reads_wrong": 0,
          "pairs_wrong": 0, "lines_wrong": 0}
TABLE = ("kmers", "depth", "info")
HITS = ("hit_read", "hits", "dx")
READS = ("len", "n_hit", "n_miss", "n_copy0", "n_copy1", "n_copy2",
         "n_copy3", "bad", "contained")
PAIRS = ("pair_x", "pair_y", "pair_cnt")


def _reads(d):
    return dict(d, **{"n_copy%d" % c: d["n_copy"][:, c] for c in range(4)})


def port_output(rs, returned):
    """The job's Readset: its modset (k-mers in id order, the depths it
    counted again, flags), its hit rows and its reads (1..n: length,
    counts, flags); and each pass's phase-1 candidates as rows (read,
    candidate read, count)."""
    n = int(rs.ms.max)
    off = np.asarray(rs.hit_off, np.int64)
    passes = []
    for cy, ch, co in returned:
        co = np.asarray(co, np.int64)
        passes.append({"pair_x": np.repeat(np.arange(len(co) - 1),
                                           np.diff(co)),
                       "pair_y": np.array(cy), "pair_cnt": np.array(ch)})
    return _reads({
        "kmers": np.array(rs.ms.value[1:n + 1]),
        "depth": np.array(rs.ms.depth[1:n + 1]),
        "info": np.array(rs.ms.info[1:n + 1]),
        "hit_read": np.repeat(np.arange(len(off) - 1), np.diff(off)),
        "hits": np.array(rs.hits), "dx": np.array(rs.dx),
        "len": np.array(rs.len[1:]),
        "n_hit": np.array(rs.n_hit[1:]), "n_miss": np.array(rs.n_miss[1:]),
        "n_copy": np.array(rs.n_copy[1:]), "bad": np.array(rs.bad[1:]),
        "contained": np.array(rs.contained[1:]), "passes": passes})


def commands(argv):
    """The job's commands: its argv without the inputs (-m X, -f Y)."""
    out, i = [], 0
    while i < len(argv):
        if argv[i] in ("-m", "-f"):
            i += 2
        else:
            out.append(argv[i])
            i += 1
    return tuple(out)


def expected(inputs, cfg, device, argv, kmer_bits=64):
    return _reads(asm_ref.modasm(inputs["reads"], cfg, device,
                                 commands(argv), kmer_bits,
                                 inputs["read_lens"]))


def as_port(want):
    out = {key: want[key] for key in TABLE + HITS + READS}
    out["passes"] = [{c: want[c] for c in PAIRS}] * want["passes"]
    return out


def numbers(port, texts, want):
    def wrong(got, cols):
        return rows_wrong([got[c] for c in cols], [want[c] for c in cols])

    return {"table_rows_wrong": wrong(port, TABLE),
            "hits_wrong": wrong(port, HITS),
            "reads_wrong": wrong(port, READS),
            "pairs_wrong": sum(wrong(p, PAIRS) for p in port["passes"]),
            "lines_wrong": sum(lines_wrong(text_lines(t), want["lines"])
                               for t in texts)}


def sizes(want):
    """Per job: the hit rows phase 1 reads, the distinct candidate pairs
    it writes, and the findOverlaps passes (one a command among -b, -c
    and -u)."""
    return {key: want[key] for key in ("hit_rows", "pairs", "passes")}
