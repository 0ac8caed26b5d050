"""A mapping job (``modmap -f ref -q reads``): the reference's table,
every query modimizer's lookup answer and the lines it prints."""

import numpy as np

from checks import lines_wrong, rows_wrong, text_lines
from reference import map_ref

SPY = ("modimizer_tpu_torch.cli.modmap", "emit", None)
LIMITS = {"table_rows_wrong": 0, "lookups_wrong": 0, "lines_wrong": 0}


def port_output(args):
    """emit(ref, batch, rid, rpos, sidx, ...)'s table and seeds."""
    ref, _batch, rid, rpos, sidx = args[:5]
    n = int(ref.ms.max)
    return {"kmers": np.array(ref.ms.value[1:n + 1]),
            "info": np.array(ref.ms.info[1:n + 1]),
            "read": np.array(rid), "pos": np.array(rpos),
            "sidx": np.array(sidx)}


def expected(inputs, cfg, device, _argv, kmer_bits=64):
    return map_ref.modmap(inputs["genome"], inputs["reads"], cfg, device,
                          kmer_bits)


def as_port(want):
    return {key: want[key] for key in ("kmers", "info", "read", "pos",
                                       "sidx")}


def numbers(port, texts, want):
    seeds = ("read", "pos", "sidx")
    return {"table_rows_wrong": rows_wrong([port["kmers"], port["info"]],
                                           [want["kmers"], want["info"]]),
            "lookups_wrong": rows_wrong([port[c] for c in seeds],
                                        [want[c] for c in seeds]),
            "lines_wrong": sum(lines_wrong(text_lines(t), want["lines"])
                               for t in texts)}


def sizes(want):
    """Per job: the bases scanned (reference and queries) and the rows
    the scans emit; the table's keys, the queries and their hits."""
    return {"scan_bases": want["ref_bases"] + want["bases"],
            "scan_rows": want["ref_rows"] + want["query_rows"],
            "keys": want["keys"], "queries": want["query_rows"],
            "hits": want["hits"]}
