"""A build job (``modutils -a``): its table and the lines it prints."""

import numpy as np

from checks import lines_wrong, rows_wrong, text_lines
from reference import build_ref

SPY = ("modimizer_tpu_torch.cli.modutils", "add_sequence_file", 0)
LIMITS = {"table_rows_wrong": 0, "lines_wrong": 0}


def port_output(ms):
    """The table of the job's modset: k-mers in id order, depths, flags."""
    n = int(ms.max)
    return {"kmers": np.array(ms.value[1:n + 1]),
            "depth": np.array(ms.depth[1:n + 1]),
            "info": np.array(ms.info[1:n + 1])}


def expected(inputs, cfg, device, _argv, kmer_bits=64):
    return build_ref.build(inputs["reads"], cfg, device, kmer_bits,
                           inputs["read_lens"])


def as_port(want):
    return {key: want[key] for key in ("kmers", "depth", "info")}


def numbers(port, texts, want):
    cols = ("kmers", "depth", "info")
    return {"table_rows_wrong": rows_wrong([port[c] for c in cols],
                                           [want[c] for c in cols]),
            "lines_wrong": sum(lines_wrong(text_lines(t), want["lines"])
                               for t in texts)}


def sizes(want):
    """Per job: the read bases scanned and the rows the scan emits."""
    return {"scan_bases": want["bases"], "scan_rows": want["rows"],
            "table_rows": len(want["kmers"])}
