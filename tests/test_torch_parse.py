"""The port's FASTA parse against the JAX package on the same bytes: the
native pass (``io_fasta_parse``) at forced thread counts against
``modimizer_tpu.io.seqio._parse_fasta_np``, and ``read_seq_file`` (a
mapped file, gzip and stdin; whole files at forced thread counts, and
every shape of a dropped final record) against
``modimizer_tpu.io.seqio.read_seq_file``, stderr included."""

import contextlib
import gzip
import io
import sys

import numpy as np
import pytest

from modimizer_tpu.io import seqio as jax_seqio
from modimizer_tpu_torch.io import seqio
from modimizer_tpu_torch.native import lib

THREADS = [1, 2, 3, 8]
# the port's table and the JAX package's, by name; noConv * 2 has codes
# past a signed byte, which wrap as the int8 output's cast wraps them
CONVS = [lambda m: m.dna2textAmbigConv, lambda m: m.dna2index_n0(),
         lambda m: m.noConv * 2]


def _records(heads, seqs, nl=b"\n"):
    return b"".join(b">" + h + nl + s + nl for h, s in zip(heads, seqs))


def _on_edges(threads, delta, block=61):
    """Records whose '>' lies ``delta`` bytes from every edge of the pass's
    blocks (8 a thread; their edges hold the thread ranges' edges), in a
    file of 8 * threads blocks: headers, dropped bytes and kept bases
    straddle the edges too."""
    n = 8 * threads * block
    rng = np.random.default_rng(threads * 10 + delta)
    starts = [0] + [j * block + delta for j in range(1, 8 * threads)]
    out = bytearray()
    for i, s in enumerate(starts):
        end = starts[i + 1] if i + 1 < len(starts) else n
        head = b">r%d x" % i
        body = rng.choice(list(b"ACGTacgtN\n\r-"), end - s - len(head) - 2)
        out += head + b"\n" + bytes(body.astype(np.uint8)) + b"\n"
    assert len(out) == n
    return bytes(out)


def _random(threads):
    rng = np.random.default_rng(21)
    heads = [bytes(rng.choice(list(b"ab \t>x1"), rng.integers(0, 12))
                   .astype(np.uint8)) for _ in range(60)]
    seqs = [bytes(rng.choice(list(b"ACGTacgtNRY\n\r>-"), rng.integers(0, 400))
                  .astype(np.uint8)) for _ in range(60)]
    return _records(heads, seqs)


def _one_mbp(threads):
    rng = np.random.default_rng(1)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 1 << 20)]
    lines = b"\n".join(seq[i:i + 60].tobytes()
                       for i in range(0, len(seq), 60))
    return b">chr1 one long record\n" + lines + b"\n"


CASES = {
    "empty": lambda t: b"",
    "empty_record": lambda t: b">a\n\n>b\nACGT\n>c\n>d\nGG\n",
    "header_only_final": lambda t: b">a\nACGT\n>b desc\n",
    "no_trailing_newline": lambda t: b">a\nACGT\n>b\nGGTA",
    "header_at_eof": lambda t: b">a\nACGT\n>b desc ag",
    "gt_mid_line": lambda t: b">a>b\nAC>GT\n>c x\nA>\n>\n",
    "crlf": lambda t: _records([b"a desc", b"b", b"c\tz"],
                               [b"ACGT\r\nAC", b"", b"GG\r\nNN"], b"\r\n"),
    "lowercase_ambiguity": lambda t: _records(
        [b"a", b"b"], [b"acgtnRYKMSWBDHVrykmswbdhv-", b"NNnnAaCcGgTt.*"]),
    "one_mbp": _one_mbp,
    "ids_tabs_spaces": lambda t: _records(
        [b"id1\tdesc one", b" lead", b"id2  two  spaces", b"id3\x0bvt\tx",
         b"id4\x0cff", b"id5\rcr", b"", b"\t"], [b"AC"] * 8),
    "many_records": lambda t: _records(
        [b"r%d d" % i for i in range(10_000)],
        [b"ACGT"[:i % 5] * (i % 7) for i in range(10_000)]),
    "random": _random,
    "edges_before": lambda t: _on_edges(t, -1),
    "edges_on": lambda t: _on_edges(t, 0),
    "edges_after": lambda t: _on_edges(t, 1),
}


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_pass_matches_numpy(case, threads):
    data = CASES[case](threads)
    for conv in CONVS:
        got = seqio._parse_fasta(data, conv(seqio), True, threads=threads)
        want = jax_seqio._parse_fasta_np(data, conv(jax_seqio), True)
        assert got.codes.dtype == np.int8
        assert np.array_equal(got.codes, want.codes)
        assert np.array_equal(got.offsets, want.offsets)
        assert got.ids == want.ids and got.descs == want.descs
    bare = seqio._parse_fasta(data, conv(seqio), False, threads=threads)
    assert bare.ids == [] and bare.descs == []
    assert np.array_equal(bare.codes, want.codes)


def _read_both(name, monkeypatch, stdin=None):
    """read_seq_file of the port and of the JAX package on one file (``-``
    reads ``stdin``): each one's (batch, file type, stderr)."""
    out = []
    for m in (seqio, jax_seqio):
        if stdin is not None:
            monkeypatch.setattr(sys, "stdin", type("In", (), {
                "buffer": io.BytesIO(stdin)}))
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            batch, ftype = m.read_seq_file(str(name), m.dna2index_n0())
        out.append((batch, ftype, err.getvalue()))
    return out


def _same(got, want):
    (g, gt, ge), (w, wt, we) = got, want
    assert gt == wt == seqio.FASTA and ge == we
    assert np.array_equal(g.codes, w.codes)
    assert np.array_equal(g.offsets, w.offsets)
    assert g.ids == w.ids and g.descs == w.descs


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", sorted(set(CASES) - {"empty"}))
def test_read_seq_file_matches_the_jax_package(tmp_path, monkeypatch, case,
                                               threads):
    """A whole mapped file, its tail dropped or kept, at a forced thread
    count."""
    name = tmp_path / "t.fa"
    name.write_bytes(CASES[case](threads))
    monkeypatch.setattr(seqio, "parse_threads", lambda n: threads)
    got, want = _read_both(name, monkeypatch)
    _same(got, want)


def test_threads_come_from_the_size():
    most = lib().io_max_threads()
    step = seqio.PARSE_BYTES_A_THREAD
    assert most >= 1
    assert seqio.parse_threads(0) == 1
    assert seqio.parse_threads(2 * step - 1) == 1
    assert seqio.parse_threads(3 * step) == min(3, most)
    assert seqio.parse_threads(1 << 40) == most


# the shapes of a final record, dropped or kept: EOF mid-sequence, at a
# header's end or inside it, a lone '>', '\r\n' ends, a '>' mid-line
TAILS = {
    "mid_sequence": b">a x\nACGT\n>b\nAC",
    "mid_multiline": b">a\nAC\nGT\n>b y\nAA\nCC",
    "header_only": b">a\nACGT\n>b desc\n",
    "header_no_newline": b">a\nACGT\n>b desc",
    "lone_gt": b">a\nAC\n>",
    "one_header": b">a\n",
    "one_record_no_newline": b">a\nACG",
    "crlf": b">a\r\nAC\r\n>b\r\nA",
    "gt_mid_line_tail": b">a\nAC>G\nT>",
    "complete": b">a\nAC\n\n>b\nGT\n",
    "complete_empty_last": b">a\nAC\n>b\n\n",
}


@pytest.mark.parametrize("path", ["mapped", "gzip", "stdin"])
@pytest.mark.parametrize("shape", sorted(TAILS))
def test_incomplete_tail_as_before(tmp_path, monkeypatch, shape, path):
    data = TAILS[shape]
    name = tmp_path / "t.fa"
    if path == "gzip":
        name = tmp_path / "t.fa.gz"
        name.write_bytes(gzip.compress(data))
    else:
        name.write_bytes(data)
    # a thread a byte, so that even these files split
    monkeypatch.setattr(seqio, "PARSE_BYTES_A_THREAD", 1)
    got, want = _read_both("-" if path == "stdin" else name, monkeypatch,
                           data if path == "stdin" else None)
    _same(got, want)
    # the streaming path's drop, the same rule
    assert (seqio.incomplete_tail_fixup(data, seqio.FASTA)
            == jax_seqio.incomplete_tail_fixup(data, jax_seqio.FASTA))
