"""What ``modasm -m X.mod -f reads.fa`` and its commands ``-b``, ``-c``,
``-u`` and ``-S`` must produce, worked out again from the reads and the
configuration (the reference C tool's modasm.c, lines 151-510 and
1266-1394, with the quirks its native port keeps):

- the readset (modasm.c:151-191): every read's modimizers in position
  order, each looked up in the table: a hit is the entry's id, with
  ``TOPBIT`` where the k-mer is read forward, and its U16 gap ``dx`` to the
  read's previous hit (the first one's: its position); ``nHit``,
  ``nMiss``, the depths counted again from the hits (saturating at
  0xFFFF), ``nCopy`` (hits of each copy number);
- findOverlaps, phase 1 (modasm.c:291-352): for read x, the first
  occurrence of each copy-1 mod (a second one sets ``BAD_REPEAT``), and
  every read y holding it, once for each of its occurrences there:
  candidate (x, y) counts them in a U16 that wraps; the candidates are
  ordered by descending count over the order of first encounter (a
  stable sort), slot 0 burned at the end;
- phase 2 (modasm.c:353-418): candidates from the first, stopping at the
  first with a count under 3, skipping those whose read is bad: an
  orientation vote over y's hits of x's copy-1 mods, order violations,
  containment; ``nGood``, ``nBad``, and ``BAD_NOMATCH``, ``BAD_LOWHIT``,
  ``BAD_LOWCOPY1`` for a read with neither;
- the commands: ``-b`` markBadReads (the flags reset, then the order
  flags from the lists of bad overlaps), ``-c`` markContained, ``-u``
  cluster (with its ``link[iLink - 1]`` write and its ``clusSize``
  clobber), ``-S`` the modset's summary and the readset's statistics.

Phase 2's numbers for a pair depend on the two reads alone: they are
computed for every pair at once, in blocks of reads, with plain PyTorch
operations on the given device.  Only the walk that depends on the flags
(which candidates a bad read removes, which reads ``-c`` and ``-u`` skip)
runs read by read.  Nothing here imports the port or JAX.
"""

import numpy as np
import torch

from .build_ref import summary_lines, table

TOPBIT = 1 << 31
U16 = 0xFFFF
BAD_REPEAT, BAD_ORDER10, BAD_ORDER1 = 1, 2, 4
BAD_NOMATCH, BAD_LOWHIT, BAD_LOWCOPY1 = 8, 16, 32
# joined rows (x's first copy-1 hits against every hit of their mods) a
# block of reads takes on the device
BLOCK_ROWS = 1 << 24


class LinkCycle(RuntimeError):
    """cluster's walk along ``link`` found a cycle and would never end."""


def forward_kmers(reads, read, pos, k):
    """The forward k-mer at each (read, position)."""
    x = np.zeros(len(read), np.uint64)
    for j in range(k):
        x = (x << np.uint64(2)) | reads[read, pos + j].astype(np.uint64)
    return x


def readset(reads, cfg, device, kmer_bits=64, lens=None):
    """The table and the readset of ``reads`` ([n, L] uint8 codes, each
    ``lens[i]`` long, all L where None): the table's k-mers (in id order),
    its depths and flags as read from the modset, and per hit row (read
    order, position order) the read, the id, the strand, the hit word and
    dx; per read (1..n) nHit, nMiss, nCopy and the length; the depths
    counted again.  ``kmer_bits`` 32 keys the table by the low 32 bits of
    the k-mers (the control)."""
    t = table(reads, cfg, device, kmer_bits, lens)
    strand = (t["km"] == forward_kmers(reads, t["read"], t["pos"],
                                       cfg["k"])).astype(np.int64)
    ids, info = t["ids"], t["info"]
    n = len(reads)
    read = t["read"].astype(np.int64) + 1             # read 0 is burned
    pos = t["pos"].astype(np.int64)
    n_hit = np.bincount(read, minlength=n + 1).astype(np.int64)
    start = np.zeros(n + 2, np.int64)
    np.cumsum(n_hit, out=start[1:])
    first = np.arange(len(read)) == start[read]
    prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
    dx = ((pos - prev) & U16).astype(np.uint16)
    # the position each hit's gaps add up to (s_xPos, yPos)
    csum = np.cumsum(dx.astype(np.int64))
    cum = csum - np.concatenate([[0], csum])[start[read]]
    depth2 = np.minimum(np.bincount(ids, minlength=len(t["kmers"]) + 1),
                        U16).astype(np.uint16)
    copy = (info[ids - 1] & 3).astype(np.int64)
    n_copy = np.bincount(read * 4 + copy, minlength=4 * (n + 1)).reshape(
        n + 1, 4)
    lens = np.full(n, reads.shape[1]) if lens is None else lens
    return {"kmers": t["kmers"], "depth_file": t["depth"], "info": info,
            "depth": depth2, "read": read, "id": ids, "strand": strand,
            "hit": ids.astype(np.int64) | (strand * TOPBIT), "dx": dx,
            "cum": cum, "j": np.arange(len(read)) - start[read],
            "n_hit": n_hit, "n_miss": np.zeros(n + 1, np.int64),
            "n_copy": n_copy,
            "len": np.concatenate([[0], lens]).astype(np.int64)}


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def pair_stats(rs, device, block_rows=BLOCK_ROWS):
    """Phase 1 and the two-read part of phase 2 for every candidate pair.
    Returns per read whether a copy-1 mod repeats in it, and per
    candidate pair (x, y), x ascending, in each x's candidate order: y,
    the U16 count, whether the pair is a bad overlap (order violations or
    strand flips) and whether x is contained in y."""
    m, read, j = rs["id"], rs["read"], rs["j"]
    n1 = len(rs["n_hit"])
    info = np.concatenate([[0], rs["info"]]).astype(np.int64)
    depth = rs["depth"]                        # counted again, by id
    c1 = (info[m] & 3) == 1
    order = np.lexsort((j, m, read))
    same = np.zeros(len(m), bool)
    same[1:] = (read[order][1:] == read[order][:-1]) & (m[order][1:]
                                                         == m[order][:-1])
    first = np.empty(len(m), bool)
    first[order] = ~same
    repeat = np.bincount(read[c1 & ~first], minlength=n1) > 0
    # phase 1 walks the reads of a mod whose depth has not saturated
    counted = depth[m] != U16
    gorder = np.argsort(m, kind="stable")       # by mod, then (read, j)
    gcount = np.bincount(m, minlength=int(m.max(initial=0)) + 1)
    gstart = np.concatenate([[0], np.cumsum(gcount)[:-1]])
    xrows = np.nonzero(c1 & first)[0]           # in (read, j) order
    jmax = int(j.max(initial=0)) + 1
    if n1 * n1 * jmax >= 1 << 62:
        raise ValueError("too many reads or hits for the pair keys")

    dev = torch.device(device)
    T = {name: _t(a, dev) for name, a in (
        ("read", read), ("j", j), ("strand", rs["strand"]),
        ("cum", rs["cum"]), ("counted", counted), ("gorder", gorder),
        ("m", m))}
    gcount_t, gstart_t = _t(gcount, dev), _t(gstart, dev)
    per_x = gcount[m[xrows]]
    ends = np.cumsum(per_x)
    out = []
    a0 = 0
    while a0 < len(xrows):
        # a block of whole reads: x's rows of one read stay together
        a1 = int(np.searchsorted(ends, (ends[a0 - 1] if a0 else 0)
                                 + block_rows, "right"))
        a1 = max(a1, a0 + 1)
        if a1 < len(xrows):
            a1 = int(np.searchsorted(read[xrows], read[xrows[a1 - 1]],
                                     "right"))
        out.append(_pair_block(T, gcount_t, gstart_t,
                               _t(xrows[a0:a1], dev), n1, jmax))
        a0 = a1
    cols = {key: np.concatenate([o[key] for o in out]) if out
            else np.zeros(0, np.int64) for key in
            ("x", "y", "cnt", "first", "plus", "minus", "lt", "gt",
             "dfirst", "dlast")}
    cand = cols["cnt"] > 0
    c = {key: v[cand] for key, v in cols.items()}
    is_plus = c["plus"] > c["minus"]
    is_minus = (c["minus"] > 0) & (c["plus"] == 0)
    bad_order = np.where(is_plus, c["lt"], np.where(is_minus, c["gt"], 0))
    bad_flip = np.where(is_plus, c["minus"], 0)
    length = rs["len"]
    contained = (is_plus & (c["dfirst"] < 0)
                 & ~(length[c["x"]] - c["dlast"] > length[c["y"]]))
    wcnt = c["cnt"] & U16
    o = np.lexsort((c["y"], c["first"], -wcnt, c["x"]))
    return repeat, {"x": c["x"][o], "y": c["y"][o], "cnt": wcnt[o],
                    "bad": (((bad_order & U16) != 0)
                            | ((bad_flip & U16) != 0))[o],
                    "contained": contained[o]}


def _pair_block(T, gcount, gstart, xrows, n1, jmax):
    """The pairs of one block of x rows: every x row against every row of
    its mod, grouped by (x, y) and ordered by y's hit index."""
    dev = xrows.device
    mx = T["m"][xrows]
    per = gcount[mx]
    a = torch.repeat_interleave(torch.arange(len(xrows), device=dev), per)
    kb = torch.arange(len(a), device=dev) - (torch.cumsum(per, 0)
                                             - per)[a]
    b = T["gorder"][gstart[mx][a] + kb]
    fa = xrows[a]
    del a, kb, mx, per
    x, y = T["read"][fa], T["read"][b]
    key = (x * n1 + y) * jmax + T["j"][b]
    key, perm = torch.sort(key)
    fa, b = fa[perm], b[perm]
    del perm, x, y
    pair = key // jmax
    del key
    uniq, inv, rows = torch.unique_consecutive(pair, return_inverse=True,
                                               return_counts=True)
    n = len(uniq)

    def seg_sum(v):
        return torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, inv, v.to(torch.int64))

    counted = T["counted"][fa]
    jx = T["j"][fa]
    cnt = seg_sum(counted)
    big = torch.iinfo(torch.int64).max
    first = torch.full((n,), big, dtype=torch.int64,
                       device=dev).scatter_reduce_(
        0, inv, torch.where(counted, jx, torch.full_like(jx, big)), "amin")
    plus = seg_sum(T["strand"][fa] == T["strand"][b])
    prev = torch.zeros_like(counted)
    prev[1:] = inv[1:] == inv[:-1]
    step_lt = torch.zeros_like(counted)
    step_gt = torch.zeros_like(counted)
    step_lt[1:] = prev[1:] & (jx[1:] < jx[:-1])
    step_gt[1:] = prev[1:] & (jx[1:] > jx[:-1])
    diff = T["cum"][fa] - T["cum"][b]
    last = torch.cumsum(rows, 0) - 1
    got = {"x": uniq // n1, "y": uniq % n1, "cnt": cnt, "first": first,
           "plus": plus, "minus": rows - plus, "lt": seg_sum(step_lt),
           "gt": seg_sum(step_gt), "dfirst": diff[last - rows + 1],
           "dlast": diff[last]}
    return {key: v.cpu().numpy() for key, v in got.items()}


def candidates(pairs, n1):
    """Per read, the candidates phase 2 looks at (a count of 3 or more),
    in order: lists of (y, bad overlap, x contained in y, count)."""
    keep = pairs["cnt"] >= 3
    x = pairs["x"][keep]
    cols = [pairs[key][keep].tolist() for key in
            ("y", "bad", "contained", "cnt")]
    bounds = np.searchsorted(x, np.arange(n1 + 1)).tolist()
    return [list(zip(*(c[bounds[i]:bounds[i + 1]] for c in cols)))
            for i in range(n1)]


class Walk:
    """The commands over the readset's flags, read by read, in order."""

    def __init__(self, rs, repeat, cands):
        self.n1 = len(rs["n_hit"])
        self.n_hit = rs["n_hit"].tolist()
        self.copy1 = rs["n_copy"][:, 1].tolist()
        self.len = rs["len"].tolist()
        self.repeat = repeat.tolist()
        self.cands = cands
        self.bad = [0] * self.n1
        self.contained = [0] * self.n1

    def overlaps(self, x):
        """findOverlaps for x: sets x's flags, and returns the candidates
        phase 2 examines (those whose read is not bad)."""
        bad = self.bad
        if self.repeat[x]:
            bad[x] |= BAD_REPEAT
        seen = [c for c in self.cands[x] if not bad[c[0]]]
        if not seen:
            bad[x] |= BAD_NOMATCH
            if self.n_hit[x] < 10:
                bad[x] |= BAD_LOWHIT
            elif self.copy1[x] < 10:
                bad[x] |= BAD_LOWCOPY1
        return seen

    def mark_bad(self):
        """-b: markBadReads."""
        bad, n1 = self.bad, self.n1
        for x in range(1, n1):
            bad[x] = 0
        n_bad = [0] * n1
        lists = [[] for _ in range(n1)]
        for x in range(1, n1):
            for y, b, _c, _n in self.overlaps(x):
                if b:
                    n_bad[y] += 1
                    if n_bad[y] < 10 and len(lists[x]) < 10:
                        lists[x].append(y)
        out = []
        for x in range(1, n1):
            if n_bad[x] >= 10:
                bad[x] |= BAD_ORDER10
                lists[x] = []
        out.append("MB  %d with >=10 bad overlaps"
                   % sum(v >= 10 for v in n_bad[1:]))
        for what, least in (("multiple", 2), ("single", 1)):
            lists = [[y for y in v if not bad[y]] for v in lists]
            hit = [x for x in range(1, n1) if len(lists[x]) >= least]
            for x in hit:
                bad[x] |= BAD_ORDER1
                lists[x] = []
            out.append("MB  %d with %s bad overlaps" % (len(hit), what))
        return out

    def mark_contained(self):
        """-c: markContained."""
        n_in = n_out = tot = 0
        for x in range(1, self.n1):
            if self.bad[x]:
                continue
            most = 0
            for y, _b, c, n in self.overlaps(x):
                if y != x and c and n > most:
                    self.contained[x], most = y, n
            if self.contained[x]:
                n_in += 1
            else:
                n_out += 1
                tot += self.len[x]
        return ["MC  found %d contained reads, leaving %d not contained, av "
                "length %.1f" % (n_in, n_out, tot / n_out if n_out else 0.)]

    def cluster(self):
        """-u: single linkage over the examined candidates, bad or not."""
        n1 = self.n1
        link = [0] * n1
        made = non_empty = 0
        for i in range(1, n1):
            if link[i]:
                continue
            self.overlaps(i)
            for y, _b, _c, _n in self.cands[i]:
                if y == i:
                    continue
                z, steps = y, 0
                while link[z]:
                    if link[z] == i:
                        break
                    z = link[z]
                    steps += 1
                    if steps > n1:
                        raise LinkCycle("read %d: link cycle through %d"
                                        % (i, z))
                if not link[z]:
                    if z + 1 > i:
                        link[z] = i
                    else:
                        link[i - 1] = z         # modasm.c:480, as it is
            made += 1
            non_empty += bool(self.cands[i])
        out = ["made %d overlap arrays, of which %d nonEmpty"
               % (made, non_empty)]
        n_clus = 0
        clus = [0] * n1
        for i in range(1, n1):
            if link[i]:
                clus[i] = clus[link[i]]
            else:
                n_clus += 1
                clus[i] = n_clus
        size = [0] * (n_clus + 1)
        for i in range(1, n1):
            size[clus[i]] += 1
        proper = 0
        for i in range(n_clus):
            if size[i] > 1:
                proper += 1
                out.append("proper cluster %d size %d" % (proper, size[i]))
                size[proper] = size[i]          # the clobber, as it is
        out.append("found %d clusters of which %d are proper"
                   % (n_clus, proper))
        return out


def _div(num, den, prec):
    """printf("%.*f", num / (double) den) on x86: x/0 is inf, 0/0 -nan."""
    if den:
        return "%.*f" % (prec, num / den)
    if num:
        return "inf" if num > 0 else "-inf"
    return "-nan"


def stats_lines(rs, bad):
    """-S's readset lines (modasm.c:193-256)."""
    n = len(rs["n_hit"]) - 1
    lens = rs["len"][1:]
    tot_len = int(lens.sum())
    tot_hit = int(rs["n_hit"].sum())
    tot_miss = int(rs["n_miss"].sum())
    tot_copy = rs["n_copy"][1:].sum(0)
    c1 = rs["n_copy"][1:, 1]
    n_u0, n_u1 = int((c1 == 0).sum()), int((c1 == 1).sum())
    len_u0, len_u1 = int(lens[c1 == 0].sum()), int(lens[c1 == 1].sum())
    n_multi = n - n_u0 - n_u1
    bad = np.asarray(bad[1:])
    bits = [int(((bad >> b) & 1).sum()) for b in range(6)]
    out = ["RS %d sequences, total length %d (av %s)"
           % (n, tot_len, _div(tot_len, n, 1)),
           "RS %d mod hits, %s bp/hit, frac hit %s, av hits/read %s"
           % (tot_hit, _div(tot_len, tot_hit, 1),
              _div(tot_hit, tot_miss + tot_hit, 2), _div(tot_hit, n, 1)),
           "RS hit distribution %s copy0, %s copy1, %s copy2, %s copyM"
           % tuple(_div(int(v), tot_hit, 2) for v in tot_copy),
           "RS num reads and av_len with 0 copy1 hits %d %s with 1 copy1 "
           "hits %d %s >1 copy1 hits %d %s av copy1 hits %s"
           % (n_u0, _div(len_u0, n_u0, 1), n_u1, _div(len_u1, n_u1, 1),
              n_multi, _div(tot_len - len_u0 - len_u1, n_multi, 1),
              _div(int(tot_copy[1]) - n_u1, n_multi, 1)),
           "RS bad %d : %d repeat, %d order10, %d order1, %d no_match, %d "
           "low_hit, %d low_copy1" % (int((bad != 0).sum()), *bits)]
    cn = rs["info"].astype(np.int64) & 3
    d = rs["depth"][1:].astype(np.int64)
    n_copy = np.bincount(cn, minlength=4)
    hit = np.bincount(cn[d > 0], minlength=4)
    hit2 = np.bincount(cn[d > 1], minlength=4)
    dep2 = np.bincount(cn[d > 1], weights=d[d > 1], minlength=4)
    out.append("RS mod frac hit hit>1 av: copy0 %s copy1 %s copy2 %s copyM "
               "%s" % tuple("%s %s %s" % (
                   _div(int(hit[c]), int(n_copy[c]), 3),
                   _div(int(hit2[c]), int(n_copy[c]), 3),
                   _div(int(dep2[c]), int(hit2[c]), 1)) for c in range(4)))
    return out


def modasm(reads, cfg, device, commands, kmer_bits=64, lens=None):
    """One job ``modasm -m X.mod -f reads.fa <commands>`` on ``reads``
    (each ``lens[i]`` long) with X.mod their modset: its lines (timing
    lines left out), the readset as the job leaves it, phase 1's
    candidates (read, candidate read and U16 count, in each read's order)
    and the job's sizes (hit rows, candidate pairs, findOverlaps
    passes)."""
    k, w, seed, bits = cfg["k"], cfg["w"], cfg["hash_seed"], cfg["table_bits"]
    rs = readset(reads, cfg, device, kmer_bits, lens)
    lines = summary_lines(k, w, seed, bits, rs["depth_file"], rs["info"])
    repeat, pairs = pair_stats(rs, device)
    walk = Walk(rs, repeat, candidates(pairs, len(rs["n_hit"])))
    passes = 0
    for c in commands:
        if c == "-b":
            lines += walk.mark_bad()
        elif c == "-c":
            lines += walk.mark_contained()
        elif c == "-u":
            lines += walk.cluster()
        elif c == "-S":
            lines += summary_lines(k, w, seed, bits, rs["depth"][1:],
                                   rs["info"])
            lines += stats_lines(rs, walk.bad)
        else:
            raise ValueError("no reference for the command %s" % c)
        passes += c in ("-b", "-c", "-u")
    return {"lines": lines, "kmers": rs["kmers"], "depth": rs["depth"][1:],
            "info": rs["info"], "hit_read": rs["read"], "hits": rs["hit"],
            "dx": rs["dx"], "len": rs["len"][1:], "n_hit": rs["n_hit"][1:],
            "n_miss": rs["n_miss"][1:], "n_copy": rs["n_copy"][1:],
            "bad": np.array(walk.bad[1:], np.int64),
            "contained": np.array(walk.contained[1:], np.int64),
            "pair_x": pairs["x"], "pair_y": pairs["y"],
            "pair_cnt": pairs["cnt"],
            "hit_rows": len(rs["id"]), "pairs": len(pairs["x"]),
            "passes": passes}
