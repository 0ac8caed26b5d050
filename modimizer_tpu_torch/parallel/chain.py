"""Batched modmap -q colinear chaining on the device (port of
``modimizer_tpu/parallel/chain.py``).

The reference chains each read's seed list with a small sequential
automaton (queryProcess, modmap.c:216-280): greedy blocks over copy-1 and
copy-2 seeds, broken on a reference-id change, a direction flip or a
diagonal drift over 50, with a second-occurrence retry for copy-2 seeds,
an M record for each closed block with n1 > 2, and a final-block record
gated on n2 > 2 (the reference's quirk, modmap.c:269).

``chain_scan_ref`` is the plain PyTorch version with the JAX function's
``[R, S]`` signature: every read steps in lockstep over the padded seed
axis and its records land in ``cap`` slots.  The CUDA kernels in
``csrc/chain.cu`` run one read a thread from CSR seed offsets, with no
padding: ``chain_scan`` launches the slots form (the JAX output),
``chain_emit`` the offsets form, one pass over tiles of reads with a
look-back across tiles that places every record at its exact offset,
which takes the place of the JAX driver's cap-doubling retry.
``chain_records`` is the host driver, read for read the JAX one's output.
As in the JAX CLI, ``modmap`` does not call it: it keeps the native
``mm_query_emit``.

u32 planes and records ride in int32 tensors (the same bits); dead slots
are all ones (-1).
"""

import numpy as np
import torch

from .. import _build, require_cuda
from ..ops.route import _scratch

F = 7  # record fields: pos[i0], pos[iN], loc0, locN, n1, n2, is_final
_M32 = 0xFFFFFFFF
IS1, LIVE = 1, 2    # csrc/chain.cu's seed flags
TILE_READS = 128    # csrc/chain.cu's TPB: reads a tile of the offsets form
_SCRATCH = {}       # (device index, stream) -> [scratch, calls so far]


def _u(x):
    """An int32 (u32 bits) or wider tensor as int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def _s32(x):
    """The int32 reading of u32 values held in int64."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _i32(x):
    """u32 values held in int64 as int32 tensors of the same bits."""
    return _s32(x).to(torch.int32)


def chain_scan_ref(loc_a, loc_b, id_a, id_b, is1, live, pos, idmap, *, cap):
    """Plain PyTorch version of the chain kernel's slots form: [R, S] seed
    planes -> (records int32 [R, cap, F], counts int32 [R], overflow bool).

    loc_a/loc_b: first and second reference occurrence of each seed's mod
    (u32); id_a/id_b: their reference sequence ids; is1: copy 1; live: the
    seed takes part (found, copy 1 or 2, not multi; padding dead); pos: the
    seed's query position (u32); idmap: the sequence id of each
    occurrence.  Occurrence 0 doubles as "no block open", as in the
    reference (loc0 = 0, modmap.c:214).  Records carry (pos[i0], pos[iN],
    loc0, locN, n1, n2, is_final); dead slots are all ones."""
    R, S = loc_a.shape
    dev = loc_a.device
    la, lb, ia, ib, ps = (_u(x) for x in (loc_a, loc_b, id_a, id_b, pos))
    one_all, lv_all = is1.to(torch.bool), live.to(torch.bool)
    idm = _u(idmap)
    z = torch.zeros(R, dtype=torch.int64, device=dev)
    loc0 = locN = p0 = pN = i0 = iN = n1 = n2 = z

    def block_break(loc, rid):
        """modmap.c:232-241: endBlock for candidate loc given the open
        block."""
        same_id = rid == idm[loc0]
        fwd, rev = loc0 < locN, loc0 > locN
        span = _s32((iN - i0) & _M32)
        d_f = _s32(_s32((locN - loc0) & _M32) - span)
        d_r = _s32(_s32((loc0 - locN) & _M32) - span)
        bad_f = (loc < locN) | (d_f > 50) | (d_f < -50)
        bad_r = (loc > locN) | (d_r > 50) | (d_r < -50)
        return ~same_id | (fwd & bad_f) | (rev & bad_r)

    emits, recs = [], []
    for t in range(S):
        loc, rid = la[:, t], ia[:, t]
        one, lv = one_all[:, t], lv_all[:, t]
        none = loc0 == 0
        end = none | block_break(loc, rid)
        retry = end & ~none & ~one
        loc = torch.where(retry, lb[:, t], loc)
        rid = torch.where(retry, ib[:, t], rid)
        end = torch.where(retry, block_break(loc, rid), end)
        emits.append(lv & end & (n1 > 2))
        recs.append(torch.stack([p0, pN, loc0, locN, n1, n2, z], 1))
        upd = lv & end
        loc0 = torch.where(upd, loc, loc0)
        i0 = torch.where(upd, t, i0)
        p0 = torch.where(upd, ps[:, t], p0)
        n1 = torch.where(lv, torch.where(end, 0, n1) + one.to(torch.int64),
                         n1)
        n2 = torch.where(lv, torch.where(end, 0, n2)
                         + (~one).to(torch.int64), n2)
        locN = torch.where(lv, loc, locN)
        pN = torch.where(lv, ps[:, t], pN)
        iN = torch.where(lv, t, iN)
    # the final block: gated on n2 > 2 alone (modmap.c:269, quirk)
    emits.append(n2 > 2)
    recs.append(torch.stack([p0, pN, loc0, locN, n1, n2, z + 1], 1))
    e = torch.stack(emits, 1)                               # [R, S+1]
    rec = torch.stack(recs, 1)                              # [R, S+1, F]
    csum = torch.cumsum(e.to(torch.int64), 1)
    counts = csum[:, -1]
    dest = csum - 1
    keep = e & (dest < cap)
    out = torch.full((R, cap, F), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(R, device=dev)[:, None].expand(R, S + 1)
    out[rows[keep], dest[keep]] = _i32(rec[keep])
    return out, counts.to(torch.int32), (counts > cap).any()


def _planes_check(planes, idmap):
    for t in planes + (idmap,):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("chain: u32 planes and idmap must be contiguous "
                             "int32")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_slots(la, lb, ia, ib, flags, pos, idmap, seed_off, R, cap, out,
                  counts, overflow):
    L = _build.lib()
    with torch.cuda.device(la.device):
        rc = L.mz_chain_scan(*(_ptr(t) for t in (la, lb, ia, ib, flags, pos,
                                                  idmap, seed_off)),
                             R, cap, _ptr(out), _ptr(counts), _ptr(overflow),
                             _stream(la.device))
    _build.check(rc, "chain_scan")
    _build.LAUNCHES["chain_scan"] += 1


def _launch_emit(la, lb, ia, ib, flags, pos, idmap, seed_off, R, rec_off,
                 out, L=None):
    """csrc/chain.cu's offsets form: one launch, rec_off and the records
    (out: at least floor(seeds / 3) rows) for R >= 1 reads.  ``L``: another
    build of the kernel with the same interface (a probe's), or the
    port's."""
    dev = la.device
    L = L or _build.lib()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        scratch, seq = _scratch(dev, stream, 1 + -(-R // TILE_READS),
                                pool=_SCRATCH, max_seq=1 << 30)
        rc = L.mz_chain_emit(*(_ptr(t) for t in (la, lb, ia, ib, flags, pos,
                                                  idmap, seed_off)),
                             R, scratch.data_ptr(), scratch.numel(), seq,
                             rec_off.data_ptr(), out.data_ptr(), stream)
    _build.check(rc, "chain_emit")
    _build.LAUNCHES["chain_scan"] += 1


def seed_flags(is1, live):
    """The kernel's seed byte: bit 0 copy 1, bit 1 live."""
    return (is1.to(torch.uint8) * IS1) | (live.to(torch.uint8) * LIVE)


def chain_scan(loc_a, loc_b, id_a, id_b, is1, live, pos, idmap, *, cap):
    """The chaining automaton over [R, S] seed planes, records in ``cap``
    slots a read: launches csrc/chain.cu (slots form, seed offsets r*S) for
    CUDA tensors, runs chain_scan_ref for CPU tensors.  Returns (records
    int32 [R, cap, F], counts int32 [R], overflow bool)."""
    if loc_a.device.type == "cpu":
        return chain_scan_ref(loc_a, loc_b, id_a, id_b, is1, live, pos,
                              idmap, cap=cap)
    if loc_a.device.type != "cuda":
        raise ValueError("chain_scan: unsupported device %s" % loc_a.device)
    R, S = loc_a.shape
    planes = tuple(x.reshape(-1).contiguous()
                   for x in (loc_a, loc_b, id_a, id_b, pos))
    _planes_check(planes, idmap)
    dev = loc_a.device
    seed_off = torch.arange(R + 1, dtype=torch.int64, device=dev) * S
    flags = seed_flags(is1, live).reshape(-1).contiguous()
    out = torch.empty((R, cap, F), dtype=torch.int32, device=dev)
    counts = torch.empty(R, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    _launch_slots(*planes[:4], flags, planes[4], idmap, seed_off, R, cap,
                  out, counts, overflow)
    return out, counts, overflow


def chain_emit_ref(la, lb, ia, ib, flags, pos, idmap, seed_off, *, cap=8,
                   tile_reads=4096):
    """Plain version of ``chain_emit``, the JAX driver's way: reads sorted
    by seed count, in tiles of ``tile_reads`` padded to a power of two of
    seeds, through chain_scan_ref with ``cap`` slots, doubled and run again
    while a read of the tile has more records."""
    dev = la.device
    off = seed_off.cpu().numpy()
    R = len(off) - 1
    counts = np.diff(off)
    order = np.argsort(counts, kind="stable")
    n_rec = torch.zeros(R, dtype=torch.int64, device=dev)
    tiles = []
    for t0 in range(0, R, tile_reads):
        rids = torch.from_numpy(order[t0:t0 + tile_reads]).to(dev)
        S = max(8, 1 << (int(counts[order[t0:t0 + tile_reads]].max()) - 1
                         ).bit_length())
        # seed j of tile read i: flat index off[rid] + j; past its end, the
        # zero appended to each plane (a dead seed)
        j = torch.arange(S, device=dev)
        start, cnt = seed_off[rids], seed_off[rids + 1] - seed_off[rids]
        src = torch.where(j < cnt[:, None], start[:, None] + j,
                          seed_off[-1])

        def plane(x):
            return torch.cat([x, x.new_zeros(1)])[src]
        fl = plane(flags.to(torch.int32))
        c = cap
        while True:
            rec, n, ovf = chain_scan_ref(
                plane(la), plane(lb), plane(ia), plane(ib), (fl & IS1) > 0,
                (fl & LIVE) > 0, plane(pos), idmap, cap=c)
            if not bool(ovf):
                break
            c *= 2
        n_rec[rids] = n.to(torch.int64)
        tiles.append((rids, rec, n))
    rec_off = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    rec_off[1:] = torch.cumsum(n_rec, 0)
    out = torch.full((int(rec_off[-1]), F), -1, dtype=torch.int32,
                     device=dev)
    for rids, rec, n in tiles:
        j = torch.arange(rec.shape[1], device=dev)
        keep = j < n[:, None]
        out[(rec_off[rids][:, None] + j)[keep]] = rec[keep]
    return out, rec_off


def chain_emit(la, lb, ia, ib, flags, pos, idmap, seed_off, *, cap=8,
               tile_reads=4096):
    """Every read's records at exact offsets: (records int32 [M, F], rec_off
    int64 [R+1]; read r's records are rows rec_off[r]..rec_off[r+1]).  Seeds
    in CSR form (int32 u32 planes, the flags byte of ``seed_flags``,
    seed_off int64 [R+1]).  CUDA tensors: csrc/chain.cu's offsets form, one
    launch into rows allocated at floor(seeds / 3) (every record closes a
    block of three live seeds or more), of which the first M are returned,
    copied when they fill under half of them (``cap`` and ``tile_reads``
    are the plain version's).  CPU tensors: chain_emit_ref."""
    if la.device.type == "cpu":
        return chain_emit_ref(la, lb, ia, ib, flags, pos, idmap, seed_off,
                              cap=cap, tile_reads=tile_reads)
    if la.device.type != "cuda":
        raise ValueError("chain_emit: unsupported device %s" % la.device)
    _planes_check((la, lb, ia, ib, pos), idmap)
    if la.numel() // 3 >= 1 << 31:
        raise ValueError("chain_emit: %d seeds; at most 3 * 2^31 - 1"
                         % la.numel())
    dev = la.device
    R = seed_off.numel() - 1
    if R == 0:
        return (torch.empty((0, F), dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev))
    rec_off = torch.empty(R + 1, dtype=torch.int64, device=dev)
    out = torch.empty((la.numel() // 3, F), dtype=torch.int32, device=dev)
    _launch_emit(la, lb, ia, ib, flags, pos, idmap, seed_off, R, rec_off, out)
    M = int(rec_off[-1])
    # a view would keep every row of the allocation alive
    return (out[:M] if 2 * M >= out.shape[0] else out[:M].clone()), rec_off


def seed_planes(ref, sidx, spos):
    """The seeds' planes on the host, as the JAX driver builds them: (la,
    lb, ia, ib as u32, is1, live, pos cut to u32)."""
    info = ref.ms.info
    copy = info[sidx] & 3
    live = (sidx != 0) & (copy != 3)
    la = np.where(sidx != 0, ref.rev[ref.loc[sidx]], 0).astype(np.uint32)
    lb_idx = np.where((sidx != 0) & (copy == 2), ref.loc[sidx] + 1, 0)
    lb = ref.rev[lb_idx].astype(np.uint32)
    ia = ref.id[la].astype(np.uint32)
    ib = ref.id[lb].astype(np.uint32)
    return la, lb, ia, ib, copy == 1, live, np.asarray(spos).astype(
        np.uint32)


def chain_records(ref, sidx, spos, seed_off, cap=8, tile_reads=4096,
                  device=None):
    """Host driver: each read's M records [(pos_i0, pos_iN, loc0, locN,
    n1, n2, is_final)] in emission order, the rows mm_query_emit would
    print as M lines.  ref: a core.reference.Reference (rev/loc/id arrays
    and the modset's info).  device: a torch.device or its name; None takes
    the CUDA card."""
    dev = require_cuda() if device is None else torch.device(device)
    la, lb, ia, ib, is1, live, ps = seed_planes(ref, sidx, spos)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                ).to(dev)
    flags = torch.from_numpy(
        (is1.astype(np.uint8) * IS1) | (live.astype(np.uint8) * LIVE)).to(dev)
    idmap = put(np.asarray(ref.id, np.uint32))
    off = torch.from_numpy(np.ascontiguousarray(seed_off, np.int64)).to(dev)
    rec, rec_off = chain_emit(put(la), put(lb), put(ia), put(ib), flags,
                              put(ps), idmap, off, cap=cap,
                              tile_reads=tile_reads)
    rows = [tuple(r) for r in rec.cpu().numpy().view(np.uint32).tolist()]
    bounds = rec_off.cpu().tolist()
    return [rows[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
