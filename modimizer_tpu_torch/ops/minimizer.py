"""Minimizer (window-minimum) scan (port of ``modimizer_tpu/ops/
minimizer.py``): the reference's second sampling mode (minimizerRCiterator/
minimizerRCnext, seqhash.c:83-152).

``minimizer_scan_host`` is the numpy transcription of the reference's
circular-buffer winnowing loop (the parity oracle), with its quirks: ties
resolved by circular buffer index, not stream position; past-the-end
advances returning the all-ones u64 with the orientation flag left stale
(advanceHashRC, seqhash.c:70-79); the end-of-sequence rule that only values
strictly smaller than the last emitted minimum keep being emitted
(seqhash.c:142-149).

``minimizer_scan`` is the device variant: the all-window minimizer set (a
position is kept iff its canonical hash is the minimum of some full
w-window covering it), two sliding passes (window minimum, then the
covering windows' maximum), position-exact and order-free, so a sequence
tiles into chunks with halos of w-1 on both sides.  It is a superset of
the reference iterator's emissions, which jump past each minimum.  Each
chunk's device work is the CUDA kernel ``csrc/minimizer.cu``
(``minimizer_chunk``); ``minimizer_chunk_ref`` is its plain PyTorch
version.

u64 hashes ride in int64 tensors: canonical hashes are below 2^62 (k <= 31,
``Seqhash.create`` refuses larger k), so the pad is ``INT64_MAX`` where the
JAX package pads with the all-ones u64 (-1 in int64).
"""

import ctypes

import numpy as np
import torch

from .. import _build, require_cuda
from ..native import lib as native_lib
from .packed import canonical_hashes, derive_tw, extract_kmers

U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
PAD = (1 << 63) - 1
TILE = 4096          # csrc/minimizer.cu's SLOTS: positions a block holds
W_TILE = 1024        # the widest w on the kernel's tile path


def tile_geometry(w):
    """csrc/minimizer.cu's tile for w <= W_TILE: (left halo HL, outputs T).
    HL is w - 1 rounded up to 16; T the multiple of 16 that fits beside
    both halos in TILE positions."""
    h = w - 1
    hl = -(-h // 16) * 16
    return hl, (TILE - hl - h) // 16 * 16


def wide_scratch(C):
    """int64 words of scratch csrc/minimizer.cu's wide path (w > W_TILE)
    takes for a chunk of C positions: P, S and P' a position, and four
    aggregates a block of TILE."""
    return 3 * C + 4 * -(-C // TILE)


def minimizer_scan_host(sh, codes: np.ndarray):
    """The reference iterator over one sequence.

    Returns (hashes u64, positions int64, isF bool) in emission order."""
    codes = np.ascontiguousarray(codes).view(np.uint8)
    n = len(codes)
    k, w = sh.k, sh.w
    if n < k:
        return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                np.zeros(0, bool))
    _kms, hashes, isF = sh.scan(codes)
    npos = len(hashes)

    hb = np.zeros(w, np.uint64)
    fb = np.zeros(w, bool)
    t = 0  # advances made so far; advance t produces hashes[t] or U64MAX

    def adv(i):
        nonlocal t
        t += 1
        if t < npos:
            hb[i] = hashes[t]
            fb[i] = isF[t]
        else:
            hb[i] = U64MAX  # fb stays stale, like the reference

    # NB reference bug kept: minimizerRCiterator never stores the first
    # hash into hashBuf[0] (seqhash.c:100), so a first-window minimum at
    # buffer slot 0 is emitted as 0
    fb[0] = isF[0]
    mn = hashes[0]
    i_min = 0
    for i in range(1, w):
        adv(i)
        if hb[i] < mn:
            mn = hb[i]
            i_min = i
    i_start = 0
    base = 0
    out_u, out_p, out_f = [], [], []

    while True:
        u = hb[i_min]
        pos = base + i_min + (w if i_min < i_start else 0)
        out_u.append(u)
        out_p.append(pos)
        out_f.append(bool(fb[i_min]))
        if t >= npos - 1:  # si->s >= si->sEnd (seqhash.c:124)
            break
        if i_min >= i_start:
            for i in range(i_start, i_min + 1):
                adv(i)
        else:
            for i in range(i_start, w):
                adv(i)
            base += w
            for i in range(0, i_min + 1):
                adv(i)
        old = i_min
        i_start = i_min + 1
        if i_start == w:
            i_start = 0
            base += w
        if hb[old] != U64MAX:  # a full new window exists
            mn = U64MAX
            found = -2  # any slot < U64MAX will win
        else:  # keep the last min; only strictly smaller values count
            mn = u
            found = -1
        for i in range(w):
            if hb[i] < mn:
                mn = hb[i]
                found = i
        if found == -1:
            break  # old min not beaten - done
        i_min = found if found >= 0 else i_min

    return (np.array(out_u, np.uint64), np.array(out_p, np.int64),
            np.array(out_f, bool))


def _sliding(op, x, w, pad):
    """w-wide sliding op by log-step shifts: out[i] = op(x[i..i+w-1]),
    ``pad`` past the end."""
    out = x
    done = 1
    while done < w:
        step = min(done, w - done)
        shifted = torch.cat([out[step:], torch.full(
            (step,), pad, dtype=x.dtype, device=x.device)])
        out = op(out, shifted)
        done += step
    return out


def _check(sw, C, k, w):
    if sw.dtype != torch.int64 or sw.dim() != 1 or not sw.is_contiguous():
        raise ValueError("minimizer_chunk: sw must be contiguous int64")
    if C <= 0 or C % 32 or sw.numel() < C // 32 + 1:
        raise ValueError("minimizer_chunk: C=%d must be a positive multiple "
                         "of 32 with C/32 + 1 words (got %d)"
                         % (C, sw.numel()))
    if not 1 <= k <= 31 or not 1 <= w <= C:
        raise ValueError("minimizer_chunk: k=%d w=%d C=%d" % (k, w, C))


def minimizer_chunk_ref(sw, m_ext, n_win, base, *, k, w, factor1, C):
    """Plain PyTorch version of the minimizer kernel over a block of C hash
    positions (32-aligned, both halos included by the caller): m_ext live
    positions; n_win full windows in the whole sequence; base the global
    position of the block's first hash.  Returns (hashes int64 [C], isF
    bool [C], emitted bool [C])."""
    _check(sw, C, k, w)
    h, hrc = extract_kmers(sw, derive_tw(sw), k, C)
    hashes, _kmers, isF = canonical_hashes(h, hrc, k, factor1)
    pos = torch.arange(C, dtype=torch.int64, device=sw.device)
    live = pos < m_ext
    hh = torch.where(live, hashes, PAD)
    a = _sliding(torch.minimum, hh, w, PAD)      # A[s]: the window from s
    valid = (pos + base) < n_win                 # s starts a full window
    m = _sliding(torch.maximum, torch.where(valid, a, 0).flip(0), w,
                 0).flip(0)                      # M[p]: over s in [p-w+1, p]
    covered = _sliding(torch.maximum, valid.flip(0).to(torch.int32), w,
                       0).flip(0) > 0
    return hashes, isF, (m == hh) & live & covered


def minimizer_chunk(sw, m_ext, n_win, base, *, k, w, factor1, C):
    """The minimizer pass over one chunk: launches csrc/minimizer.cu for
    CUDA tensors, runs minimizer_chunk_ref for CPU tensors.  Returns
    (hashes int64 [C], isF bool [C], emitted bool [C]) on sw's device."""
    if sw.device.type == "cpu":
        return minimizer_chunk_ref(sw, m_ext, n_win, base, k=k, w=w,
                                   factor1=factor1, C=C)
    if sw.device.type != "cuda":
        raise ValueError("minimizer_chunk: unsupported device %s"
                         % sw.device)
    _check(sw, C, k, w)
    dev = sw.device
    out_h = torch.empty(C, dtype=torch.int64, device=dev)
    out_f = torch.empty(C, dtype=torch.bool, device=dev)
    out_e = torch.empty(C, dtype=torch.bool, device=dev)
    scratch = (torch.empty(wide_scratch(C), dtype=torch.int64, device=dev)
               if w > W_TILE else None)
    L = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.mz_minimizer_chunk(
            sw.data_ptr(), C, int(m_ext), int(n_win), int(base), k, w,
            ctypes.c_uint64(factor1), out_h.data_ptr(), out_f.data_ptr(),
            out_e.data_ptr(), None if scratch is None else scratch.data_ptr(),
            stream)
    _build.check(rc, "minimizer_chunk")
    _build.LAUNCHES["minimizer"] += 1
    return out_h, out_f, out_e


def minimizer_scan(sh, codes: np.ndarray, chunk: int = 1 << 22, device=None):
    """Device all-window minimizer scan of one sequence (see the module doc:
    a superset of the reference's jump-chain emissions).  device: a
    torch.device or its name; None takes the CUDA card.  Returns (hashes
    u64, positions int64, isF bool) in position order."""
    dev = require_cuda() if device is None else torch.device(device)
    codes = np.ascontiguousarray(codes).view(np.uint8)
    n = len(codes)
    k, w = sh.k, sh.w
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.int64),
             np.zeros(0, bool))
    if n < k:
        return empty
    npos = n - k + 1
    if npos < w:  # no full windows
        return empty
    n_win = npos - w + 1  # number of full windows
    L = native_lib()

    out_h, out_p, out_f = [], [], []
    C = min(chunk, ((npos + 63) // 64) * 64)
    # halos of w-1 positions: the windows that cover a chunk's first
    # positions start in the chunk before, and its last positions' windows
    # end in the chunk after
    Cext = ((C + 2 * (w - 1) + 31) // 32) * 32
    nw = Cext // 32 + 1
    for s in range(0, npos, C):
        lo = min(w - 1, s)
        base_pos = s - lo
        m_ext = min(Cext, npos - base_pos)
        seg = np.ascontiguousarray(codes[base_pos:base_pos + Cext + k - 1])
        sw = np.empty(nw, np.uint64)
        L.pk_pack2(seg, len(seg), sw, nw)
        sw_d = torch.from_numpy(sw.view(np.int64)).to(dev)
        hh, ff, em = minimizer_chunk(sw_d, m_ext, n_win, base_pos, k=k,
                                     w=w, factor1=sh.factor1, C=Cext)
        m = min(C, npos - s)
        idx = torch.nonzero(em[lo:lo + m]).reshape(-1)
        out_h.append(hh[lo:lo + m][idx].cpu().numpy().view(np.uint64))
        out_p.append(idx.cpu().numpy() + s)
        out_f.append(ff[lo:lo + m][idx].cpu().numpy())
    return (np.concatenate(out_h), np.concatenate(out_p).astype(np.int64),
            np.concatenate(out_f))
