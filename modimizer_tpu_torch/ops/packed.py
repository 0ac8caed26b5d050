"""Packed 2-bit stream helpers in plain PyTorch (port of
``modimizer_tpu/ops/packed.py``).

u64 values ride in int64 tensors as their two's-complement bit patterns:
CPU PyTorch has no unsigned 64-bit shifts, compares or ``%``.  Multiplies,
``&``, ``|``, ``^``, ``~`` and left shifts wrap exactly as in u64.  A logical
right shift is an arithmetic shift plus a mask (``lsr``); no shift count ever
reaches 64.  Canonical k-mers and hashes are below 2^62 (k <= 31), so signed
compares and ``%`` on them are exact; full-range words (the funnel inputs,
Lemire products) go through ``lsr`` and ``ule``.

The host packers are the native ``pk_pack2``/``pk_valid_words`` (``native``);
the tests also use the JAX package's ``pack_sw``/``pack_bits``.
"""

from typing import NamedTuple

import torch

_SIGN = -(1 << 63)


def as_i64(u: int) -> int:
    """Python u64 -> the int64 with the same bit pattern."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >> 63 else u


def lsr(x, s: int):
    """Logical right shift of int64-carried u64 by a constant 0 <= s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def ule(x, c: int):
    """Unsigned x <= c for int64-carried u64 x and a Python u64 constant."""
    return (x ^ _SIGN) <= as_i64(c) ^ _SIGN


def grev64(x):
    """Reverse the order of the 32 2-bit groups in each u64."""
    for s, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                 (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = ((x & m) << s) | ((x >> s) & m)
    return (x << 32) | lsr(x, 32)


def derive_tw(sw):
    """tw[i] = complement of the 2-bit-group-reversed sw[i]: the reverse-
    complement stream, little-endian per word (3 - v == ~v in 2 bits)."""
    return ~grev64(sw)


def expand_bits(words, C: int):
    """Unpack int64 bit-words (bit p of word p // 64) into a bool [C]."""
    shifts = torch.arange(64, dtype=torch.int64, device=words.device)
    bits = (words[:, None] >> shifts) & 1
    return bits.reshape(-1)[:C].to(torch.bool)


def extract_kmers(sw, tw, k: int, C: int):
    """(h, hrc) forward and reverse-complement k-mers for C positions in
    stream order (position p = 32 i + r), by a two-word funnel shift per
    phase r.  sw/tw need C//32 + 1 words."""
    NW = C // 32

    def vec(vals):
        return torch.tensor(vals, dtype=torch.int64, device=sw.device)

    def lsr_masks(shifts):          # x >> s & mask == logical x >> s
        return vec([as_i64((1 << (64 - s)) - 1) for s in shifts])

    r2 = [2 * r for r in range(32)]
    inv = [64 - s if s else 1 for s in r2]  # r = 0 takes the word as it is
    zero = vec(r2) == 0
    w0s, w1s = sw[:NW, None], sw[1:NW + 1, None]
    w0t, w1t = tw[:NW, None], tw[1:NW + 1, None]
    hs = torch.where(zero, w0s,
                     (w0s << vec(r2)) | ((w1s >> vec(inv)) & lsr_masks(inv)))
    ht = torch.where(zero, w0t,
                     ((w0t >> vec(r2)) & lsr_masks(r2)) | (w1t << vec(inv)))
    h = lsr(hs, 64 - 2 * k).reshape(-1)
    hrc = (ht & ((1 << (2 * k)) - 1)).reshape(-1)
    return h, hrc


def canonical_hashes(h, hrc, k: int, factor1: int):
    """seqhash.h:58 hashes + canonical selection: (hashes, kmers, isF)."""
    f1 = as_i64(factor1)
    shift1 = 64 - 2 * k
    hf = lsr(h * f1, shift1)
    hr = lsr(hrc * f1, shift1)
    isF = hf < hr
    return torch.where(isF, hf, hr), torch.where(isF, h, hrc), isF


def _inv_odd(m: int, bits: int) -> int:
    x = m
    for _ in range(6):
        x = (x * (2 - m * x)) % (1 << bits)
    return x


class EmitTest(NamedTuple):
    """Constants of the division-free test ``h % w == 0`` for hashes below
    2^bits: ``rotr_bits(h * minv mod 2^bits, rot) <= limit``."""
    minv: int           # inverse of w's odd part, mod 2^bits
    rot: int            # trailing zero bits of w
    limit: int          # (2^bits - 1) // w


def emit_test(w: int, bits: int) -> EmitTest:
    """The test of Granlund and Montgomery (Hacker's Delight 10-17): for
    w = m 2^t with m odd and 0 <= h < 2^bits, w divides h exactly when
    h * inv(m) mod 2^bits, rotated right by t, is at most (2^bits - 1) // w.
    For w >= 2^bits only h = 0 is a multiple, which (1, 0, 0) tests."""
    if w < 1:
        raise ValueError("emit_test: w=%d < 1" % w)
    if w >> bits:
        return EmitTest(1, 0, 0)
    t = (w & -w).bit_length() - 1
    return EmitTest(_inv_odd(w >> t, bits), t, ((1 << bits) - 1) // w)


def mod_is_zero(hashes, w: int):
    """hashes % w == 0 for int64-carried u64 hashes, without division (the
    Lemire-Kaser test of the JAX version: for w = m 2^t, m odd,
    n % w == 0 <=> ror(n * inv(m), t) <= (2^64 - 1) // w)."""
    if w & (w - 1) == 0:
        return (hashes & (w - 1)) == 0
    t = (w & -w).bit_length() - 1
    prod = hashes * as_i64(_inv_odd(w >> t, 64))
    if t:
        prod = lsr(prod, t) | (prod << (64 - t))
    return ule(prod, ((1 << 64) - 1) // w)
