"""On-device k-mer extraction (SURVEY.md C9), jnp path.

The device path runs with jax x64 off, so canonical k-mers live as
``(hi, lo)`` uint32 pairs throughout it — the same
split the index table stores (SEMANTICS.md §2, §5). The rolling C loop of a
classic classifier becomes a **log-doubling merge**: length-2^l substring
codes are built in ceil(log2 k) rounds (m_{2l}[i] = m_l[i] << 2l | m_l[i+l]),
then the k-mer at every position composes from the binary decomposition of
k — O(log k) vector ops per position instead of O(k), all fused by XLA into
one elementwise pass over the batch (chosen on the earlier accelerator;
unmeasured on the H100). The reverse complement reuses the same merge on the complemented,
reversed code array (rc k-mer at i = fwd k-mer at mirrored position), and
window validity uses the same doubling on a "bad base" flag.

Bit-exactness contract: identical to `pangea_tpu.core.canonical_kmers`
(tested in tests/test_device_parity.py).
"""
from __future__ import annotations

import jax.numpy as jnp


def _pieces(k: int):
    """Binary decomposition of k into descending powers of two."""
    out = []
    l = 1
    while l * 2 <= k:
        l *= 2
    while k:
        if l <= k:
            out.append(l)
            k -= l
        l //= 2
    return out


def _merge_levels(codes2b, max_level: int):
    """codes2b: uint32 [B, L] 2-bit codes. Returns dict level→array where
    m[l][:, i] packs bases i..i+l-1 big-endian in 2l bits (l a power of 2,
    l ≤ 16 so everything fits 32 bits)."""
    m = {1: codes2b}
    l = 1
    while l * 2 <= max_level:
        a = m[l]
        m[2 * l] = (a[:, :a.shape[1] - l] << jnp.uint32(2 * l)) \
            | a[:, l:]
        l *= 2
    return m


def _merge_levels_rc(c2rc, max_level: int):
    """Reverse-complement twin of _merge_levels, REVERSE-FREE: with
    c2rc = 3 - codes, r[l][:, i] packs revcomp(bases i..i+l-1) in 2l bits.
    revcomp(s·t) = revcomp(t)·revcomp(s), so the doubling merge runs with
    swapped operand roles: r_{2l}[i] = r_l[i+l] << 2l | r_l[i]. This
    removes the three `reverse` HLO ops of the old reversed-slice
    formulation (~25 us each at headline shape, xprof r4 postfix trace)."""
    m = {1: c2rc}
    l = 1
    while l * 2 <= max_level:
        a = m[l]
        m[2 * l] = (a[:, l:] << jnp.uint32(2 * l)) \
            | a[:, :a.shape[1] - l]
        l *= 2
    return m


def _compose(m, k: int, P: int, rc: bool = False):
    """(hi, lo) uint32 [B, P] of the k-mer at every position, from merged
    levels. The 2k-bit value is accumulated hi/lo with explicit shifts.
    rc=True composes reverse-complement levels (_merge_levels_rc): the
    most-significant part of the rc k-mer is the rc of the LAST piece, so
    pieces accumulate in reverse offset order — same indexing, no flips."""
    hi = None
    lo = None
    bits = 0  # bits already accumulated (most-significant side)
    offs = []
    off = 0   # base offset of the next piece
    for piece in _pieces(k):
        offs.append((piece, off))
        off += piece
    for piece, off in (reversed(offs) if rc else offs):
        part = m[piece][:, off:off + P]          # uint32, 2*piece bits
        pbits = 2 * piece
        if hi is None:
            hi = jnp.zeros_like(part)
            lo = part
            bits = pbits
        else:
            # shift (hi,lo) left by pbits, then or-in part (pbits ≤ 32).
            hi = (hi << jnp.uint32(pbits)) \
                | (lo >> jnp.uint32(32 - pbits) if pbits < 32
                   else lo)
            lo = ((lo << jnp.uint32(pbits)) | part if pbits < 32
                  else part)
            bits += pbits
    return hi, lo


def extract_kmers_jnp(bases: jnp.ndarray, k: int):
    """bases: int32/uint8 [B, L] codes (0..3 real, 4 = AMBIG/pad).

    Returns (hi, lo, valid): uint32 [B, P], uint32 [B, P], bool [B, P]
    with P = L - k + 1 k-mer positions per SEMANTICS.md §2. Invalid
    positions carry canonical value 0.
    """
    codes = bases.astype(jnp.uint32)
    bad = (codes > 3).astype(jnp.uint32)
    c2 = codes & jnp.uint32(3)
    return _extract_from_c2(c2, bad, k)


def unpack_wire(rows: jnp.ndarray, L: int):
    """Decode the native packed wire format (pangea_io.cpp
    pangea_fastx_next_batch_packed): rows uint32 [B, W16 + W32] with base j
    in bits [2*(j%16), +2) of word j//16 and its "bad" flag in bit (j%32)
    of bad-word j//32. Returns (c2, bad): uint32 [B, L] each — pure
    elementwise VPU work that XLA fuses into the extraction pass."""
    w16 = (L + 15) // 16
    pos = jnp.arange(L)
    words = jnp.repeat(rows[:, :w16], 16, axis=1)[:, :L]
    c2 = (words >> (2 * (pos & 15)).astype(jnp.uint32)[None, :]) \
        & jnp.uint32(3)
    bwords = jnp.repeat(rows[:, w16:], 32, axis=1)[:, :L]
    bad = (bwords >> (pos & 31).astype(jnp.uint32)[None, :]) & jnp.uint32(1)
    return c2, bad


def extract_kmers_packed_jnp(rows: jnp.ndarray, L: int, k: int):
    """Packed-wire-format twin of extract_kmers_jnp (same outputs)."""
    c2, bad = unpack_wire(rows, L)
    return _extract_from_c2(c2, bad, k)


def _extract_from_c2(c2: jnp.ndarray, bad: jnp.ndarray, k: int):
    B, L = c2.shape
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"read length {L} shorter than k={k}")

    max_level = 1
    while max_level * 2 <= k:
        max_level *= 2

    # Forward: merge 2-bit codes big-endian.
    mf = _merge_levels(c2, max_level)
    f_hi, f_lo = _compose(mf, k, P)

    # Reverse complement: swapped-role doubling merge on the complemented
    # codes builds rc values IN PLACE — no reversed slices anywhere
    # (_merge_levels_rc), killing the reverse HLOs from the step.
    mr = _merge_levels_rc(jnp.uint32(3) - c2, max_level)
    r_hi, r_lo = _compose(mr, k, P, rc=True)

    # Validity: OR-doubling of the bad flag over the k-window.
    mb = {1: bad}
    l = 1
    while l * 2 <= max_level:
        a = mb[l]
        mb[2 * l] = a[:, :a.shape[1] - l] | a[:, l:]
        l *= 2
    anybad = None
    off = 0
    for piece in _pieces(k):
        part = mb[piece][:, off:off + P]
        anybad = part if anybad is None else (anybad | part)
        off += piece
    valid = anybad == 0

    # canonical = min(fwd, rc) on the 64-bit value (SEMANTICS.md §2).
    fwd_le = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    hi = jnp.where(fwd_le, f_hi, r_hi)
    lo = jnp.where(fwd_le, f_lo, r_lo)
    hi = jnp.where(valid, hi, jnp.uint32(0))
    lo = jnp.where(valid, lo, jnp.uint32(0))
    return hi, lo, valid
