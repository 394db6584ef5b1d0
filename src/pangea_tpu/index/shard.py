"""Index sharding (SEMANTICS.md §5.1, SURVEY.md C8/C16).

Splits an index's k-mer set into N per-shard single-probe tables by top
hash bits (the owner rule), each laid out by the same deterministic rule as
the monolithic table and padded to a common power-of-two size so the stacked
[N, S] arrays device_put cleanly onto a mesh axis. Resharding needs no
original genomes — the key set is recovered from the dense table itself.

Sharding also shrinks each device's table, which sped up random row
gathers on the earlier accelerator (unmeasured on the H100).

Two sources feed this module: a monolithic :class:`Index` (tables re-laid
in RAM — fine up to ~10^8 k-mers) and a :class:`ShardedIndex` written
directly by the out-of-core builder (per-shard mmap files; only shards
whose count differs from the mesh's are re-laid). Both produce bit-identical
device tables for a given k-mer set (the layout rule is deterministic).
"""
from __future__ import annotations

import numpy as np

from ..core import hash32_np
from .build import layout_table
from .container import EMPTY_HI, Index


def extract_pairs_tables(key_hi, key_lo, val, stash):
    """Recover (canon uint64[N] ascending, taxon int32[N]) from raw table
    arrays (bucket rows + stash)."""
    occ = key_hi != np.uint32(EMPTY_HI)
    hi = key_hi[occ].astype(np.uint64)
    lo = key_lo[occ].astype(np.uint64)
    canon = (hi << np.uint64(32)) | lo
    taxa = np.asarray(val)[occ]
    if stash is not None and stash.shape[1]:
        s_hi, s_lo, s_val = stash
        s_real = s_hi != np.uint32(EMPTY_HI)   # padded stash rows excluded
        canon = np.concatenate(
            [canon, (s_hi[s_real].astype(np.uint64) << np.uint64(32))
             | s_lo[s_real].astype(np.uint64)])
        taxa = np.concatenate([taxa, s_val.view(np.int32)[s_real]])
    order = np.argsort(canon, kind="stable")
    return canon[order], taxa[order]


def extract_pairs(index):
    """Recover (canon uint64[N] ascending, taxon int32[N]) from the table
    (bucket rows + stash). Accepts a monolithic :class:`Index` or a
    :class:`ShardedIndex` (per-shard extraction, merged ascending)."""
    if hasattr(index, "key_hi"):
        return extract_pairs_tables(index.key_hi, index.key_lo, index.val,
                                    index.stash)
    cs, ts = [], []
    for sh in index.shards:
        c, t = extract_pairs_tables(*sh)
        cs.append(c)
        ts.append(t)
    canon = np.concatenate(cs) if cs else np.zeros(0, np.uint64)
    taxa = np.concatenate(ts) if ts else np.zeros(0, np.int32)
    order = np.argsort(canon, kind="stable")
    return canon[order], taxa[order]


def owner_of(canon: np.ndarray, n_shards: int) -> np.ndarray:
    """The shard that owns each k-mer: top log2(n_shards) hash bits
    (SEMANTICS.md §5.1). n_shards must be a power of two; 1 → all zeros."""
    if n_shards == 1:
        return np.zeros(canon.shape, dtype=np.uint32)
    log2n = n_shards.bit_length() - 1
    return hash32_np(canon) >> np.uint32(32 - log2n)


def stack_parts(parts):
    """Pad per-shard layouts (key_hi, key_lo, val, stash, nb) to a common
    power-of-two bucket count and stash width, stacked [n_shards, NB_max, W]
    / stash [n_shards, 3, S_max]. Sub-tables are replicated nb_max/nb times
    so ``bucket = hash & (nb_max-1)`` lands on a correct copy — b mod nb_max
    ≡ b mod nb within each copy, so the §5 lookup is unchanged without
    re-layout. Stash padding entries carry EMPTY_HI keys (never match)."""
    n_shards = len(parts)
    nb_max = max(p[4] for p in parts)
    s_max = max(max(p[3].shape[1] for p in parts), 1)
    W = parts[0][0].shape[1]
    key_hi = np.full((n_shards, nb_max, W), EMPTY_HI, dtype=np.uint32)
    key_lo = np.zeros((n_shards, nb_max, W), dtype=np.uint32)
    val = np.zeros((n_shards, nb_max, W), dtype=np.int32)
    stash = np.zeros((n_shards, 3, s_max), dtype=np.uint32)
    stash[:, 0, :] = EMPTY_HI
    for s, (khi, klo, v, st, nb) in enumerate(parts):
        reps = nb_max // nb
        key_hi[s] = np.tile(khi, (reps, 1))
        key_lo[s] = np.tile(klo, (reps, 1))
        val[s] = np.tile(v, (reps, 1))
        stash[s, :, :st.shape[1]] = st
    return key_hi, key_lo, val, stash


def stack_q8_parts(parts, stash_pad: int = 0):
    """Stack per-shard q8 layouts ((fused [NB, 2W], stash3 [3, S_s])) into
    [S, NB, 2W] / [S, 3, S_max] (all parts share one nb — q8_layout's
    min_nb contract). Stash padding rows carry EMPTY_HI keys (never match
    a valid k-mer, k ≤ 31). stash_pad forces a minimum padded stash width
    (the streaming placement pads every shard to STASH_MAX so shapes are
    known before later shards are laid out)."""
    # No 1-floor: an all-empty single-shard stash stays [3, 0] so the
    # lookup kernel skips the stash scan entirely (S == 0 fast path).
    s_max = max(max(p[1].shape[1] for p in parts), stash_pad)
    fused = np.stack([p[0] for p in parts])
    stash = np.zeros((len(parts), 3, s_max), dtype=np.uint32)
    stash[:, 0, :] = EMPTY_HI
    for s, (_, st) in enumerate(parts):
        stash[s, :, :st.shape[1]] = st
    return fused, stash


def shard_tables_quot(index, n_shards: int, ways: int,
                      load_factor: float = 0.5, layout: str = "q8"):
    """Per-shard quotient relayout (VERDICT r3 #1/#3): the §5.1 owner
    partition (top mix32 hash bits — unchanged, so shard routing and the
    golden model are untouched), each shard's keys laid out as its own
    q8 (8 B/slot) or q12 (12 B/slot, two rem lanes — covers k=31) table
    at one COMMON bucket count. Exactness needs no owner masking at probe
    time: (bucket, rem) ↔ K is a bijection over ALL k-mers, and a k-mer
    is stored only in its owner shard, so a query can only ever match in
    the shard that stores it — per-position hit supports stay disjoint
    and the psum merge (SEMANTICS.md §11) is exact.

    Returns (fused [S, NB, RW], stash3 [S, 3, S_max], nb) or None when
    the layout is ineligible (q8: rem > 31 bits; Euler stamps > 16 bits)."""
    from ..kernels.lookup import (q8_layout, q8_nb_for, q12_layout,
                                  q12_nb_for)
    layout_fn, nb_fn = {"q8": (q8_layout, q8_nb_for),
                        "q12": (q12_layout, q12_nb_for)}[layout]
    tax = index.taxonomy
    if int(tax.tout.max(initial=0)) > 0xFFFF:
        return None
    k = index.meta.k
    canon, taxa = extract_pairs(index)
    owner = owner_of(canon, n_shards)
    counts = np.bincount(owner.astype(np.int64), minlength=n_shards)
    nbs = [nb_fn(int(c), k, ways, load_factor) for c in counts]
    if not nbs or any(v is None for v in nbs):
        # Ineligibility is k-driven (rem width at the capped nb), so one
        # ineligible shard means all are — bail explicitly rather than
        # masking a None into the max (ADVICE r4).
        return None
    nb = max(nbs)
    while True:                     # rare: a shard outgrows the target nb
        parts = []
        for s in range(n_shards):
            m = owner == s
            out = layout_fn(canon[m], taxa[m], tax.tin, tax.tout, k,
                            ways=ways, load_factor=load_factor, min_nb=nb)
            if out is None:
                return None
            f, st, nb_s = out
            if nb_s > nb:
                nb = nb_s
                parts = None
                break
            parts.append((f, st))
        if parts is not None:
            break
    # Sharded stashes pad to the layout's stash_max (128): a deterministic
    # width every process can compute independently (the streaming
    # placement ships shards before other hosts' stash sizes are knowable).
    # n_shards == 1 keeps the minimal width so an empty stash still skips
    # the stash scan entirely (the headline path).
    fused, stash = stack_q8_parts(parts, stash_pad=128 if n_shards > 1
                                  else 0)
    return fused, stash, nb


def shard_tables_q8(index, n_shards: int, ways: int,
                    load_factor: float = 0.5):
    return shard_tables_quot(index, n_shards, ways, load_factor, "q8")


def shard_tables(index, n_shards: int, load_factor: float = 0.5):
    """Returns (key_hi, key_lo, val, stash) stacked as
    [n_shards, NB_max, W] / stash [n_shards, 3, S_max]. n_shards must be a
    power of two. Accepts a monolithic :class:`Index` or a
    :class:`ShardedIndex` (see module docstring)."""
    if n_shards & (n_shards - 1):
        raise ValueError("n_shards must be a power of two")
    from .sharded import ShardedIndex
    if isinstance(index, ShardedIndex):
        return index.shard_tables(n_shards, load_factor)
    canon, taxa = extract_pairs(index)
    owner = owner_of(canon, n_shards)
    ways = index.meta.ways          # re-sharding preserves the bucket width
    parts = []
    for s in range(n_shards):
        m = owner == s
        parts.append(layout_table(canon[m], taxa[m], load_factor,
                                  ways=ways))
    return stack_parts(parts)
