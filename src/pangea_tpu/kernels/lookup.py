"""On-device hash-and-lookup (SURVEY.md C10), jnp path.

The index's single-probe bucketized table (SEMANTICS.md §5 v5) lives in
device memory as one fused uint32 [NB, lanes] array; a lookup is exactly ONE
contiguous bucket-row gather over the whole query batch plus lane-parallel
compares, then a parallel scan of the tiny overflow stash (usually empty).
No data-dependent probe chains and no second round: one wide bucket row
replaced the two-choice cuckoo design, because independent row gathers did
not overlap (chosen on the earlier accelerator; unmeasured on the H100).
Ownership check implements the sharded-index rule of SEMANTICS.md §5.1: a
shard probes only k-mers whose top hash bits name it, everything else
reports taxon 0 and is merged by a later psum.

Bit-exactness contract: identical to `Index.lookup_np` (SEMANTICS.md §4–§5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as _np

# numpy scalars, NOT jnp: module-level jnp constants would initialize the
# XLA backend at import time, breaking jax.distributed.initialize (which
# must run before any backend touch in multi-process runs).
_GOLD = _np.uint32(0x9E3779B9)
_EMPTY_HI = _np.uint32(0xFFFFFFFF)


def mix32_jnp(v):
    """MurmurHash3 fmix32 finalizer (SEMANTICS.md §4)."""
    v = v ^ (v >> jnp.uint32(16))
    v = v * jnp.uint32(0x85EBCA6B)
    v = v ^ (v >> jnp.uint32(13))
    v = v * jnp.uint32(0xC2B2AE35)
    v = v ^ (v >> jnp.uint32(16))
    return v


def hash32_jnp(hi, lo):
    return mix32_jnp(mix32_jnp(lo ^ _GOLD) ^ hi)


def fuse_table(key_hi, key_lo, val, tin, tout):
    """[NB, W] ×3 table arrays + taxonomy Euler arrays ([T+1]) → one uint32
    fused row per bucket, carrying the hit taxon's Euler interval so the
    scorer needs NO per-position taxonomy gather (gathers cost per
    element, however small the source). Derived at device-load time; not part of
    the on-disk format.

    Two layouts (lookup_jnp infers from the row width):
    - packed  [NB, 4W] = [hi×W | lo×W | val×W | (tin<<16|tout)×W] when the
      taxonomy fits 16-bit Euler stamps (tout ≤ 0xFFFF). W=16 → a 256 B
      row. Rows are power-of-two bytes (chosen on the earlier accelerator;
      unmeasured on the H100).
    - wide    [NB, 6W] = [hi | lo | val | tin | tout | pad] otherwise
      (row padded to a power-of-two byte size)."""
    import numpy as np
    key_hi = np.asarray(key_hi, dtype=np.uint32)
    val = np.asarray(val, dtype=np.int32)
    tin = np.asarray(tin, dtype=np.int32)
    tout = np.asarray(tout, dtype=np.int32)
    if int(tout.max(initial=0)) <= 0xFFFF:
        pk = (tin[val].astype(np.uint32) << np.uint32(16)) \
            | tout[val].astype(np.uint32)
        return np.concatenate(
            [key_hi, np.asarray(key_lo, dtype=np.uint32),
             val.view(np.uint32), pk], axis=-1)
    pad = np.zeros(key_hi.shape, dtype=np.uint32)
    return np.concatenate(
        [key_hi, np.asarray(key_lo, dtype=np.uint32),
         val.view(np.uint32),
         tin[val].view(np.uint32),
         tout[val].view(np.uint32), pad], axis=-1)


def fuse_stash(stash, tin, tout):
    """uint32 [3, S] (hi, lo, val-bits) → uint32 [5, S] with tin/tout rows
    appended (empty-stash padding keeps val 0 → tin[0]/tout[0], never
    selected because its key_hi is the EMPTY sentinel). The stash is tiny
    and scanned in parallel, so it keeps the simple unpacked layout."""
    import numpy as np
    stash = np.asarray(stash, dtype=np.uint32)
    sval = stash[2].view(np.int32)
    tin = np.asarray(tin, dtype=np.int32)
    tout = np.asarray(tout, dtype=np.int32)
    return np.concatenate(
        [stash, tin[sval].view(np.uint32)[None, :],
         tout[sval].view(np.uint32)[None, :]], axis=0)


def lookup_jnp(hi, lo, valid, fused, stash, *, n_shards: int = 1,
               shard_id=0, ways: int = 16):
    """Probe one (possibly sharded) single-probe table (SEMANTICS.md §5 v5).

    hi/lo/valid: uint32/bool [B, P] (or flat [N]) from extract_kmers_jnp.
    fused: uint32 [NB, 4W] (packed) or [NB, 6W] (wide) fused rows
        (fuse_table) — THIS shard's table; layout inferred from the row
        width given `ways`.
    stash: uint32 [5, S] overflow rows (fuse_stash); S may be 0; padding
        entries carry hi == 0xFFFFFFFF (never match a valid k-mer).
    Returns (taxon, t_in, t_out), each int32 like hi: the hit taxon
    (0 = miss, not owned, or invalid) and its Euler interval (0 at
    non-hits — callers mask by ``taxon != 0``).
    """
    nb = fused.shape[0]
    W = ways
    packed = fused.shape[1] == 4 * W
    bmask = jnp.uint32(nb - 1)
    shape = hi.shape
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    valid = valid.reshape(-1)
    h = hash32_jnp(hi, lo)
    if n_shards > 1:
        log2n = n_shards.bit_length() - 1
        owner = h >> jnp.uint32(32 - log2n)
        mine = valid & (owner == jnp.uint32(shard_id))
    else:
        mine = valid
    b = (h & bmask).astype(jnp.int32)

    def _std_lanes(bc, hic, loc, mc):
        """Gather + lane compare + masked sums for one query (chunk):
        the same one-pass-over-rows math XLA fuses either way."""
        rows = fused[bc]                       # [?, 4W|6W] — row gather
        khi = rows[..., 0:W]
        klo = rows[..., W:2 * W]
        val = jax.lax.bitcast_convert_type(rows[..., 2 * W:3 * W],
                                           jnp.int32)
        hitlane = (mc[..., None] & (khi == hic[..., None])
                   & (klo == loc[..., None]))
        taxon = jnp.sum(jnp.where(hitlane, val, 0), axis=-1)
        if packed:
            pk = jnp.sum(jnp.where(hitlane, rows[..., 3 * W:4 * W],
                                   jnp.uint32(0)), axis=-1)
            t_in = (pk >> jnp.uint32(16)).astype(jnp.int32)
            t_out = (pk & jnp.uint32(0xFFFF)).astype(jnp.int32)
        else:
            p2 = jax.lax.bitcast_convert_type(rows[..., 3 * W:5 * W],
                                              jnp.int32)
            t_in = jnp.sum(jnp.where(hitlane, p2[..., 0:W], 0), axis=-1)
            t_out = jnp.sum(jnp.where(hitlane, p2[..., W:2 * W], 0),
                            axis=-1)
        return taxon, t_in, t_out

    path, chunk = lookup_path(b.shape[0], nb, fused.shape[1] * 4,
                              min_chunk=32768)
    if path == "sorted":
        # Deep table: sorted-sliced gather (see _sorted_std) — the
        # big-taxonomy (wide-row) RefSeq case q8/q12 cannot serve.
        taxon, t_in, t_out = _sorted_std(fused, b, hi, lo, mine, W,
                                         packed, chunk)
    elif path == "chunked":
        # Chunked gather (see _Q8_CHUNK): bounds the materialized
        # [N, 4W|6W] rows intermediate.
        taxon, t_in, t_out = _map_chunks(_std_lanes, chunk, b, hi, lo,
                                         mine)
    else:
        taxon, t_in, t_out = _std_lanes(b, hi, lo, mine)

    S = stash.shape[1]
    if S:                                       # parallel stash scan
        shit = (mine[:, None] & (hi[:, None] == stash[0][None, :])
                & (lo[:, None] == stash[1][None, :]))
        sv = jax.lax.bitcast_convert_type(stash[2:], jnp.int32)
        taxon = taxon + jnp.sum(jnp.where(shit, sv[0][None, :], 0), axis=-1)
        t_in = t_in + jnp.sum(jnp.where(shit, sv[1][None, :], 0), axis=-1)
        t_out = t_out + jnp.sum(jnp.where(shit, sv[2][None, :], 0), axis=-1)
    return (taxon.reshape(shape), t_in.reshape(shape),
            t_out.reshape(shape))


# ---------------------------------------------------------------- q8 layout
# Quotiented-key single-probe layout (DESIGN.md): a slot stores 8 bytes —
# a 32-bit quotient REMAINDER + the packed (tin<<16|tout) Euler payload —
# instead of the 16-byte (hi, lo, val, pk) lane set. Halving slot bytes
# halves the rows and bytes a table needs: the dense (w=1) k=21 parity
# index becomes ONE [2^16, 512 B] single-probe table.
#
# Exactness: the canonical k-mer K (2k bits) is mapped by the BIJECTIVE
# mix h = (K * A) mod 2^(2k) (A odd); bucket = top log2(NB) bits of h,
# rem = the low r = 2k - log2(NB) bits. (bucket, rem) <-> K is a bijection,
# so a rem match in the home bucket identifies exactly one k-mer — no
# false positives for ANY query, in or out of the table. Requires r <= 31
# (rem fits a lane below the 0xFFFFFFFF empty sentinel) and 16-bit Euler
# stamps; taxon ids are recovered from tin at the [B] level by the scorer
# (kernels.score.score_reads_tin_jnp), never via [B, P] gathers.
_Q8_A = _np.uint64(0x9E3779B1)        # odd (2^32/golden-ratio, Knuth)
_Q8_WAYS = 64                         # 8 B x 64 = 512 B fused rows
# Chunked-gather policy: when the gather is a fusion root, XLA writes its
# [N, 2W] rows output to device memory and the lane-compare fusion reads
# it back. Running gather+compare+sum per query chunk under lax.map bounds
# the intermediate to [chunk, 2W]. Applied when the flat query count
# exceeds the chunk size; exactness is per-element identical. The policy
# and the chunk size were chosen on the earlier accelerator; unmeasured on
# the H100 (ROADMAP S1).
_Q8_CHUNK = 32768


def _quot_chunk() -> int:
    import os
    return max(int(os.environ.get("PANGEA_Q8_CHUNK", _Q8_CHUNK)), 1)


def lookup_path(n: int, nb: int, row_bytes: int,
                min_chunk: int = 8192) -> tuple[str, int]:
    """The gather every lookup runs for n flat probes on an nb-row table:
    ("sorted", probes per sorted chunk) for deep tables (see
    _sorted_apply), ("chunked", chunk) beyond the chunk size (see
    _Q8_CHUNK), else ("plain", n). min_chunk: see _deep_chunk."""
    if nb > _DEEP_ROWS:
        dchunk = _deep_chunk(n, nb, row_bytes, min_chunk=min_chunk)
        if dchunk is not None and n > dchunk:
            return "sorted", dchunk
    chunk = _quot_chunk()
    if n > chunk:
        return "chunked", chunk
    return "plain", n


def _map_chunks(lane_fn, chunk, *arrays):
    """Run lane_fn over aligned chunks of flat same-length arrays via
    lax.map — the one place the chunked-gather pad/reshape/unpad
    plumbing lives. The tail pads with zeros (padding queries carry
    valid/mine = False, so every lane is masked) and is sliced back
    off. lane_fn(*chunks) may return one array or a tuple of arrays."""
    N = arrays[0].shape[0]
    nch = -(-N // chunk)
    pad = nch * chunk - N

    def prep(x):
        if pad:
            x = jnp.concatenate([x, jnp.zeros(pad, x.dtype)])
        return x.reshape(nch, chunk)

    out = jax.lax.map(lambda a: lane_fn(*a),
                      tuple(prep(x) for x in arrays))
    return jax.tree.map(lambda y: y.reshape(-1)[:N] if pad
                        else y.reshape(-1), out)


def _chunked_pk(fused, b, rem_lanes, valid, W, chunk):
    """Per-chunk gather + lane compare + payload sum: pk uint32 [N].
    rem_lanes: one (q8) or two (q12) flat uint32 [N] remainder arrays;
    lane set j of `fused` is compared against rem_lanes[j], the payload
    lane set is the one after the remainder sets."""
    n_rem = len(rem_lanes)

    def one(bc, vc, *rems):
        rows = fused[bc]                      # [chunk, lanes]
        hitlane = vc[:, None]
        for j, rc in enumerate(rems):
            hitlane = hitlane & (rows[:, j * W:(j + 1) * W] == rc[:, None])
        return jnp.sum(jnp.where(hitlane, rows[:, n_rem * W:
                                               (n_rem + 1) * W],
                                 jnp.uint32(0)), axis=-1)

    return _map_chunks(one, chunk, b, valid, *rem_lanes)


# ------------------------------------------------- deep-table sorted gather
# Beyond _DEEP_ROWS table rows, probes are grouped by bucket (one 1-D
# lax.sort) and each sorted chunk gathers from a dynamic 2^15-row table
# slice instead of the whole table. The rule and its constants were chosen
# on the earlier accelerator, where a small gather operand was much faster
# than a big one; unmeasured on the H100 (ROADMAP S2). Exactness: the
# per-chunk bucket
# span is data-dependent, so a guard computes every chunk's span and a
# lax.cond falls back to the plain chunked gather (on the sorted probes —
# order is irrelevant to it) whenever any span exceeds the slice; results
# return to input order by a scatter to the carried index. Validity
# folds into the remainder lanes (invalid probes get the empty-lane
# sentinel, which can only "match" empty lanes whose payload is 0), so
# the sorted path needs no separate valid operand and stays bit-exact.
_DEEP_ROWS = 1 << 17
_DEEP_SLICE = 1 << 15


def _deep_chunk(n: int, nb: int, row_bytes: int = 512,
                min_chunk: int = 8192) -> int | None:
    """Probes per slice-chunk: expected bucket span = nb·chunk/n; target
    ≤ SLICE/2 so the exact guard virtually never trips. None = too few
    probes per row for sorting to pay (fall back to the plain path).
    min_chunk: the std layout passes 32768 — its sorts carry 2 probe
    operands in and 3 outputs back (vs q8's 1+1), so it needs more
    probes per row before sorting pays."""
    import os
    if os.environ.get("PANGEA_DEEP_SORT", "1") != "1":
        return None
    c = n * (_DEEP_SLICE // 2) // max(nb, 1)
    if c < min_chunk or nb * row_bytes > (1 << 31):
        # Tables above 2 GB skip the sorted path: the per-chunk tile
        # copies total ~2x table bytes regardless of N (cap chosen on the
        # earlier accelerator; unmeasured on the H100).
        return None
    return 1 << min(c.bit_length() - 1, 19)


def _sorted_apply(fused, b, probes, lanes_fn, chunk):
    """Shared deep-regime skeleton: sort (bucket, *probes, idx), run
    lanes_fn(rows, probe_chunks) -> tuple of [chunk] outputs per sliced
    chunk (or against the plain full-table gather under the span-guard
    fallback), and un-sort every output by a scatter to the carried
    index. Pad entries carry the batch-max bucket (tight tail span) and
    zero probes — pad OUTPUTS are sliced off after the restore, so their
    content is inert by construction."""
    nb, lanes = fused.shape
    sl = min(_DEEP_SLICE, nb)       # production nb is always > the slice
    N = b.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    nch = -(-N // chunk)
    pad = nch * chunk - N
    probes = list(probes)
    if pad:
        bmax = jnp.max(b)
        b = jnp.concatenate([b, jnp.broadcast_to(bmax, (pad,))])
        probes = [jnp.concatenate([r, jnp.zeros(pad, r.dtype)])
                  for r in probes]
        idx = jnp.concatenate([idx, N + jnp.arange(pad, dtype=jnp.int32)])
    srt = jax.lax.sort((b, *probes, idx), num_keys=1)
    sb, sprobes, sidx = srt[0], srt[1:-1], srt[-1]
    sb2 = sb.reshape(nch, chunk)
    firsts = sb2[:, 0]
    ok = jnp.all(sb2[:, -1] - firsts < jnp.int32(sl))
    pchunks = tuple(r.reshape(nch, chunk) for r in sprobes)

    def sliced(_):
        def body(args):
            first, bc = args[0], args[1]
            start = jnp.clip(first, 0, jnp.int32(nb - sl))
            tile = jax.lax.dynamic_slice(
                fused, (start, jnp.int32(0)), (sl, lanes))
            # The barrier pins the slice as a materialized gather
            # operand — unfused, XLA folds slice+gather back into the
            # full-table gather.
            tile = jax.lax.optimization_barrier(tile)
            return lanes_fn(tile[bc - start], args[2:])
        return jax.lax.map(body, (firsts, sb2) + pchunks)

    def plain(_):
        def body(args):
            return lanes_fn(fused[args[0]], args[1:])
        return jax.lax.map(body, (sb2,) + pchunks)

    outs = jax.lax.cond(ok, sliced, plain, None)
    if not isinstance(outs, tuple):
        outs = (outs,)
    # Restore input order by scattering each output to its carried index
    # (sidx is a permutation of [0, nch*chunk)). A second sort keyed on
    # sidx computes the same thing, but XLA's GPU permutation-sort
    # rewrite turns it into a scatter that fails HLO verification for
    # uint32 operands.
    return tuple(jnp.zeros(nch * chunk, o.dtype)
                 .at[sidx].set(o.reshape(-1), unique_indices=True)[:N]
                 for o in outs)


def _sorted_pk(fused, b, rem_lanes, valid, W, chunk):
    """Deep-regime quotient (q8/q12) pk lookup via _sorted_apply.
    Bit-identical to _chunked_pk for any input: validity folds into the
    remainder lanes (invalid probes get the empty-lane sentinel pattern —
    rem_hi sentinel for q12, the single rem for q8 — which can only
    "match" empty lanes, whose pk lane is 0 by construction)."""
    n_rem = len(rem_lanes)
    sent = jnp.uint32(0xFFFFFFFF)
    rems = list(rem_lanes)
    if n_rem == 1:
        rems[0] = jnp.where(valid, rems[0], sent)
    else:
        rems[0] = jnp.where(valid, rems[0], jnp.uint32(0))
        rems[1] = jnp.where(valid, rems[1], sent)

    def lanes_fn(rows, rcs):
        hitlane = rows[:, 0:W] == rcs[0][:, None]
        for j in range(1, n_rem):
            hitlane = hitlane & (rows[:, j * W:(j + 1) * W]
                                 == rcs[j][:, None])
        return jnp.sum(jnp.where(hitlane,
                                 rows[:, n_rem * W:(n_rem + 1) * W],
                                 jnp.uint32(0)), axis=-1)

    (pk,) = _sorted_apply(fused, b, rems, lanes_fn, chunk)
    return pk


# Matches NOTHING: real canonical key_hi fits 2k-32 ≤ 30 bits and the
# empty-lane sentinel is 0xFFFFFFFF, whose payload lanes are NOT zero in
# the std layout (val 0 → tin[0] = tout[0] = −1 Euler stamps), so std
# invalid probes must match neither real nor empty lanes.
_NEVER_HI = _np.uint32(0xFFFFFFFE)


def _sorted_std(fused, b, hi, lo, mine, W, packed, chunk):
    """Deep-regime std-layout lookup via _sorted_apply: same
    (taxon, t_in, t_out) contract as _std_lanes inside lookup_jnp —
    zeros at invalid/unowned positions (the _NEVER_HI folding)."""
    hi_e = jnp.where(mine, hi, jnp.uint32(_NEVER_HI))
    lo_e = jnp.where(mine, lo, jnp.uint32(0))

    def lanes_fn(rows, ps):
        hic, loc = ps
        khi = rows[:, 0:W]
        klo = rows[:, W:2 * W]
        val = jax.lax.bitcast_convert_type(rows[:, 2 * W:3 * W],
                                           jnp.int32)
        hitlane = (khi == hic[:, None]) & (klo == loc[:, None])
        taxon = jnp.sum(jnp.where(hitlane, val, 0), axis=-1)
        if packed:
            pk = jnp.sum(jnp.where(hitlane, rows[:, 3 * W:4 * W],
                                   jnp.uint32(0)), axis=-1)
            t_in = (pk >> jnp.uint32(16)).astype(jnp.int32)
            t_out = (pk & jnp.uint32(0xFFFF)).astype(jnp.int32)
        else:
            p2 = jax.lax.bitcast_convert_type(rows[:, 3 * W:5 * W],
                                              jnp.int32)
            t_in = jnp.sum(jnp.where(hitlane, p2[:, 0:W], 0), axis=-1)
            t_out = jnp.sum(jnp.where(hitlane, p2[:, W:2 * W], 0),
                            axis=-1)
        return taxon, t_in, t_out

    return _sorted_apply(fused, b, (hi_e, lo_e), lanes_fn, chunk)


def q8_hash_np(canon: _np.ndarray, k: int) -> _np.ndarray:
    """h = (K * A) mod 2^(2k) — the bijective quotient mix (numpy side)."""
    m = 2 * k
    mask = _np.uint64((1 << m) - 1)
    return (canon.astype(_np.uint64) * _Q8_A) & mask


def q8_rem_bits(k: int, nb: int) -> int:
    return 2 * k - (nb.bit_length() - 1)


def q8_nb_for(n: int, k: int, ways: int = _Q8_WAYS,
              load_factor: float = 0.5, min_nb: int = 0) -> int | None:
    """The bucket count q8_layout's growth rule picks for n keys (data-
    free): capacity growth, then the min_nb floor, then rem-width growth.
    None when the remainder cannot fit 31 bits (k=31 at any capped NB).
    Used by the sharded relayout to pick one COMMON nb for all shards."""
    nb = 8
    while nb * ways * load_factor < max(n, 1):
        nb *= 2
    while nb < min_nb:
        nb *= 2
    while q8_rem_bits(k, nb) > 31 and nb <= (1 << 26):
        nb *= 2
    return None if q8_rem_bits(k, nb) > 31 else nb


def q8_layout(kmers, taxa, tin, tout, k: int, ways: int = _Q8_WAYS,
              load_factor: float = 0.5, stash_max: int = 128,
              min_nb: int = 0):
    """Lay (kmer -> taxon) pairs out as the q8 table.

    Returns (fused uint32 [NB, 2W] — lanes [0,W): rem, [W,2W): pk —
    stash uint32 [3, S] standard (hi, lo, val-bits) rows, nb) or None when
    the layout is ineligible (rem would exceed 31 bits at the required NB,
    or Euler stamps exceed 16 bits). Deterministic: ascending canonical
    k-mers claim free lanes of their bucket in ascending lane order;
    bucket overflow goes to the stash in ascending canonical order; a
    stash overflow doubles NB (shrinking r) and restarts.

    min_nb: lower bound on the bucket count — the sharded relayout lays
    every shard at a COMMON nb so the stacked [S, NB, 2W] device array has
    uniform shape AND a single rem width (unlike the std stack_parts
    tiling trick, the q8 bucket is the TOP bits of h, so padding by
    replication would change every stored rem — a common nb is the only
    layout all shards can share).
    """
    kmers = _np.asarray(kmers, dtype=_np.uint64)
    taxa = _np.asarray(taxa, dtype=_np.int32)
    tin = _np.asarray(tin, dtype=_np.int32)
    tout = _np.asarray(tout, dtype=_np.int32)
    if int(tout.max(initial=0)) > 0xFFFF:
        return None
    n = kmers.shape[0]
    if n > 1 and not (kmers[1:] > kmers[:-1]).all():
        order = _np.argsort(kmers, kind="stable")
        kmers, taxa = kmers[order], taxa[order]
    h = q8_hash_np(kmers, k)
    nb = 8
    while nb * ways * load_factor < max(n, 1):
        nb *= 2
    while nb < min_nb:
        nb *= 2
    # A too-wide remainder is fixed by MORE buckets (r = 2k - log2 NB);
    # cap growth so k=31 (r ≤ 31 needs NB ≥ 2^31) stays ineligible.
    while q8_rem_bits(k, nb) > 31 and nb <= (1 << 26):
        nb *= 2
    while True:
        r = q8_rem_bits(k, nb)
        if r > 31:
            return None
        if r < 0:
            nb = 1 << (2 * k)      # more buckets than kmer values: clamp
            r = 0
        b = (h >> _np.uint64(r)).astype(_np.int64)
        rem = (h & _np.uint64((1 << r) - 1)).astype(_np.uint32)
        order, bs, rank, place = _bucket_rank(b, n, ways)
        over = _np.sort(order[~place])          # ascending canonical
        if over.size > stash_max and r > 0:
            nb *= 2
            continue
        fused = _np.zeros((nb, 2 * ways), dtype=_np.uint32)
        fused[:, :ways] = _EMPTY_HI             # empty rem sentinel
        ks = order[place]
        val = taxa[ks]
        pk = (tin[val].astype(_np.uint32) << _np.uint32(16)) \
            | tout[val].astype(_np.uint32)
        fused[bs[place], rank[place]] = rem[ks]
        fused[bs[place], ways + rank[place]] = pk
        if over.size:
            stash = _np.stack([
                (kmers[over] >> _np.uint64(32)).astype(_np.uint32),
                (kmers[over] & _np.uint64(0xFFFFFFFF)).astype(_np.uint32),
                taxa[over].view(_np.uint32)])
        else:
            stash = _np.zeros((3, 0), dtype=_np.uint32)
        return fused, stash, nb


def _bucket_rank(b, n: int, ways: int):
    """Shared quotient-layout placement core: for bucket indices b (in
    ascending-canonical key order), the within-bucket rank of each key and
    the placed/overflow split. Returns (order, bs, rank, place)."""
    order = _np.argsort(b, kind="stable")
    bs = b[order]
    newgrp = _np.concatenate([[True], bs[1:] != bs[:-1]]) if n else \
        _np.zeros(0, bool)
    grp = _np.cumsum(newgrp) - 1 if n else _np.zeros(0, _np.int64)
    first = _np.flatnonzero(newgrp)
    rank = _np.arange(n) - first[grp] if n else _np.zeros(0, _np.int64)
    return order, bs, rank, rank < ways


# --------------------------------------------------------------- q12 layout
# Two-lane-remainder quotient layout: covers k where the
# q8 single-lane remainder cannot fit 31 bits (k=31 needs r = 62 − log2 NB
# ≤ 31 ⇒ NB ≥ 2^31 — hopeless). A slot stores 12 bytes: rem_lo (low 32
# rem bits), rem_hi (the rest, ≤ 30 bits), and the packed Euler payload —
# same bijective mix as q8, so exactness is the same (bucket, rem) ↔ K
# argument. Geometry: 42 slots × 3 lanes + 2 pad lanes = 128 uint32 lanes
# = a 512 B power-of-two row (12·W can never be a power of two for
# uniform W, but slots-per-row need not be a power of two — only row
# BYTES must, for the gather). vs std W=16 (256 B rows, 16 slots):
# 2.6x fewer rows at equal capacity, 1.3x fewer bytes. Empty-lane
# sentinel lives in rem_hi (real rem_hi
# ≤ 2^30 − 1 < 0xFFFFFFFF).
_Q12_WAYS = 42


def _q12_row_lanes(ways: int) -> int:
    return 1 << (3 * ways - 1).bit_length()      # next pow2 ≥ 3·ways


def q12_nb_for(n: int, k: int, ways: int = _Q12_WAYS,
               load_factor: float = 0.5, min_nb: int = 0) -> int:
    """q12 bucket count: capacity growth + min_nb floor only (the two-lane
    remainder always fits: r ≤ 2k − 3 ≤ 59 < 63)."""
    nb = 8
    while nb * ways * load_factor < max(n, 1):
        nb *= 2
    while nb < min_nb:
        nb *= 2
    return nb


def _q12_split_np(h: _np.ndarray, r: int, k: int):
    """(bucket int64, rem_lo uint32, rem_hi uint32) of the q8 mix h."""
    b = (h >> _np.uint64(r)).astype(_np.int64)
    lo_bits = min(r, 32)
    rem_lo = (h & _np.uint64((1 << lo_bits) - 1)).astype(_np.uint32)
    rem_hi = ((h >> _np.uint64(32)) & _np.uint64((1 << max(r - 32, 0)) - 1)
              ).astype(_np.uint32) if r > 32 else \
        _np.zeros(h.shape, _np.uint32)
    return b, rem_lo, rem_hi


def q12_layout(kmers, taxa, tin, tout, k: int, ways: int = _Q12_WAYS,
               load_factor: float = 0.5, stash_max: int = 128,
               min_nb: int = 0):
    """Lay (kmer -> taxon) pairs out as the q12 table.

    Returns (fused uint32 [NB, RL] — lanes [0,W): rem_lo, [W,2W): rem_hi,
    [2W,3W): pk, [3W,RL): pad — stash uint32 [3, S] standard rows, nb) or
    None when Euler stamps exceed 16 bits. Same deterministic placement
    rule as q8_layout; a stash overflow doubles NB and restarts."""
    kmers = _np.asarray(kmers, dtype=_np.uint64)
    taxa = _np.asarray(taxa, dtype=_np.int32)
    tin = _np.asarray(tin, dtype=_np.int32)
    tout = _np.asarray(tout, dtype=_np.int32)
    if int(tout.max(initial=0)) > 0xFFFF:
        return None
    n = kmers.shape[0]
    if n > 1 and not (kmers[1:] > kmers[:-1]).all():
        order = _np.argsort(kmers, kind="stable")
        kmers, taxa = kmers[order], taxa[order]
    h = q8_hash_np(kmers, k)
    RL = _q12_row_lanes(ways)
    nb = q12_nb_for(n, k, ways, load_factor, min_nb)
    while True:
        r = q8_rem_bits(k, nb)
        if r < 0:
            nb = 1 << (2 * k)
            r = 0
        b, rem_lo, rem_hi = _q12_split_np(h, r, k)
        order, bs, rank, place = _bucket_rank(b, n, ways)
        over = _np.sort(order[~place])          # ascending canonical
        if over.size > stash_max and r > 0:
            nb *= 2
            continue
        fused = _np.zeros((nb, RL), dtype=_np.uint32)
        fused[:, ways:2 * ways] = _EMPTY_HI     # empty rem_hi sentinel
        ks = order[place]
        val = taxa[ks]
        pk = (tin[val].astype(_np.uint32) << _np.uint32(16)) \
            | tout[val].astype(_np.uint32)
        fused[bs[place], rank[place]] = rem_lo[ks]
        fused[bs[place], ways + rank[place]] = rem_hi[ks]
        fused[bs[place], 2 * ways + rank[place]] = pk
        if over.size:
            stash = _np.stack([
                (kmers[over] >> _np.uint64(32)).astype(_np.uint32),
                (kmers[over] & _np.uint64(0xFFFFFFFF)).astype(_np.uint32),
                taxa[over].view(_np.uint32)])
        else:
            stash = _np.zeros((3, 0), dtype=_np.uint32)
        return fused, stash, nb


def lookup_q12_jnp(hi, lo, valid, fused, stash, *, k: int,
                   ways: int = _Q12_WAYS):
    """Probe a q12 table — one row gather, two lane compares. Same
    (hit, t_in, t_out) contract and sharding story as lookup_q8_jnp."""
    nb = fused.shape[0]
    W = ways
    m = 2 * k
    r = m - (nb.bit_length() - 1)
    assert 0 <= r <= 62, "q12 table with out-of-range rem width"
    shape = hi.shape
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    valid = valid.reshape(-1)
    A = int(_Q8_A)
    if m <= 32:
        h_lo = (lo * jnp.uint32(A)) & jnp.uint32((1 << m) - 1)
        h_hi = jnp.zeros_like(h_lo)
    else:
        h_lo = lo * jnp.uint32(A)
        h_hi = (_umulh32_jnp(lo, A) + hi * jnp.uint32(A)) \
            & jnp.uint32((1 << (m - 32)) - 1)
    if r >= 32:
        b = (h_hi >> jnp.uint32(r - 32)).astype(jnp.int32)
        rem_lo = h_lo
        rem_hi = h_hi & jnp.uint32((1 << (r - 32)) - 1)
    elif r == 0:
        b = h_lo.astype(jnp.int32)               # m <= 32 whenever r == 0
        rem_lo = jnp.zeros_like(h_lo)
        rem_hi = jnp.zeros_like(h_lo)
    else:
        b = ((h_hi << jnp.uint32(32 - r)) | (h_lo >> jnp.uint32(r))) \
            .astype(jnp.int32)
        rem_lo = h_lo & jnp.uint32((1 << r) - 1)
        rem_hi = jnp.zeros_like(h_lo)

    path, chunk = lookup_path(b.shape[0], nb, fused.shape[1] * 4)
    if path == "sorted":
        # Deep table: sorted-sliced gather (see _sorted_pk).
        pk = _sorted_pk(fused, b, (rem_lo, rem_hi), valid, W, chunk)
    elif path == "chunked":
        # Chunked gather+compare+sum (see _Q8_CHUNK) — bit-identical.
        pk = _chunked_pk(fused, b, (rem_lo, rem_hi), valid, W, chunk)
    else:
        rows = fused[b]                          # [N, RL] — THE row gather
        hitlane = (valid[:, None] & (rows[:, :W] == rem_lo[:, None])
                   & (rows[:, W:2 * W] == rem_hi[:, None]))
        pk = jnp.sum(jnp.where(hitlane, rows[:, 2 * W:3 * W],
                               jnp.uint32(0)), axis=-1)
    t_in = (pk >> jnp.uint32(16)).astype(jnp.int32)
    t_out = (pk & jnp.uint32(0xFFFF)).astype(jnp.int32)
    hit = (pk != jnp.uint32(0)).astype(jnp.int32)   # see lookup_q8_jnp

    S = stash.shape[1]
    if S:                                        # full-key stash scan
        shit = (valid[:, None] & (hi[:, None] == stash[0][None, :])
                & (lo[:, None] == stash[1][None, :]))
        sv = jax.lax.bitcast_convert_type(stash[3:], jnp.int32)
        t_in = t_in + jnp.sum(jnp.where(shit, sv[0][None, :], 0), axis=-1)
        t_out = t_out + jnp.sum(jnp.where(shit, sv[1][None, :], 0), axis=-1)
        hit = hit + jnp.sum(shit.astype(jnp.int32), axis=-1)
    return (hit.reshape(shape), t_in.reshape(shape), t_out.reshape(shape))


def _umulh32_jnp(a, b_const: int):
    """High 32 bits of a (uint32 array) x b (uint32 constant) — 16-bit
    schoolbook; jnp has no widening 32-bit multiply."""
    M = jnp.uint32(0xFFFF)
    a0, a1 = a & M, a >> jnp.uint32(16)
    b0 = jnp.uint32(b_const & 0xFFFF)
    b1 = jnp.uint32(b_const >> 16)
    ll = a0 * b0
    mid = a1 * b0 + a0 * b1          # can wrap uint32: track the carry
    carry_mid = (mid < a1 * b0).astype(jnp.uint32)
    lo = ll + (mid << jnp.uint32(16))
    carry_lo = (lo < ll).astype(jnp.uint32)
    return (a1 * b1 + (mid >> jnp.uint32(16))
            + (carry_mid << jnp.uint32(16)) + carry_lo)


def lookup_q8_jnp(hi, lo, valid, fused, stash, *, k: int,
                  ways: int = _Q8_WAYS):
    """Probe a q8 table (one mesh shard's, or a monolithic one — sharded
    probing needs no owner mask: see index.shard.shard_tables_q8).

    hi/lo/valid: uint32/bool [B, P] (or flat) from extract_kmers_jnp.
    fused: uint32 [NB, 2W] q8 rows (q8_layout).
    stash: uint32 [5, S] fused overflow rows (fuse_stash; full-key rows).
    Returns (hit, t_in, t_out) int32 like hi — hit is 1 at hits, 0
    elsewhere (the q8 row carries no taxon id; the scorer recovers node
    ids from tin via tax_arrays['tin2node'] at the [B] level).
    """
    nb = fused.shape[0]
    W = ways
    m = 2 * k
    r = m - (nb.bit_length() - 1)
    assert 0 <= r <= 31, "q8 table with out-of-range rem width"
    shape = hi.shape
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    valid = valid.reshape(-1)
    # h = (K * A) mod 2^m via 32-bit limbs (m > 32) or one wrap (m <= 32).
    A = int(_Q8_A)
    if m <= 32:
        h_lo = (lo * jnp.uint32(A)) & jnp.uint32((1 << m) - 1)
        h_hi = jnp.zeros_like(h_lo)
    else:
        h_lo = lo * jnp.uint32(A)
        h_hi = (_umulh32_jnp(lo, A) + hi * jnp.uint32(A)) \
            & jnp.uint32((1 << (m - 32)) - 1)
    if r == 0:
        rem = jnp.zeros_like(h_lo)
        b = h_lo.astype(jnp.int32)           # m <= 32 whenever r == 0
    else:
        rem = h_lo & jnp.uint32((1 << r) - 1)
        b = ((h_hi << jnp.uint32(32 - r)) | (h_lo >> jnp.uint32(r))) \
            .astype(jnp.int32)

    path, chunk = lookup_path(b.shape[0], nb, fused.shape[1] * 4)
    if path == "sorted":
        # Deep table: sorted-sliced gather (see _sorted_pk),
        # bit-identical to the plain chunked gather.
        pk = _sorted_pk(fused, b, (rem,), valid, W, chunk)
    elif path == "chunked":
        # Chunked gather+compare+sum (see _Q8_CHUNK) — bit-identical.
        pk = _chunked_pk(fused, b, (rem,), valid, W, chunk)
    else:
        rows = fused[b]                      # [N, 2W] — THE row gather
        hitlane = valid[:, None] & (rows[:, :W] == rem[:, None])
        pk = jnp.sum(jnp.where(hitlane, rows[:, W:], jnp.uint32(0)),
                     axis=-1)
    t_in = (pk >> jnp.uint32(16)).astype(jnp.int32)
    t_out = (pk & jnp.uint32(0xFFFF)).astype(jnp.int32)
    # hit ⟺ pk != 0, EXACTLY: at most one lane matches (the (bucket,
    # rem) ↔ K bijection), and a stored pk is tin<<16|tout with
    # tout ≥ 1 for every real taxon (SEMANTICS §6 Euler intervals are
    # half-open with tout > tin ≥ 0 — note the ROOT has tin == 0, so it
    # is tout, not tin, that guarantees pk > 0). Computing hit from pk
    # instead of any(hitlane) drops a [N, W] pred materialization +
    # reduce from the program.
    hit = (pk != jnp.uint32(0)).astype(jnp.int32)

    S = stash.shape[1]
    if S:                                    # full-key parallel stash scan
        shit = (valid[:, None] & (hi[:, None] == stash[0][None, :])
                & (lo[:, None] == stash[1][None, :]))
        sv = jax.lax.bitcast_convert_type(stash[3:], jnp.int32)
        t_in = t_in + jnp.sum(jnp.where(shit, sv[0][None, :], 0), axis=-1)
        t_out = t_out + jnp.sum(jnp.where(shit, sv[1][None, :], 0), axis=-1)
        hit = hit + jnp.sum(shit.astype(jnp.int32), axis=-1)
    return (hit.reshape(shape), t_in.reshape(shape), t_out.reshape(shape))
