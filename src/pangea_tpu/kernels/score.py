"""On-device consensus/LCA scorer (SURVEY.md C13/C11), jnp path.

Implements SEMANTICS.md §7 with gather-light array math: the taxonomy is
dense int32 arrays (Euler tin/tout), so

- "hits vote for their subtree" is counting, for each hit position i, how
  many hit intervals contain tin_i. Euler intervals are laminar, so
  containment decomposes into two rank queries:
      pscore(i) = #{hit j : tin_j <= tin_i} - #{hit j : tout_j <= tin_i}
  (tout_j <= tin_i implies tin_j <= tin_i, so the difference counts
  exactly the intervals with tin_j <= tin_i < tout_j). Per read that is
  two sorts + two sorted-rank lookups — O(P log P) — instead of the
  [B, P, P] containment matrix (O(P^2)), which at the dense (w=1) parity
  configuration (P≈260 paired) built a 1e9-element boolean intermediate
  per 16k batch. The quadratic form is kept where it wins (pure
  elementwise compares, no sort);
- the tally + argmax over the tree collapses to a row max over hit
  positions (the maximizer of the path score is always attained at a hit
  taxon);
- per-position Euler intervals (t_in, t_out) arrive WITH the hits from the
  lookup kernel (the fused table row carries them — see lookup.fuse_table),
  because a [B, P] gather from even a tiny taxonomy array cost more than
  the compares (chosen on the earlier accelerator; unmeasured on the H100);
- the LCA-fold over tied winners uses the Euler-tour property
  LCA(set) = LCA(argmin tin, argmax tin); the pairwise LCA is computed by
  a direct deepest-common-ancestor scan over the whole taxonomy ([B, T+1]
  interval tests — gather-free) when the taxonomy is small,
  falling back to binary lifting for big taxonomies.

Bit-exactness contract: identical to `pangea_tpu.golden._score_hits`.
"""
from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp

import numpy as _np

# numpy scalar, NOT jnp (module-level jnp constants would initialize the
# XLA backend at import time — see kernels/lookup.py).
_I32_MAX = _np.int32(2**31 - 1)
# Direct [B, T+1] LCA scan below this taxonomy size; binary lifting above.
_DIRECT_LCA_MAX_TAXA = 4096
# Auto pscore rule: the quadratic [B, P, P] form (one fused elementwise
# pass) over the sort-rank form (two batched sorts) wherever its B·P²
# intermediate stays addressable. Chosen on the earlier accelerator, whose
# sorts were slow; unmeasured on the H100 (ROADMAP S5). When B·P² exceeds
# the bound, the batch is CHUNKED into ≤⌊2³¹/P²⌋-row slices and the
# quadratic runs per slice under lax.map — bit-identical, bounded
# intermediate. Sort-rank remains only for long-read buckets where P
# itself is huge (> _RANKED_MIN_P) and the quadratic's per-row P² work
# explodes.
_QUAD_PSCORE_MAX_ELEMS = 2**31
_RANKED_MIN_P = 2048


def _pscore_quadratic(t_in, t_out, hit):
    """[B, P, P] interval-containment matrix (original form): anc[b, j, i]
    = hit_j and is_ancestor_or_self(t_j, t_i). O(P^2) but gather/sort-free
    — fastest for tiny P."""
    anc = (t_in[:, :, None] <= t_in[:, None, :]) & \
          (t_in[:, None, :] < t_out[:, :, None]) & hit[:, :, None]
    return jnp.sum(anc.astype(jnp.int32), axis=1)              # [B, P]


def _pscore_ranked(t_in, t_out, hit):
    """O(P log P) pscore via sorted-rank counting (see module docstring).
    Misses are masked to the +inf sentinel so they rank after every real
    tin (tin values are < 2^31 - 1). Bit-exact: integer counts only."""
    tin_h = jnp.where(hit, t_in, _I32_MAX)
    tout_h = jnp.where(hit, t_out, _I32_MAX)
    tin_s = jax.lax.sort(tin_h, dimension=1)
    tout_s = jax.lax.sort(tout_h, dimension=1)
    rank = jax.vmap(partial(jnp.searchsorted, side="right", method="sort"))
    return (rank(tin_s, t_in) - rank(tout_s, t_in)).astype(jnp.int32)


def _pscore_quad_chunked(t_in, t_out, hit,
                         max_elems=_QUAD_PSCORE_MAX_ELEMS):
    """Quadratic pscore over row chunks of the batch: each lax.map step
    computes the [Bc, P, P] containment sum with Bc·P² ≤ max_elems.
    Bit-identical to _pscore_quadratic (integer counts, row-independent)."""
    B, P = t_in.shape
    bc = max(int(max_elems) // (P * P), 1)
    bc = 1 << (bc.bit_length() - 1)          # power of two → even chunks
    bc = min(bc, B)
    nch = -(-B // bc)
    pad = nch * bc - B

    def prep(x):
        if pad:
            x = jnp.concatenate([x, jnp.zeros((pad, P), x.dtype)])
        return x.reshape(nch, bc, P)

    out = jax.lax.map(lambda a: _pscore_quadratic(*a),
                      (prep(t_in), prep(t_out), prep(hit)))
    return out.reshape(nch * bc, P)[:B]


def pscore_form(B: int, P: int) -> str:
    """The pscore implementation the scorer traces for a [B, P] batch:
    "quadratic", "quadratic-chunked" or "sort-rank" (PANGEA_PSCORE=quad
    or =ranked forces one)."""
    impl = os.environ.get("PANGEA_PSCORE", "auto")
    if impl == "quad" or (impl == "auto"
                          and B * P * P <= _QUAD_PSCORE_MAX_ELEMS):
        return "quadratic"
    if impl == "auto" and P <= _RANKED_MIN_P:
        return "quadratic-chunked"
    return "sort-rank"


def _pscore(t_in, t_out, hit):
    form = pscore_form(*t_in.shape)
    if form == "quadratic":
        return _pscore_quadratic(t_in, t_out, hit)
    if form == "quadratic-chunked":
        return _pscore_quad_chunked(t_in, t_out, hit)
    return _pscore_ranked(t_in, t_out, hit)


def lca_pairs_jnp(u, v, parent, depth, up):
    """Vectorized pairwise LCA (SEMANTICS.md §6). 0 acts as identity.

    u, v: int32 [...]; parent/depth: int32 [T+1]; up: int32 [levels, T+1]
    binary-lifting table (up[l][t] = 2^l-th ancestor, clamped at root).
    """
    levels = up.shape[0]
    zu = u == 0
    zv = v == 0
    uu = jnp.where(zu, jnp.int32(1), u)   # substitute root; fixed up at end
    vv = jnp.where(zv, jnp.int32(1), v)
    # Equalize depths: lift the deeper one by (du - dv).
    du = depth[uu]
    dv = depth[vv]
    swap = dv > du
    a = jnp.where(swap, vv, uu)   # a is the deeper node
    b = jnp.where(swap, uu, vv)
    diff = jnp.abs(du - dv)
    for l in range(levels - 1, -1, -1):
        lift = (diff >> l) & 1
        a = jnp.where(lift == 1, up[l][a], a)
    equal = a == b
    for l in range(levels - 1, -1, -1):
        move = (~equal) & (up[l][a] != up[l][b])
        a = jnp.where(move, up[l][a], a)
        b = jnp.where(move, up[l][b], b)
    res = jnp.where(equal, a, parent[a])
    res = jnp.where(zu & zv, jnp.int32(0), jnp.where(zu, v, jnp.where(zv, u, res)))
    return res


def _lca_by_tin_direct(u, v, tin_u, tin_v, tax_arrays):
    """Gather-free pairwise LCA given the nodes' Euler tin values: the LCA
    is the deepest taxon whose [tin, tout) interval contains both tins —
    one [B, T+1] VPU scan, unique argmax (ancestors of a node form a chain
    with distinct depths). Identity rules for 0 applied at the end."""
    tin = tax_arrays["tin"]
    tout = tax_arrays["tout"]
    depth = tax_arrays["depth"]
    ca = (tin[None, :] <= tin_u[:, None]) & (tin_u[:, None] < tout[None, :]) \
        & (tin[None, :] <= tin_v[:, None]) & (tin_v[:, None] < tout[None, :])
    d = jnp.where(ca, depth[None, :], jnp.int32(-1))
    res = jnp.argmax(d, axis=1).astype(jnp.int32)
    zu = u == 0
    zv = v == 0
    return jnp.where(zu & zv, jnp.int32(0),
                     jnp.where(zu, v, jnp.where(zv, u, res)))


def _score_impl(taxon, hit, t_in, t_out, nvalid, tax_arrays,
                confidence_threshold):
    """Shared SEMANTICS.md §7 scoring core. `taxon` is the per-position
    hit-taxon array (std lookup) or None (q8 lookup — the row stores no
    taxon id and winner node ids are recovered from Euler tins at the [B]
    level). One source of truth for both entry points so the scoring rule
    can never fork between layouts."""
    pscore = jnp.where(hit, _pscore(t_in, t_out, hit), jnp.int32(0))
    best = jnp.max(pscore, axis=1)                            # [B]
    winner = hit & (pscore == best[:, None]) & (best[:, None] > 0)
    # LCA of winners = LCA(min-tin winner, max-tin winner). Extract the two
    # endpoints by pure reductions (no gathers): a tin value identifies its
    # taxon uniquely among this read's winners.
    tin_u = jnp.min(jnp.where(winner, t_in, _I32_MAX), axis=1)
    tin_v = jnp.max(jnp.where(winner, t_in, jnp.int32(-2)), axis=1)
    if taxon is not None:
        u = jnp.max(jnp.where(winner & (t_in == tin_u[:, None]), taxon, 0),
                    axis=1)
        v = jnp.max(jnp.where(winner & (t_in == tin_v[:, None]), taxon, 0),
                    axis=1)
    else:
        # u/v only gate the ==0 identity fixups in the direct scan (both
        # are zero iff the read has no winner), so has-stand-ins suffice
        # there; the lifting path recovers real node ids from tins via
        # two [B]-sized tin2node gathers ([B, P] gathers are the
        # expensive kind; [B] ones are noise).
        has = (best > 0).astype(jnp.int32)
        u = v = has
    if tax_arrays["tin"].shape[0] <= _DIRECT_LCA_MAX_TAXA:
        assigned = _lca_by_tin_direct(u, v, tin_u, tin_v, tax_arrays)
    else:
        if taxon is None:
            t2n = tax_arrays["tin2node"]
            top = jnp.int32(t2n.shape[0] - 1)
            hasb = u != 0
            u = jnp.where(hasb, t2n[jnp.clip(tin_u, 0, top)], jnp.int32(0))
            v = jnp.where(hasb, t2n[jnp.clip(tin_v, 0, top)], jnp.int32(0))
        assigned = lca_pairs_jnp(u, v, tax_arrays["parent"],
                                 tax_arrays["depth"], tax_arrays["up"])
    below = best.astype(jnp.float32) < \
        jnp.float32(confidence_threshold) * nvalid.astype(jnp.float32)
    out_taxon = jnp.where(below | (nvalid == 0), jnp.int32(0), assigned)
    return {"taxon": out_taxon, "best": best, "nvalid": nvalid}


def score_reads_jnp(hits, nvalid, tax_arrays, confidence_threshold):
    """hits: (taxon, t_in, t_out) — int32 [B, P] per-position hit taxa
    (0 = miss) and their Euler intervals (from the fused-row lookup; values
    at miss positions are arbitrary and fully masked). nvalid: int32 [B].

    tax_arrays: dict with 'tin', 'tout', 'parent', 'depth' (int32 [T+1]) and
    'up' (int32 [levels, T+1]).
    Returns dict(taxon, best, nvalid) per SEMANTICS.md §7 — integer-only
    outputs; reported confidence derives on the host (§7.7). The only float
    op is the §7.6 threshold multiply-compare (IEEE-exact everywhere).
    """
    taxon, t_in, t_out = hits
    return _score_impl(taxon, taxon != 0, t_in, t_out, nvalid, tax_arrays,
                       confidence_threshold)


def score_reads_tin_jnp(hits, nvalid, tax_arrays, confidence_threshold):
    """q8-path scorer: hits = (hit_indicator, t_in, t_out) int32 [B, P];
    same §7 rule via _score_impl with taxon=None. Bit-exact with
    score_reads_jnp given equivalent hits (tested in test_q8.py)."""
    ind, t_in, t_out = hits
    return _score_impl(None, ind != 0, t_in, t_out, nvalid, tax_arrays,
                       confidence_threshold)
