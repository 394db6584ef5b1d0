"""Offline index builder (SURVEY.md C6).

Scans reference genomes, extracts canonical k-mers (optionally minimizer-
subsampled), LCA-merges duplicates across taxa, and lays the result out as
the single-probe bucketized table of SEMANTICS.md §5 (v5): NB buckets × 32
ways + a tiny overflow stash. Pure host-side numpy — no device involvement
(SURVEY.md §4.2). Deterministic: insertion in ascending canonical-k-mer
order.

Why single-probe: a classify lookup costs one table-row gather per PROBE,
and independent gathers did not overlap, so one wide bucket row replaced
two-choice cuckoo (semantics v3/v4); the rare overflow moves to a stash
scanned in parallel for all queries. Chosen on the earlier accelerator;
unmeasured on the H100.
"""
from __future__ import annotations

import numpy as np

from ..core import canonical_kmers, hash32_np, minimizer_mask
from ..taxonomy import Taxonomy
from .container import EMPTY_HI, Index, IndexMeta


def _kmers_of_genome(codes: np.ndarray, k: int, w: int) -> np.ndarray:
    """Distinct canonical k-mers (uint64) of one genome sequence."""
    canon, valid = canonical_kmers(codes, k)
    if w > 1:
        sel = minimizer_mask(canon, valid, w)
    else:
        sel = valid
    return np.unique(canon[sel])


def aggregate_kmers(genomes, k: int, w: int, taxonomy: Taxonomy,
                    progress=None):
    """genomes: iterable of (codes: uint8[], taxon: int).

    Returns (kmers: uint64[N] ascending, taxa: int32[N]) where taxa[i] is the
    LCA of all source taxa containing kmers[i] (SEMANTICS.md §5).
    """
    all_k: list[np.ndarray] = []
    all_t: list[np.ndarray] = []
    for n, (codes, taxon) in enumerate(genomes):
        km = _kmers_of_genome(np.asarray(codes, dtype=np.uint8), k, w)
        all_k.append(km)
        all_t.append(np.full(km.shape, int(taxon), dtype=np.int32))
        if progress and (n + 1) % 64 == 0:
            progress(n + 1)
    if not all_k:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    kmers = np.concatenate(all_k)
    taxa = np.concatenate(all_t)
    uk, ut = dedupe_lca(kmers, taxa, taxonomy)
    return uk, ut


def dedupe_lca(kmers: np.ndarray, taxa: np.ndarray, taxonomy: Taxonomy):
    """Sort (kmer, taxon) pairs by k-mer, collapse duplicate k-mers to the
    LCA of their source taxa — fully vectorized (SEMANTICS.md §5: LCA-fold
    order is immaterial; sorting each group by Euler tin lets the fold
    collapse to ONE pairwise LCA per group via Taxonomy.lca_segments).
    Returns (kmers uint64[N] ascending unique, taxa int32[N])."""
    if kmers.shape[0] == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    order = np.lexsort((taxonomy.tin[taxa], kmers))
    kmers = kmers[order]
    taxa = taxa[order]
    new = np.concatenate([[True], kmers[1:] != kmers[:-1]])
    starts = np.flatnonzero(new)
    ends = np.concatenate([starts[1:], [kmers.shape[0]]])
    uk = kmers[starts]
    ut = taxa[starts].copy()
    multi = np.flatnonzero((ends - starts) > 1)
    if multi.size:
        ut[multi] = taxonomy.lca_segments(taxa, starts[multi], ends[multi])
    return uk, ut


# Default bucket width (SEMANTICS.md §5 v5): 16 ways → a 256 B fused device
# row; power-of-two row bytes (chosen on the earlier accelerator;
# unmeasured on the H100).
WAYS = 16
STASH_MAX = 128  # overflow cap; exceeding it doubles NB and restarts

# Fast-gather regime bounds: tables up to 2^17 bucket rows (and 68 MB)
# gathered fast on the earlier accelerator whatever the row width; the
# layout policy (auto_ways / pick_layout) aims tables at this regime.
# Unmeasured on the H100 (ROADMAP S1); correctness never depends on it.
FAST_ROWS = 1 << 17
FAST_BYTES = 68 << 20


def _est_table(n: int, ways: int, load_factor: float):
    nb = 8
    while nb * ways * load_factor < max(n, 1):
        nb *= 2
    return nb, nb * ways * 16              # fused row = 16 B/slot


def _fits_fast(n: int, ways: int, load_factor: float = 0.5) -> bool:
    nb, by = _est_table(n, ways, load_factor)
    return nb <= FAST_ROWS and by <= FAST_BYTES


def choose_n_sub(n_kmers_per_shard: int, ways: int,
                 load_factor: float = 0.5) -> int:
    """Auto sub-table policy (classify side): ALWAYS 1.

    Splitting multiplies both the gather and the per-lane processing cost,
    while a single wider-bucket or q8 table reaches the same capacity with
    ONE gather. The split machinery (PANGEA_NSUB) is kept for experiments
    (ROADMAP D3)."""
    return 1


# pick_layout uses the sane-nb rule (q8_plan_sharded / _q8_sane_nb) for
# every table size.


def _q8_sane_nb(n: int, k: int, ways: int,
                load_factor: float = 0.5) -> int | None:
    """q8 bucket count when exactness is achievable WITHOUT absurd
    oversizing: the rem-width growth loop (rem ≤ 31 needs NB ≥ 2^(2k−31))
    can inflate NB far past what capacity asks for at k ≥ 23 — harmless
    while the result still sits inside the fast-row regime (tiny table),
    pathological beyond it (a 50k-key k=27 shard would get 2^23 rows /
    4.3 GB). None in the pathological case — the q12 two-lane layout or
    std covers it."""
    from ..kernels.lookup import q8_nb_for
    nb_cap = 8
    while nb_cap * ways * load_factor < max(n, 1):
        nb_cap *= 2
    nb = q8_nb_for(n, k, ways, load_factor)
    if nb is None or (nb > 2 * nb_cap and nb > FAST_ROWS):
        return None
    return nb


def q8_plan_sharded(n_kmers: int, n_shards: int, k: int, tout_max: int,
                    load_factor: float = 0.5, ways: int = 64) -> int | None:
    """Eligibility of the PER-SHARD q8 relayout (shard.shard_tables_q8):
    the expected common per-shard bucket count, or None. Unlike the
    single-shard q8_plan there is NO fast-regime size cap — at equal
    capacity the q8 table has 4x fewer rows and 2x fewer bytes than std
    W=16. Preconditions: rem ≤ 31 bits
    without absurd NB inflation (_q8_sane_nb) and 16-bit Euler stamps."""
    if tout_max > 0xFFFF:
        return None
    per = -(-max(n_kmers, 1) // max(n_shards, 1))
    return _q8_sane_nb(per, k, ways, load_factor)


def q12_plan(n_kmers: int, n_shards: int, k: int, tout_max: int,
             load_factor: float = 0.5, ways: int = 0) -> int | None:
    """Eligibility of the q12 two-lane-remainder layout (kernels.lookup
    q12 section). Preconditions (chosen on the earlier accelerator;
    unmeasured on the H100):

    - q8 cannot reach exactness sanely (k=31, and the k≥23 oversizing
      cases — _q8_sane_nb None): q8 wins at 8 B/slot wherever it is
      achievable;
    - the std table would NOT fit the fast-gather regime (inside it std
      was faster; beyond it q12 matched std speed at half the bytes);
    - 16-bit Euler stamps (pk lane)."""
    from ..kernels.lookup import _Q8_WAYS, _Q12_WAYS, q12_nb_for
    if tout_max > 0xFFFF:
        return None
    per = -(-max(n_kmers, 1) // max(n_shards, 1))
    if _q8_sane_nb(per, k, _Q8_WAYS, load_factor) is not None:
        return None
    # std wins whenever ANY of its build-side widths (auto_ways tries
    # 16 and 32) keeps the table in the fast regime. Note the CLI builds
    # W=16 by default, so a 1.05M-2.1M-k-mer k=31 index built that way
    # gets a std table beyond the regime.
    if _fits_fast(per, 16, load_factor) or _fits_fast(per, 32,
                                                      load_factor):
        return None                      # std is measured-faster there
    return q12_nb_for(per, k, ways or _Q12_WAYS, load_factor)


def pick_layout(n_kmers: int, n_shards: int, k: int, tout_max: int, *,
                requested: str = "auto", no_sub: bool = True,
                q8_ways: int = 64, q12_ways: int = 0) -> str:
    """THE device-layout decision — one source for both entry points
    (engine.DeviceIndex.from_index and dist.place_index's streaming
    branch; r4 review: the two had separately-coded gates that had
    already started to drift). Returns "std" | "q8" | "q12".

    requested: explicit layouts are gated on EXACTNESS only (an
    experiment may override the perf policy at any size — advisor r3);
    "auto" applies the policies: q8 wherever exactness is reachable
    sanely (q8 was at least as fast as std at every size on the earlier
    accelerator, at 1/4 the memory; unmeasured on the H100), then
    q12_plan for the k=31 family, then std. Raises ValueError for an
    unknown or exactness-impossible request."""
    from ..kernels.lookup import q8_nb_for
    if requested not in ("std", "q8", "q12", "auto"):
        raise ValueError(f"unknown layout {requested!r}")
    if requested in ("q8", "q12") and not no_sub:
        raise ValueError(f"{requested} layout is incompatible with "
                         "n_sub > 1 / PANGEA_NSUB")
    per = -(-max(n_kmers, 1) // max(n_shards, 1))
    if requested == "q8":
        if tout_max > 0xFFFF or q8_nb_for(per, k, q8_ways) is None:
            raise ValueError(
                "q8 layout requested but exactness is unreachable: "
                "rem > 31 bits at the capped bucket count (k=31 — use "
                "q12) or Euler stamps > 16 bits")
        return "q8"
    if requested == "q12":
        if tout_max > 0xFFFF:
            raise ValueError("q12 layout requested but Euler stamps "
                             "exceed 16 bits")
        return "q12"
    if requested == "std" or not no_sub:
        return "std"
    plan8 = q8_plan_sharded(n_kmers, n_shards, k, tout_max,
                            ways=q8_ways)
    if plan8 is not None:
        return "q8"
    if q12_plan(n_kmers, n_shards, k, tout_max,
                ways=q12_ways) is not None:
        return "q12"
    return "std"


def auto_ways(n_kmers: int, load_factor: float = 0.5) -> int:
    """Auto bucket width (build side): the smallest W ∈ {16, 32} that
    keeps the bucket count within the fast-gather row bound (≤ 2^17 rows;
    wider rows gathered at the same per-row rate up to 512 B on the
    earlier accelerator; unmeasured on the H100). Beyond
    W=32's reach, prefer the q8 layout (8 B slots) where eligible
    (engine auto policy) or mesh sharding; stay at 16 otherwise."""
    for ways in (16, 32):
        if _fits_fast(n_kmers, ways, load_factor):
            return ways
    return WAYS


def bucket_of_np(kmers: np.ndarray, nb: int) -> np.ndarray:
    """The single candidate bucket per SEMANTICS.md §4: h & (NB-1)."""
    return (hash32_np(kmers) & np.uint32(nb - 1)).astype(np.int64)


def layout_table(kmers: np.ndarray, taxa: np.ndarray,
                 load_factor: float = 0.5, ways: int = WAYS):
    """Place (kmer → taxon) pairs into the single-probe bucketized table
    (SEMANTICS.md §5 v5): ascending canonical k-mers claim free lanes of
    their bucket in ascending lane order; bucket overflow (> 32 residents)
    goes to the stash in ascending canonical order. If the stash would
    exceed STASH_MAX, NB doubles and the layout restarts.

    Returns (key_hi [NB, WAYS], key_lo [NB, WAYS], val [NB, WAYS],
    stash [3, n_stash] uint32 rows (hi, lo, val-bits), n_buckets).
    """
    kmers = np.asarray(kmers, dtype=np.uint64)
    taxa = np.asarray(taxa, dtype=np.int32)
    n = kmers.shape[0]
    if n > 1 and not (kmers[1:] > kmers[:-1]).all():
        order = np.argsort(kmers, kind="stable")
        kmers, taxa = kmers[order], taxa[order]
    hi = (kmers >> np.uint64(32)).astype(np.uint32)
    lo = (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    nb = 8
    while nb * ways * load_factor < max(n, 1):
        nb *= 2
    while True:
        out = _try_layout(hi, lo, taxa, kmers, nb, ways)
        if out is not None:
            key_hi, key_lo, val, stash = out
            return key_hi, key_lo, val, stash, nb
        nb *= 2  # SEMANTICS.md §5 step 3

    raise AssertionError("unreachable")


def _try_layout(hi, lo, taxa, kmers, nb, ways=WAYS):
    n = kmers.shape[0]
    key_hi = np.full((nb, ways), EMPTY_HI, dtype=np.uint32)
    key_lo = np.zeros((nb, ways), dtype=np.uint32)
    val = np.zeros((nb, ways), dtype=np.int32)
    b = bucket_of_np(kmers, nb)
    # kmers ascending ⇒ within a bucket, contenders appear in ascending
    # canonical order; rank = position within its bucket group.
    order = np.argsort(b, kind="stable")
    bs = b[order]
    newgrp = np.concatenate([[True], bs[1:] != bs[:-1]]) if n else \
        np.zeros(0, bool)
    grp = np.cumsum(newgrp) - 1 if n else np.zeros(0, np.int64)
    first = np.flatnonzero(newgrp)
    rank = np.arange(n) - first[grp] if n else np.zeros(0, np.int64)
    place = rank < ways
    ks = order[place]
    key_hi[bs[place], rank[place]] = hi[ks]
    key_lo[bs[place], rank[place]] = lo[ks]
    val[bs[place], rank[place]] = taxa[ks]
    over = np.sort(order[~place])  # ascending canonical order
    if over.size > STASH_MAX:
        return None
    stash = np.stack([hi[over], lo[over],
                      taxa[over].view(np.uint32)]) if over.size else \
        np.zeros((3, 0), dtype=np.uint32)
    return key_hi, key_lo, val, stash.astype(np.uint32)


def build_index(genomes, taxonomy: Taxonomy, k: int, w: int = 1,
                load_factor: float = 0.5, progress=None,
                ways: int = WAYS) -> Index:
    """Build an :class:`Index` from (codes, taxon) genome pairs.

    ways: bucket width (fused device row = 16·ways bytes); 0 = auto
    (auto_ways — widen to 32 when that keeps the table, or its n_sub=2
    halves, in the fast gather regime). 16 (256 B rows) was the optimum
    for small tables on the earlier accelerator."""
    if k % 2 == 0 or not (1 <= k <= 31):
        raise ValueError("k must be odd and 1..31 (SEMANTICS.md §2)")
    uk, ut = aggregate_kmers(genomes, k, w, taxonomy, progress=progress)
    if ways == 0:
        ways = auto_ways(int(uk.shape[0]), load_factor)
    key_hi, key_lo, val, stash, nb = layout_table(uk, ut, load_factor,
                                                  ways=ways)
    from .. import SEMANTICS_VERSION
    meta = IndexMeta(
        k=k, w=w, n_buckets=nb, ways=ways,
        n_kmers=int(uk.shape[0]),
        n_stash=int(stash.shape[1]),
        taxonomy_hash=taxonomy.content_hash(),
        semantics_version=SEMANTICS_VERSION,
    )
    return Index(meta, key_hi, key_lo, val, taxonomy, stash=stash)
