"""Classification engine (SURVEY.md C13/C5/L5): assembles the device kernels
into one jittable classify step.

Design (SURVEY.md §8.3): a batch is a fixed-shape int8 [B, L] code tensor
(pad = 4); the whole read→k-mer→lookup→tally→score path is ONE XLA program
— extraction is elementwise integer math, lookups are batched row gathers
from device memory, scoring is dense interval math. No recompilation in steady state; variable
read lengths ride the padding (SEMANTICS.md §2 makes padding semantically
inert). Sharded execution wraps the same function in shard_map (see
pangea_tpu.dist) with a single psum merge of the disjoint per-position hit
arrays (SEMANTICS.md §11).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..index import Index
from ..index.shard import shard_tables
from ..kernels import (extract_kmers_jnp, lookup_jnp, score_reads_jnp,
                       select_minimizers_jnp)


@dataclass(frozen=True)
class ClassifyConfig:
    """Static classify parameters (hashable — safe to close over in jit)."""
    k: int
    n_shards: int = 1
    confidence_threshold: float = 0.0
    w: int = 1                      # minimizer window (SEMANTICS.md §3)
    ways: int = 16                  # bucket width (index.meta.ways)
    # Sub-tables PER device shard. Round-3 in-situ measurement: splitting
    # multiplies both gather and lane-processing cost — auto is ALWAYS 1
    # now (index.build.choose_n_sub); the machinery stays for experiments
    # (PANGEA_NSUB) and the bit-exactness tests that pin the owner rule.
    n_sub: int = 1
    # Table layout: "std" = 16 B/slot fused rows (lookup_jnp);
    # "q8" = 8 B/slot quotiented-key rows (lookup_q8_jnp) — halves row
    # bytes so mid-size tables fit the fast-gather regime in ONE probe.
    # Since r4 q8 also covers sharded placement (one q8 table per mesh
    # shard, common bucket count — shard.shard_tables_q8); it requires
    # n_sub == 1, 2k − log2(NB) ≤ 31, and 16-bit Euler stamps
    # (see kernels.lookup).
    layout: str = "std"


from ..index.build import choose_n_sub  # fast-regime policy (one source)


@dataclass
class DeviceIndex:
    """Device-resident arrays for one index + taxonomy (a pytree of arrays)
    plus the static config. Taxonomy arrays are replicated; the fused table
    and stash are stacked [n_shards, ...] for placement along the mesh
    'shard' axis (fused row layout: see kernels.lookup.fuse_table)."""
    # n_sub == 1: single arrays; n_sub > 1: tuples of n_sub arrays (one
    # device buffer per sub-table — see from_index for why that matters).
    fused: jnp.ndarray    # uint32 [n_shards, NB, 4W|6W] (or tuple thereof)
    stash: jnp.ndarray    # uint32 [n_shards, 5, S] overflow (S may be 0)
    tax: dict             # tin/tout/parent/depth [T+1], up [levels, T+1]
    cfg: ClassifyConfig

    @classmethod
    def from_index(cls, index: Index, n_shards: int = 1,
                   confidence_threshold: float = 0.0,
                   device_put: bool = True,
                   n_sub: int | None = None,
                   layout: str | None = None) -> "DeviceIndex":
        """n_sub: sub-tables per shard (see ClassifyConfig.n_sub); None =
        auto (choose_n_sub; PANGEA_NSUB env overrides for experiments).
        layout: "std" | "q8" | None = auto (q8 whenever its exactness
        preconditions hold — measured >= std at every eligible size,
        DESIGN.md round-3 facts; PANGEA_LAYOUT env overrides)."""
        import os

        from ..index.build import pick_layout
        from ..kernels.lookup import (_Q8_WAYS, _Q12_WAYS, fuse_stash,
                                      fuse_table)
        if layout is None:
            layout = os.environ.get("PANGEA_LAYOUT", "auto")
        tout_max = int(index.taxonomy.tout.max(initial=0))
        q8_ways = int(os.environ.get("PANGEA_Q8_WAYS", _Q8_WAYS))
        q12_ways = int(os.environ.get("PANGEA_Q12_WAYS", _Q12_WAYS))
        no_sub = ((n_sub is None or n_sub == 1)
                  and os.environ.get("PANGEA_NSUB") is None)
        # ONE layout decision for all entry points (index.build
        # .pick_layout — explicit requests exactness-gated, auto applies
        # the measured policies).
        layout = pick_layout(
            index.meta.n_kmers, n_shards, index.meta.k, tout_max,
            requested=layout, no_sub=no_sub, q8_ways=q8_ways,
            q12_ways=q12_ways)
        if layout in ("q8", "q12"):
            return cls._from_index_quot(index, n_shards, layout,
                                        confidence_threshold, device_put)
        if n_sub is None:
            env = os.environ.get("PANGEA_NSUB")
            n_sub = int(env) if env else choose_n_sub(
                max(index.meta.n_kmers // n_shards, 1), index.meta.ways)
        total = n_shards * n_sub
        key_hi, key_lo, val, stash3 = shard_tables(index, total)
        tin, tout = index.taxonomy.tin, index.taxonomy.tout
        fused = fuse_table(key_hi, key_lo, val, tin, tout)
        stash = np.stack([fuse_stash(s, tin, tout) for s in stash3])
        if n_sub > 1:   # [total, ...] -> n_sub SEPARATE [n_shards, ...]
            # arrays (mesh shard s owns sub-shards [s*n_sub, (s+1)*n_sub),
            # so sub-table t of every shard is the stride-n_sub slice).
            # Separate device buffers are the point: a gather whose operand
            # is a slice of one stacked [n_sub, NB, FW] buffer prices at
            # the STACKED table's (rows, bytes) — measured 88M rows/s on
            # the dense parity index, i.e. the fast-regime win silently
            # evaporates (experiments/mb_gather6.py). Distinct buffers keep
            # each gather operand inside the ≤2^16-row/≤34 MB regime.
            fused = tuple(np.ascontiguousarray(fused[t::n_sub])
                          for t in range(n_sub))
            stash = tuple(np.ascontiguousarray(stash[t::n_sub])
                          for t in range(n_sub))
        tax = index.taxonomy.device_arrays()
        if device_put:
            fused = jax.device_put(fused)
            stash = jax.device_put(stash)
            tax = {k: jax.device_put(v) for k, v in tax.items()}
        cfg = ClassifyConfig(
            k=index.meta.k, n_shards=n_shards,
            confidence_threshold=confidence_threshold,
            # ways of the DEVICE tables: shard_tables re-lays the table,
            # so trust its output shape, not the on-disk header.
            w=index.meta.w, ways=int(key_hi.shape[-1]), n_sub=n_sub,
        )
        return cls(fused=fused, stash=stash, tax=tax, cfg=cfg)

    @classmethod
    def _from_index_quot(cls, index, n_shards: int, layout: str,
                         confidence_threshold: float,
                         device_put: bool) -> "DeviceIndex":
        """Quotient layouts (kernels.lookup q8/q12 sections): re-lay the
        index's (kmer, taxon) pairs as 8 B/slot (q8) or 12 B/slot (q12,
        two rem lanes — the k=31 lane) single-probe tables — one per mesh
        shard (shard.shard_tables_quot; n_shards == 1 degenerates to the
        monolithic relayout bit-identically). Host relayout of
        ~10^6-10^7 pairs is vectorized numpy, seconds."""
        import os

        from ..index.shard import shard_tables_quot
        from ..kernels.lookup import _Q8_WAYS, _Q12_WAYS, fuse_stash
        tin, tout = index.taxonomy.tin, index.taxonomy.tout
        ways = (int(os.environ.get("PANGEA_Q8_WAYS", _Q8_WAYS))
                if layout == "q8"
                else int(os.environ.get("PANGEA_Q12_WAYS", _Q12_WAYS)))
        out = shard_tables_quot(index, n_shards, ways, layout=layout)
        assert out is not None, "relayout ineligible (checked by caller)"
        fused, stash3, _nb = out                  # [S, NB, 2W], [S, 3, Sm]
        stash = np.stack([fuse_stash(stash3[s], tin, tout)
                          for s in range(n_shards)])
        tax = index.taxonomy.device_arrays()
        if device_put:
            fused = jax.device_put(fused)
            stash = jax.device_put(stash)
            tax = {k: jax.device_put(v) for k, v in tax.items()}
        cfg = ClassifyConfig(
            k=index.meta.k, n_shards=n_shards,
            confidence_threshold=confidence_threshold,
            w=index.meta.w, ways=ways, n_sub=1, layout=layout)
        return cls(fused=fused, stash=stash, tax=tax, cfg=cfg)

    @property
    def tables(self) -> dict:
        return {"fused": self.fused, "stash": self.stash, "tax": self.tax}


def _shard_view(arr, s, n_sub):
    """Slice table arrays to one mesh shard: [n_shards, ...] -> [...] —
    mapped over the per-sub-table tuple when n_sub > 1."""
    if n_sub > 1:
        return tuple(a[s] for a in arr)
    return arr[s]


def _extract_probes(bases, mate_bases, cfg: ClassifyConfig,
                    packed_len: int):
    """[B, L] codes (or packed wire rows) → (hi, lo, valid) uint32/bool
    [B, R] probe arrays, mates concatenated at the k-mer level
    (SEMANTICS.md §8)."""
    from ..kernels.encode import extract_kmers_packed_jnp
    parts = [bases] if mate_bases is None else [bases, mate_bases]
    his, los, vals = [], [], []
    for bb in parts:
        if packed_len:
            hi, lo, valid = extract_kmers_packed_jnp(bb, packed_len, cfg.k)
        else:
            hi, lo, valid = extract_kmers_jnp(bb, cfg.k)
        if cfg.w > 1:
            # SEMANTICS.md §3 v4: probe one k-mer per valid disjoint
            # window — shrinks the gather tensor [B, P] → [B, P//w].
            hi, lo, valid = select_minimizers_jnp(hi, lo, valid, cfg.w)
        his.append(hi)
        los.append(lo)
        vals.append(valid)
    hi = his[0] if len(parts) == 1 else jnp.concatenate(his, axis=1)
    lo = los[0] if len(parts) == 1 else jnp.concatenate(los, axis=1)
    valid = vals[0] if len(parts) == 1 else jnp.concatenate(vals, axis=1)
    return hi, lo, valid


def _probe_tables(tables: dict, hi, lo, valid, cfg: ClassifyConfig,
                  shard_id=0):
    """(hi, lo, valid) [B, R] → (taxon|hit, t_in, t_out) int32 [B, R] on
    ONE shard's table (layout dispatch shared by every entry point)."""
    if cfg.layout in ("q8", "q12"):
        from ..kernels.lookup import lookup_q8_jnp, lookup_q12_jnp
        lk = lookup_q8_jnp if cfg.layout == "q8" else lookup_q12_jnp
        return lk(hi, lo, valid, tables["fused"], tables["stash"],
                  k=cfg.k, ways=cfg.ways)
    if cfg.n_sub > 1:
        total = cfg.n_shards * cfg.n_sub
        hits = None
        for t in range(cfg.n_sub):
            h = lookup_jnp(hi, lo, valid, tables["fused"][t],
                           tables["stash"][t], n_shards=total,
                           shard_id=shard_id * cfg.n_sub + t,
                           ways=cfg.ways)
            hits = h if hits is None else \
                tuple(a + b for a, b in zip(hits, h))
        return hits
    return lookup_jnp(hi, lo, valid, tables["fused"], tables["stash"],
                      n_shards=cfg.n_shards, shard_id=shard_id,
                      ways=cfg.ways)


def probes_per_read(cfg: ClassifyConfig, read_len: int,
                    paired: bool) -> int:
    """Probe positions per read (mates included) for reads padded to
    read_len: one per k-mer position, or per disjoint window when w > 1."""
    P = read_len - cfg.k + 1
    NW = P // cfg.w if cfg.w > 1 else P
    return NW * (2 if paired else 1)


def _probe_rows_per_read(cfg: ClassifyConfig, bases, mate_bases,
                         packed_len: int) -> int:
    L = packed_len if packed_len else bases.shape[1]
    return probes_per_read(cfg, L, mate_bases is not None)


def _table_geometry(fused) -> tuple[int, int]:
    """(rows, uint32 lanes) of one table (the first sub-table if split)."""
    f = fused[0] if isinstance(fused, tuple) else fused
    return int(f.shape[-2]), int(f.shape[-1])


def _fused_chunk_rows(cfg: ClassifyConfig, fused, B: int,
                      R: int) -> int | None:
    """Reads per chunk when classify_reads runs the whole step per read
    chunk, or None when it runs unfused: batches within one chunk, and
    deep tables, whose sorted-sliced gather needs the WHOLE batch's probes
    in one sort (read-chunking would shrink the sort to chunk scope; the
    lookup chunks internally there). PANGEA_FUSE_CHUNK=0 turns it off."""
    from ..kernels.lookup import _DEEP_ROWS, _deep_chunk, _quot_chunk
    nb, lanes = _table_geometry(fused)
    Bc = max(_quot_chunk() // max(R, 1), 1)
    deep = (cfg.n_sub == 1 and nb > _DEEP_ROWS
            and _deep_chunk(B * R, nb, lanes * 4) is not None)
    if deep or os.environ.get("PANGEA_FUSE_CHUNK", "1") != "1" or B <= Bc:
        return None
    return Bc


def step_plan(di: "DeviceIndex", batch: int, read_len: int,
              paired: bool) -> dict:
    """What the classify step traces for a [batch, read_len] batch on one
    device's table: the layout, the lookup path ("fused-chunk": the whole
    step per read chunk, each chunk one gather; otherwise
    kernels.lookup.lookup_path's "sorted", "chunked" or "plain") and the
    pscore form."""
    from ..kernels.lookup import lookup_path
    from ..kernels.score import pscore_form
    cfg = di.cfg
    nb, lanes = _table_geometry(di.fused)
    R = probes_per_read(cfg, read_len, paired)
    rows = _fused_chunk_rows(cfg, di.fused, batch, R)
    if rows is not None:
        lookup = "fused-chunk"
    else:
        rows = batch
        lookup = lookup_path(batch * R, nb, lanes * 4,
                             min_chunk=32768 if cfg.layout == "std"
                             else 8192)[0]
    return {"layout": cfg.layout, "table_rows": nb, "row_bytes": lanes * 4,
            "probes_per_read": R, "lookup": lookup,
            "pscore": pscore_form(rows, R)}


def classify_reads(tables: dict, bases, cfg: ClassifyConfig, tax_arrays,
                   *, mate_bases=None, packed_len: int = 0, shard_id=0,
                   merge_hits=None):
    """The full read → assignment step, FUSED-CHUNKED (round 5): when the
    flat probe count exceeds the chunk budget (kernels.lookup._Q8_CHUNK),
    the WHOLE pipeline — extract, minimize, lookup, optional cross-shard
    merge, score — runs per read-chunk under one lax.map, so no [B, R]
    or [N, rows] intermediate ever materializes at batch size (the r4
    chunked-gather insight applied to the whole program: the gather loop
    already ran at the isolated-gather rate; this removes the extract/
    score traffic AROUND it from the HBM budget). Bit-exact: every stage
    is per-read, and `merge_hits` (the sharded psum) is an integer sum —
    per-chunk merging is the same sum in chunk order.

    merge_hits: optional fn applied to the hits triple BEFORE scoring
    (the shard-axis psum in sharded execution). Padded reads (chunk
    remainder) classify as garbage and are sliced off — per-read
    independence makes them inert.
    Returns dict(taxon, best, nvalid) int32 [B]."""
    from ..kernels import score_reads_tin_jnp
    score = score_reads_tin_jnp if cfg.layout in ("q8", "q12") \
        else score_reads_jnp

    def whole(bb, mb):
        hi, lo, valid = _extract_probes(bb, mb, cfg, packed_len)
        hits = _probe_tables(tables, hi, lo, valid, cfg, shard_id)
        if merge_hits is not None:
            hits = merge_hits(hits)
        nvalid = jnp.sum(valid.astype(jnp.int32), axis=1)
        return score(hits, nvalid, tax_arrays, cfg.confidence_threshold)

    B = bases.shape[0]
    R = _probe_rows_per_read(cfg, bases, mate_bases, packed_len)
    Bc = _fused_chunk_rows(cfg, tables["fused"], B, R)
    if Bc is None:
        return whole(bases, mate_bases)
    nch = -(-B // Bc)
    pad = nch * Bc - B

    def prep(x):
        if pad:
            x = jnp.concatenate(
                [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        return x.reshape((nch, Bc) + x.shape[1:])

    if mate_bases is None:
        out = jax.lax.map(lambda a: whole(a, None), prep(bases))
    else:
        out = jax.lax.map(lambda a: whole(*a),
                          (prep(bases), prep(mate_bases)))
    return jax.tree.map(
        lambda y: y.reshape((nch * Bc,) + y.shape[2:])[:B], out)


def hits_single_shard(tables: dict, bases: jnp.ndarray, cfg: ClassifyConfig,
                      shard_id=0, mate_bases=None, packed_len: int = 0):
    """bases (and optional mate_bases) → ((taxon, t_in, t_out) int32
    [B, P], nvalid int32 [B]) on ONE shard's table
    (tables["fused"]/["stash"] already sliced to this shard: [NB, 4W|6W] /
    [5, S], or tuples of n_sub such arrays — see _shard_view). Inputs are
    int8 [B, L] code matrices, or — when packed_len=L is given —
    uint32 [B, W16+W32] packed wire rows (encode.unpack_wire;
    2.5x less host→device traffic). Mates are concatenated at the k-mer
    level (SEMANTICS.md §8) BEFORE the lookup: one big gather in place of
    two half-size ones. Quotient-table
    sharding needs NO owner masking (see _probe_tables / the quotient
    bijection argument in shard.shard_tables_quot)."""
    hi, lo, valid = _extract_probes(bases, mate_bases, cfg, packed_len)
    hits = _probe_tables(tables, hi, lo, valid, cfg, shard_id)
    nvalid = jnp.sum(valid.astype(jnp.int32), axis=1)
    return hits, nvalid


def make_classify_fn(cfg: ClassifyConfig, paired: bool = False,
                     packed_len: int = 0):
    """Build the single-device classify step (n_shards must be 1).

    Returns fn(tables, bases[, mate_bases]) -> dict(taxon, best, nvalid,
    conf), jittable. With packed_len=L the inputs are packed wire rows
    (see hits_single_shard). For sharded execution use
    pangea_tpu.dist.make_sharded_classify_fn, which wraps the same kernels
    in shard_map with a psum hit merge.
    """

    def fn(tables, bases, mate_bases=None):
        t = {"fused": _shard_view(tables["fused"], 0, cfg.n_sub),
             "stash": _shard_view(tables["stash"], 0, cfg.n_sub),
             "tax": tables["tax"]}
        return classify_reads(t, bases, cfg, tables["tax"],
                              mate_bases=mate_bases,
                              packed_len=packed_len)

    if paired:
        return jax.jit(fn)
    return jax.jit(lambda tables, bases: fn(tables, bases))


def pad_batch(seqs, batch: int, length: int) -> np.ndarray:
    """Host-side: list of uint8 code arrays → int8 [batch, length] (pad=4).
    Reads longer than `length` are truncated — the pipeline buckets long
    reads into power-of-two length classes before calling this
    (pipeline.run launch_bucketed), so truncation only happens past
    input.max_long_read_len and is counted + warned there."""
    out = np.full((batch, length), 4, dtype=np.int8)
    for i, s in enumerate(seqs[:batch]):
        n = min(len(s), length)
        out[i, :n] = s[:n].astype(np.int8)
    return out
