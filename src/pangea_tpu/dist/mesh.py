"""Mesh / distribution runtime (SURVEY.md C16, C12; §3.3, §3.4).

The device-side replacement for the reference's process/thread
parallelism: a 2-D named mesh ``("data", "shard")`` over the devices —

- **data** axis: read batches stream data-parallel (inference-style DP —
  no gradient sync; the reference's per-file/thread loop).
- **shard** axis: the k-mer index is the "weight"; it is hash-sharded
  (SEMANTICS.md §5.1) along this axis, the TP analog. Every device probes
  its local shard for ALL its reads; per-position hit arrays have disjoint
  support across shards, so the merge is ONE ``psum`` over the shard axis
  (SEMANTICS.md §11 — bit-exact for every mesh shape).
- Small indexes replicate instead (shard axis of size 1): the
  "replicated when small" placement of the driver spec.

Multi-host bring-up goes through ``jax.distributed.initialize`` (see
``initialize_multihost``); single-process multi-device (one host, or the
CPU-simulated 8-device mesh in tests) needs no rendezvous.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..classify.engine import ClassifyConfig, DeviceIndex, hits_single_shard
from ..index import Index
from ..kernels import score_reads_jnp

DATA_AXIS = "data"
SHARD_AXIS = "shard"


@dataclass(frozen=True)
class MeshConfig:
    n_data: int
    n_shard: int


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Multi-host rendezvous, one process per host. No-op for
    single-process runs and idempotent (safe to call when the launcher
    already initialized)."""
    if not num_processes or num_processes <= 1:
        return
    if jax.distributed.is_initialized():   # launcher already did it
        return
    kwargs = {"coordinator_address": coordinator or None,
              "num_processes": num_processes}
    if process_id is not None and process_id >= 0:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


# Device bytes one classify step holds per input base beyond the tables:
# the probe arrays (hi, lo, valid) and the three int32 hit arrays per
# k-mer position, with slack for the scorer and the input batch itself.
WORKING_BYTES_PER_BASE = 32


def batch_working_set_bytes(batch_size: int, max_read_len: int,
                            paired: bool) -> int:
    """Upper estimate of a batch's device working set (placement budget)."""
    return (batch_size * max_read_len * (2 if paired else 1)
            * WORKING_BYTES_PER_BASE)


def memory_budget(devices, override_gb: float = 0.0,
                  working_set: int = 0) -> tuple[int | None, str]:
    """Per-device byte budget for index placement and where it came from.

    override_gb > 0 (config ``mesh.per_device_hbm_budget_gb``) wins.
    Otherwise the budget is the smallest ``memory_stats()["bytes_limit"]``
    over `devices` minus the batch working set. A device that reports no
    memory stats (the CPU backend) leaves the budget at the config value:
    None when that is 0, i.e. placement is unbounded."""
    if override_gb > 0:
        return int(override_gb * (1 << 30)), "config"
    limits = []
    for d in devices:
        stats = d.memory_stats()
        if not stats or "bytes_limit" not in stats:
            return None, "config (device reports no memory stats)"
        limits.append(int(stats["bytes_limit"]))
    if not limits:
        return None, "config (no devices)"
    return max(min(limits) - int(working_set), 0), "device bytes_limit"


def choose_mesh(n_devices: int, index_bytes: int,
                per_device_hbm_budget: int | None = None) -> MeshConfig:
    """Placement policy (SURVEY.md §4.3): replicate when the index fits the
    per-device memory budget (None = unbounded), else the smallest
    power-of-two shard axis that makes each shard fit; remaining devices
    go data-parallel."""
    n_shard = 1
    while (per_device_hbm_budget is not None and n_shard < n_devices
           and index_bytes // n_shard > per_device_hbm_budget):
        n_shard *= 2
    return MeshConfig(n_data=n_devices // n_shard, n_shard=n_shard)


def make_mesh(cfg: MeshConfig, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = cfg.n_data * cfg.n_shard
    if devices.size < n:
        raise ValueError(f"need {n} devices, have {devices.size}")
    grid = devices[:n].reshape(cfg.n_data, cfg.n_shard)
    return Mesh(grid, (DATA_AXIS, SHARD_AXIS))


def place_index(index: Index, mesh: Mesh,
                confidence_threshold: float = 0.0) -> DeviceIndex:
    """Build a DeviceIndex sharded/replicated onto the mesh: table arrays
    [n_shards, S] split along the shard axis, taxonomy replicated.

    A :class:`ShardedIndex` whose file shard count matches the mesh's takes
    the streaming path: each shard is fused and shipped on demand from its
    mmap'd files (make_array_from_callback), so host RAM never holds the
    whole table — the RefSeq-scale (config 3/5) load path, and on a
    multi-host pod each host only ever touches the shards its own devices
    own."""
    from ..index.sharded import ShardedIndex
    n_shard = mesh.shape[SHARD_AXIS]
    if isinstance(index, ShardedIndex) and index.meta.n_shards == n_shard:
        import os

        from ..index.build import pick_layout
        from ..kernels.lookup import _Q8_WAYS, _Q12_WAYS
        q8w = int(os.environ.get("PANGEA_Q8_WAYS", _Q8_WAYS))
        q12w = int(os.environ.get("PANGEA_Q12_WAYS", _Q12_WAYS))
        # Same single layout decision as engine.from_index.
        pick = pick_layout(
            index.meta.n_kmers, n_shard, index.meta.k,
            int(index.taxonomy.tout.max(initial=0)),
            requested=os.environ.get("PANGEA_LAYOUT", "auto"),
            no_sub=os.environ.get("PANGEA_NSUB") is None,
            q8_ways=q8w, q12_ways=q12w)
        if pick != "std":
            return _place_sharded_streaming_quot(
                index, mesh, confidence_threshold,
                q8w if pick == "q8" else q12w, pick)
        return _place_sharded_streaming(index, mesh, confidence_threshold)
    di = DeviceIndex.from_index(index, n_shards=n_shard,
                                confidence_threshold=confidence_threshold,
                                device_put=False)
    tab_sharding = NamedSharding(mesh, P(SHARD_AXIS, None))
    rep_sharding = NamedSharding(mesh, P())
    return DeviceIndex(
        fused=jax.device_put(di.fused, tab_sharding),
        stash=jax.device_put(di.stash, tab_sharding),
        tax={k: jax.device_put(v, rep_sharding) for k, v in di.tax.items()},
        cfg=di.cfg,
    )


def _place_sharded_streaming(sidx, mesh: Mesh,
                             confidence_threshold: float) -> DeviceIndex:
    """One-shard-at-a-time fuse + device placement from the sharded on-disk
    container (bit-identical arrays to the in-RAM stack_parts+fuse path).

    RAM discipline (a callback-based path once peaked at 4x the index
    size in host RAM): shards are fused ONE at a time, shipped
    straight to the devices that own them (``device_put`` per device +
    ``make_array_from_single_device_arrays`` — no stacked host array ever
    exists), the fused temporary is freed before the next shard, and
    shards owned by no addressable device (other hosts' shards on a
    multi-host pod) are never touched. Host peak beyond the mmap'd source
    is ~one fused shard. On the CPU-sim backend "device" buffers are
    themselves host RAM, so RSS additionally counts the placed table once
    — irreducible there, absent on an accelerator where the table lands
    in device memory.

    Note: this path intentionally skips the n_sub fast-regime split
    (engine.choose_n_sub) — streamed shards are assumed RefSeq-scale,
    far beyond the 34-68 MB band where the split pays (a log line fires
    if a shard would in fact qualify)."""
    from ..index.container import EMPTY_HI
    from ..kernels.lookup import fuse_stash, fuse_table

    meta = sidx.meta
    S = meta.n_shards
    W = meta.ways
    nb_max = max(meta.shard_buckets)
    s_max = max(max(meta.shard_stash), 1)
    tin, tout = sidx.taxonomy.tin, sidx.taxonomy.tout
    packed = int(tout.max(initial=0)) <= 0xFFFF
    fused_w = 4 * W if packed else 6 * W
    from ..index.build import FAST_BYTES, FAST_ROWS
    if nb_max <= FAST_ROWS and nb_max * fused_w * 4 <= FAST_BYTES:
        import logging
        logging.getLogger(__name__).info(
            "streamed shards fit the fast-gather regime (%d rows, %.1f MB)"
            " — the n_sub split is not applied on this path", nb_max,
            nb_max * fused_w * 4 / 1e6)

    open_shard = getattr(sidx, "open_shard", lambda s: sidx.shards[s])

    def fuse_one(s: int) -> np.ndarray:
        # open_shard: fresh transient mmaps, munmapped on return — resident
        # file pages stay bounded by ~one shard across the whole placement.
        khi, klo, val, _st = open_shard(s)
        f = fuse_table(khi, klo, val, tin, tout)
        reps = nb_max // f.shape[0]
        if reps > 1:     # sub-table replication — see shard.stack_parts
            f = np.tile(f, (reps, 1))
        return f

    def stash_one(s: int) -> np.ndarray:
        st = np.asarray(open_shard(s)[3])
        if st.shape[1] < s_max:   # pad: EMPTY_HI keys never match
            pad = np.zeros((3, s_max - st.shape[1]), dtype=np.uint32)
            pad[0] = EMPTY_HI
            st = np.concatenate([st, pad], axis=1)
        return fuse_stash(st, tin, tout)

    tab_sharding = NamedSharding(mesh, P(SHARD_AXIS, None, None))
    rep_sharding = NamedSharding(mesh, P())
    dev_grid = np.asarray(mesh.devices)          # [n_data, n_shard]
    proc = jax.process_index()
    bufs_f, bufs_st = [], []
    for s in range(S):
        owners = [d for d in dev_grid[:, s] if d.process_index == proc]
        if not owners:
            continue                             # another host's shard
        f = fuse_one(s)[None]                    # [1, nb_max, fused_w]
        st = stash_one(s)[None]
        for d in owners:
            bufs_f.append(jax.device_put(f, d))
            bufs_st.append(jax.device_put(st, d))
        del f, st                                # free before next shard
    fused = jax.make_array_from_single_device_arrays(
        (S, nb_max, fused_w), tab_sharding, bufs_f)
    stash = jax.make_array_from_single_device_arrays(
        (S, 5, s_max), tab_sharding, bufs_st)
    tax = {k: jax.device_put(v, rep_sharding)
           for k, v in sidx.taxonomy.device_arrays().items()}
    cfg = ClassifyConfig(k=meta.k, n_shards=S,
                         confidence_threshold=confidence_threshold,
                         w=meta.w, ways=W)
    return DeviceIndex(fused=fused, stash=stash, tax=tax, cfg=cfg)


def _allreduce_max_int(mesh: Mesh, value: int) -> int:
    """Agree on max(value) across all processes of the mesh (no-op for
    one process). Used by the streaming quot placement so every process
    derives the SAME common bucket count even when a host can only read
    its own shard files, and so a stash-overflow restart happens on all
    hosts or none (r4 review: a one-host RuntimeError left the peers
    hanging in the collective array construction)."""
    if jax.process_count() == 1:
        return value
    sh = NamedSharding(mesh, P((DATA_AXIS, SHARD_AXIS)))
    arr = jax.make_array_from_callback(
        (mesh.size,), sh,
        lambda idx: np.array([value], dtype=np.int64))
    rep = NamedSharding(mesh, P())
    out = jax.jit(jnp.max, out_shardings=rep)(arr)
    return int(np.asarray(out))


def _place_sharded_streaming_quot(sidx, mesh: Mesh,
                                  confidence_threshold: float,
                                  ways: int,
                                  layout: str = "q8") -> DeviceIndex:
    """Streaming per-shard quotient placement (VERDICT r3 #1/#3): brings
    the 8 B/slot q8 layout (or the 12 B/slot q12 layout, for the k=31
    family) to RefSeq-scale sharded indexes — 4x (q8) / 2.6x (q12) fewer
    rows and fewer bytes per shard than the std W=16 fused rows, which is
    exactly what the round-3 row-count cliff prices.

    Same RAM discipline as _place_sharded_streaming: shards are re-laid
    ONE at a time from transient mmaps and shipped straight to their
    owner devices. Two passes: pass 1 counts each shard's keys (reads
    only the mmap'd key_hi occupancy + stash) so all shards share one
    bucket count (q8's bucket is the TOP mix bits — shards cannot be
    padded by row replication like stack_parts, they must be laid at a
    common nb); pass 2 lays out + ships. If a shard still outgrows the
    target nb (stash overflow — rare), the placement restarts at the
    bigger nb. Stashes are padded to the layout's stash_max (128) so
    device shapes are known before later shards are laid out."""
    import logging

    from ..index.container import EMPTY_HI
    from ..index.shard import extract_pairs_tables
    from ..kernels.lookup import (_q12_row_lanes, fuse_stash, q8_layout,
                                  q8_nb_for, q12_layout, q12_nb_for)

    layout_fn, nb_fn = {"q8": (q8_layout, q8_nb_for),
                        "q12": (q12_layout, q12_nb_for)}[layout]
    row_lanes = 2 * ways if layout == "q8" else _q12_row_lanes(ways)
    meta = sidx.meta
    S = meta.n_shards
    STASH_PAD = 128                       # == quotient-layout stash_max
    tin, tout = sidx.taxonomy.tin, sidx.taxonomy.tout
    open_shard = getattr(sidx, "open_shard", lambda s: sidx.shards[s])

    counts = []
    for s in range(S):
        try:
            khi, _klo, _v, st = open_shard(s)
        except OSError:
            # Multi-host pod without a shared FS: a host may only read
            # its own shards. Every shard is readable by SOME host, and
            # the max-count all-reduce below makes nb globally agreed.
            if jax.process_count() == 1:
                raise
            continue
        c = int((khi != np.uint32(EMPTY_HI)).sum())
        if st.shape[1]:
            c += int((st[0] != np.uint32(EMPTY_HI)).sum())
        counts.append(c)
    cmax = _allreduce_max_int(mesh, max(counts, default=0))
    nb = nb_fn(cmax, meta.k, ways)
    assert nb is not None, \
        (f"{layout} ineligible for k={meta.k} at {cmax} keys/shard — "
         f"pick_layout should not have routed this index here")
    logging.getLogger(__name__).info(
        "sharded %s placement: %d shards, max %d keys/shard -> common "
        "nb=%d (%.1f MB/shard fused)", layout, S, cmax, nb,
        nb * row_lanes * 4 / 1e6)

    tab_sharding = NamedSharding(mesh, P(SHARD_AXIS, None, None))
    rep_sharding = NamedSharding(mesh, P())
    dev_grid = np.asarray(mesh.devices)          # [n_data, n_shard]
    proc = jax.process_index()
    while True:                                   # restart-at-bigger-nb
        bufs_f, bufs_st = [], []
        grew = nb
        for s in range(S):
            owners = [d for d in dev_grid[:, s] if d.process_index == proc]
            if not owners:
                continue                         # another host's shard
            canon, taxa = extract_pairs_tables(*open_shard(s))
            out = layout_fn(canon, taxa, tin, tout, meta.k, ways=ways,
                            min_nb=nb)
            assert out is not None, "eligibility checked by place_index"
            f, st3, nb_s = out
            if nb_s > nb:                        # stash overflow (rare)
                grew = max(grew, nb_s)
                break                            # agree + restart below
            if st3.shape[1] < STASH_PAD:
                pad = np.zeros((3, STASH_PAD - st3.shape[1]),
                               dtype=np.uint32)
                pad[0] = EMPTY_HI
                st3 = np.concatenate([st3, pad], axis=1)
            f = f[None]                          # [1, nb, 2W]
            st = fuse_stash(st3, tin, tout)[None]
            for d in owners:
                bufs_f.append(jax.device_put(f, d))
                bufs_st.append(jax.device_put(st, d))
            del f, st, canon, taxa               # free before next shard
        # ALL processes agree on the (possibly grown) nb before the
        # collective array construction: a restart happens everywhere
        # or nowhere (_allreduce_max_int docs).
        grew = _allreduce_max_int(mesh, grew)
        if grew == nb:
            break
        logging.getLogger(__name__).info(
            "sharded %s placement: a shard outgrew nb=%d -> restarting "
            "at nb=%d (everywhere)", layout, nb, grew)
        nb = grew
        del bufs_f, bufs_st                      # free shipped buffers
    fused = jax.make_array_from_single_device_arrays(
        (S, nb, row_lanes), tab_sharding, bufs_f)
    stash = jax.make_array_from_single_device_arrays(
        (S, 5, STASH_PAD), tab_sharding, bufs_st)
    tax = {k: jax.device_put(v, rep_sharding)
           for k, v in sidx.taxonomy.device_arrays().items()}
    cfg = ClassifyConfig(k=meta.k, n_shards=S,
                         confidence_threshold=confidence_threshold,
                         w=meta.w, ways=ways, layout=layout)
    return DeviceIndex(fused=fused, stash=stash, tax=tax, cfg=cfg)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for read batches: rows split along the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS, None))


def _local_classify_broadcast(tables, bases, mate_bases,
                              cfg: ClassifyConfig, paired: bool,
                              packed_len: int):
    """Per-device classify step inside shard_map: local-shard lookup, ONE
    psum merging the disjoint per-position hit arrays over the shard axis
    (all-reduce; SEMANTICS.md §5.1, §11), then scoring. Local table
    views: fused [1, NB, 4W|6W] (tuple of such when n_sub > 1)."""
    from ..classify.engine import _shard_view, classify_reads
    t = {"fused": _shard_view(tables["fused"], 0, cfg.n_sub),
         "stash": _shard_view(tables["stash"], 0, cfg.n_sub),
         "tax": tables["tax"]}
    sid = jax.lax.axis_index(SHARD_AXIS)
    # q8/q12 hits are (hit_indicator, tin, tout) — int32 with disjoint
    # per-position support across shards (a key lives only in its owner
    # shard and the quotient bijection forbids cross-shard false
    # positives — shard.shard_tables_quot), so the psum merge is exact —
    # and stays exact per read-chunk inside classify_reads' fused chunk
    # loop (integer sum, per-read support).
    return classify_reads(
        t, bases, cfg, tables["tax"],
        mate_bases=mate_bases if paired else None, packed_len=packed_len,
        shard_id=sid, merge_hits=lambda h: jax.lax.psum(h, SHARD_AXIS))


def _local_classify_routed(tables, bases, mate_bases, cfg: ClassifyConfig,
                           paired: bool, packed_len: int,
                           cap_frac: float = 1.25):
    """EXACT-capacity all_to_all k-mer routing (VERDICT r4 #4 / DESIGN
    fact 8): instead of every shard gathering ALL N query positions
    against its local table (S-fold redundant aggregate gather work),
    each query routes to its OWNER shard (top log2 S bits of mix32 — the
    same rule the storage partition uses, index.shard.owner_of), the
    owner probes its local table, and results route back. Per-chip
    gather work drops S-fold; no psum is needed (each position is
    answered exactly once, by its owner).

    EXACTNESS under static shapes: the all_to_all needs a fixed
    per-owner capacity C = ceil(N/S · cap_frac); hash-balanced owners
    only probabilistically fit, so every (sender, owner) bin's fill is
    counted and a lax.cond falls back to the broadcast-path psum merge
    whenever ANY bin overflows — results are bit-identical either way
    (tested vs broadcast and golden across mesh shapes, both branches).
    Pad slots carry valid=False (inert through lookup by the validity
    contract). The overflow flag is OR-reduced over the whole mesh before
    the cond (agree_any): each branch runs different collectives, so
    every device must take the same one or the collectives deadlock.
    Flag: mesh.routing = "alltoall" (default "broadcast")."""
    from ..classify.engine import (_extract_probes, _probe_tables,
                                   _shard_view)
    from ..kernels import score_reads_jnp, score_reads_tin_jnp
    from ..kernels.lookup import hash32_jnp
    t = {"fused": _shard_view(tables["fused"], 0, cfg.n_sub),
         "stash": _shard_view(tables["stash"], 0, cfg.n_sub),
         "tax": tables["tax"]}
    S = cfg.n_shards
    sid = jax.lax.axis_index(SHARD_AXIS)
    hi, lo, valid = _extract_probes(bases, mate_bases, cfg, packed_len)
    shape = hi.shape
    nvalid = jnp.sum(valid.astype(jnp.int32), axis=1)
    hi, lo, valid = hi.reshape(-1), lo.reshape(-1), valid.reshape(-1)
    N = hi.shape[0]
    C = -(-N // S)
    C = int(C * cap_frac + 0.5)
    log2S = S.bit_length() - 1
    owner = (hash32_jnp(hi, lo) >> jnp.uint32(32 - log2S)).astype(jnp.int32)
    # Invalid positions route to shard 0 as padding (valid False).
    owner = jnp.where(valid, owner, 0)
    # Slot assignment: rank within owner via owner-major stable sort of
    # (owner, position); rank = position-in-sorted-run, computed by
    # comparing to run starts.
    idx = jnp.arange(N, dtype=jnp.int32)
    so, sidx = jax.lax.sort((owner, idx), num_keys=1)
    # First index of each owner's run: searchsorted on the sorted owners.
    run_start = jnp.searchsorted(so, jnp.arange(S, dtype=jnp.int32),
                                 side="left").astype(jnp.int32)
    rank_sorted = idx - run_start[so]
    overflow = agree_any(jnp.any(rank_sorted >= jnp.int32(C)))
    # Scatter each (sorted) query into its [S, C] slot grid.
    pos = so * jnp.int32(C) + jnp.minimum(rank_sorted, jnp.int32(C - 1))
    dump = jnp.zeros(S * C, jnp.uint32)
    hi_g = dump.at[pos].set(hi[sidx]).reshape(S, C)
    lo_g = dump.at[pos].set(lo[sidx]).reshape(S, C)
    va_g = jnp.zeros(S * C, jnp.bool_).at[pos].set(valid[sidx]) \
        .reshape(S, C)
    ix_g = jnp.full(S * C, -1, jnp.int32).at[pos].set(sidx).reshape(S, C)

    score = score_reads_tin_jnp if cfg.layout in ("q8", "q12") \
        else score_reads_jnp

    def routed(_):
        rhi = jax.lax.all_to_all(hi_g, SHARD_AXIS, 0, 0, tiled=True)
        rlo = jax.lax.all_to_all(lo_g, SHARD_AXIS, 0, 0, tiled=True)
        rva = jax.lax.all_to_all(va_g, SHARD_AXIS, 0, 0, tiled=True)
        # Owner-side probe: every received query is owned here, so the
        # std owner mask is a tautology (shard_id=sid) and quotient
        # layouts need none (bijection argument in shard_tables_quot).
        h = _probe_tables(t, rhi.reshape(-1), rlo.reshape(-1),
                          rva.reshape(-1), cfg, shard_id=sid)
        back = tuple(
            jax.lax.all_to_all(x.reshape(S, C), SHARD_AXIS, 0, 0,
                               tiled=True).reshape(-1) for x in h)
        # Un-route: slot (s, c) answered the query at original flat
        # position ix_g[s, c]; dump slots (-1) are dropped via a guarded
        # scatter into an N+1 buffer.
        ix = ix_g.reshape(-1)
        tgt = jnp.where(ix >= 0, ix, jnp.int32(N))
        return tuple(jnp.zeros(N + 1, x.dtype).at[tgt].set(x)[:N]
                     .reshape(shape) for x in back)

    def broadcast(_):
        h = _probe_tables(t, hi, lo, valid, cfg, shard_id=sid)
        h = jax.lax.psum(h, SHARD_AXIS)
        return tuple(x.reshape(shape) for x in h)

    hits = jax.lax.cond(overflow, broadcast, routed, None)
    return score(hits, nvalid, tables["tax"], cfg.confidence_threshold)


def agree_any(flag):
    """OR of a per-device boolean over every mesh axis (inside shard_map):
    every device gets the same value, so a lax.cond on it takes the same
    branch everywhere."""
    n = jax.lax.pmax(flag.astype(jnp.int32), (DATA_AXIS, SHARD_AXIS))
    return n > 0


def _replicate_over_data(out):
    """all_gather over the data axis so every host can fetch the [B]
    outputs in multi-process runs (tiny next to the lookup)."""
    return jax.tree.map(
        lambda x: jax.lax.all_gather(x, DATA_AXIS, axis=0, tiled=True), out)


def _tab_specs(cfg: ClassifyConfig) -> dict:
    """shard_map in_specs for one DeviceIndex.tables pytree. Table arrays
    are per-sub-table TUPLES when cfg.n_sub > 1 (engine docs — separate
    buffers keep each gather in the fast regime)."""
    tab3 = P(SHARD_AXIS, None, None)
    tab = tuple(tab3 for _ in range(cfg.n_sub)) if cfg.n_sub > 1 else tab3
    return {"fused": tab, "stash": tab,
            "tax": jax.tree.map(lambda _: P(), {"tin": 0, "tout": 0,
                                                "parent": 0, "depth": 0,
                                                "up": 0,
                                                "tin2node": 0})}


def make_multik_sharded_classify_fn(cfgs, mesh: Mesh, paired: bool = False,
                                    packed_len: int = 0,
                                    replicate_out: bool = False):
    """Fused multi-classifier step (SURVEY.md C15 on-device): classify the
    SAME read batch against every index (e.g. k=21 and k=31), merge the
    per-read assignments with the exact-rational SEMANTICS.md §9 rule
    (classify.merge.merge_multik_jnp) — all in ONE XLA program, one
    dispatch, one [B]-triple fetch per batch instead of one per index.

    cfgs: one ClassifyConfig per index. Returns
    fn(tables_tuple, bases[, mate_bases]) where tables_tuple holds each
    DeviceIndex.tables in index order (taxonomy arrays shared/replicated).
    """
    from jax import shard_map

    from ..classify.merge import merge_multik_jnp

    cfgs = tuple(cfgs)

    def local_step(tables_tuple, bases, mate_bases):
        outs = [_local_classify_broadcast(t, bases, mate_bases, c,
                                          paired, packed_len)
                for t, c in zip(tables_tuple, cfgs)]
        res = outs[0]
        for o in outs[1:]:
            res = merge_multik_jnp(res, o, tables_tuple[0]["tax"])
        if replicate_out:
            res = _replicate_over_data(res)
        return res

    tab_specs = tuple(_tab_specs(c) for c in cfgs)
    row = P() if replicate_out else P(DATA_AXIS)
    out_spec = {"taxon": row, "best": row, "nvalid": row}

    if paired:
        fn = shard_map(local_step, mesh=mesh,
                       in_specs=(tab_specs, P(DATA_AXIS, None),
                                 P(DATA_AXIS, None)),
                       out_specs=out_spec, check_vma=False)
        return jax.jit(fn)
    fn = shard_map(lambda tables, bases: local_step(tables, bases, None),
                   mesh=mesh, in_specs=(tab_specs, P(DATA_AXIS, None)),
                   out_specs=out_spec, check_vma=False)
    return jax.jit(fn)


def make_sharded_classify_fn(cfg: ClassifyConfig, mesh: Mesh,
                             paired: bool = False, packed_len: int = 0,
                             replicate_out: bool = False,
                             routing: str = "broadcast"):
    """The distributed classify step: shard_map over (data, shard) with one
    psum merging the disjoint per-position hit arrays (SEMANTICS.md §5.1,
    §11) before scoring. Returns fn(tables, bases[, mate_bases]) -> dict of
    int32 [B] outputs (replicated along shard, sharded along data). With
    packed_len=L the batch inputs are packed wire rows (engine docs).

    replicate_out=True adds one all_gather over the data axis so outputs
    are fully replicated — required in multi-process runs, where only
    fully-replicated arrays can be fetched by every host (the [B] int32
    triples are tiny, so the gather is noise next to the lookup)."""
    from jax import shard_map
    import os
    routing = os.environ.get("PANGEA_ROUTE", routing)
    if routing not in ("broadcast", "alltoall"):
        raise ValueError(f"unknown routing {routing!r}")
    local = (_local_classify_routed
             if routing == "alltoall" and cfg.n_shards > 1
             else _local_classify_broadcast)

    def local_step(tables, bases, mate_bases):
        out = local(tables, bases, mate_bases, cfg, paired, packed_len)
        if replicate_out:
            out = _replicate_over_data(out)
        return out

    tab_specs = _tab_specs(cfg)
    row = P() if replicate_out else P(DATA_AXIS)
    out_spec = {"taxon": row, "best": row, "nvalid": row}

    if paired:
        fn = shard_map(local_step, mesh=mesh,
                       in_specs=(tab_specs, P(DATA_AXIS, None),
                                 P(DATA_AXIS, None)),
                       out_specs=out_spec, check_vma=False)
        return jax.jit(fn)
    fn = shard_map(lambda tables, bases: local_step(tables, bases, None),
                   mesh=mesh, in_specs=(tab_specs, P(DATA_AXIS, None)),
                   out_specs=out_spec, check_vma=False)
    return jax.jit(fn)
