"""Out-of-core index builder (SURVEY.md §8.4.6; VERDICT r1 #4).

RefSeq-scale builds (driver configs 3/5: bacterial RefSeq, +fungal+viral —
10^9-k-mer class) cannot concatenate every genome's k-mers in RAM. This is
the KMC-style partitioned counter, device-shaped on the way out:

  phase 1 (spill)   stream genomes → distinct canonical k-mers → append
                    (k-mer, taxon) records to one of S×P spill files chosen
                    by the TOP hash bits. The partition key is a superset of
                    the shard owner bits (SEMANTICS.md §5.1), so every
                    partition belongs to exactly one shard and duplicates
                    of a k-mer always land in the same partition.
  phase 2 (reduce)  per shard: load its partitions one at a time, sort +
                    LCA-fold duplicates (vectorized Euler fold —
                    Taxonomy.lca_segments; no per-k-mer Python), then lay
                    the shard's table with the exact monolithic rule and
                    write it straight to the sharded container. Peak RAM is
                    O(k-mers / n_shards), independent of total index size.

Determinism: identical output to build_index + shard_tables for the same
genome stream (per-shard k-mer sets defined by the same owner rule; the
layout rule is deterministic; LCA is order-free)."""
from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np

from ..taxonomy import Taxonomy
from .build import WAYS, _kmers_of_genome, dedupe_lca, layout_table
from ..core import hash32_np
from .sharded import (ShardedIndex, ShardedIndexMeta, save_meta, save_shard)

_REC = np.dtype([("k", "<u8"), ("t", "<i4")])


class _Spiller:
    """Buffered append-only partition files: records accumulate in RAM up
    to `buffer_bytes` across all partitions, then flush in partition order.
    """

    def __init__(self, spill_dir: str, n_parts: int,
                 buffer_bytes: int = 256 << 20):
        self.dir = spill_dir
        self.n_parts = n_parts
        self.buffer_bytes = buffer_bytes
        self.bufs: list[list[np.ndarray]] = [[] for _ in range(n_parts)]
        self.pending = 0
        self.paths = [os.path.join(spill_dir, f"part{p:04d}.bin")
                      for p in range(n_parts)]
        for p in self.paths:                       # truncate stale spills
            open(p, "wb").close()

    def add(self, part: np.ndarray, rec: np.ndarray) -> None:
        """rec: _REC records sorted by `part` (int array, same length)."""
        bounds = np.searchsorted(part, np.arange(self.n_parts + 1))
        for p in range(self.n_parts):
            lo, hi = bounds[p], bounds[p + 1]
            if hi > lo:
                self.bufs[p].append(rec[lo:hi])
        self.pending += rec.nbytes
        if self.pending >= self.buffer_bytes:
            self.flush()

    def flush(self) -> None:
        for p, chunks in enumerate(self.bufs):
            if chunks:
                with open(self.paths[p], "ab") as fh:
                    for c in chunks:
                        fh.write(c.tobytes())
                self.bufs[p] = []
        self.pending = 0

    def read_part(self, p: int) -> np.ndarray:
        return np.fromfile(self.paths[p], dtype=_REC)

    def drop_part(self, p: int) -> None:
        os.unlink(self.paths[p])


def build_index_ooc(genomes, taxonomy: Taxonomy, k: int, out: str,
                    w: int = 1, n_shards: int = 8, parts_per_shard: int = 8,
                    load_factor: float = 0.5, spill_dir: str | None = None,
                    spill_buffer_mb: int = 256, ways: int = WAYS,
                    progress=None) -> ShardedIndex:
    """Build a sharded on-disk index from (codes, taxon) genome pairs with
    bounded RAM. n_shards and parts_per_shard must be powers of two; RAM
    peak ≈ 3× the largest shard's record bytes + one shard's table."""
    if k % 2 == 0 or not (1 <= k <= 31):
        raise ValueError("k must be odd and 1..31 (SEMANTICS.md §2)")
    for name, v in (("n_shards", n_shards),
                    ("parts_per_shard", parts_per_shard)):
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name} must be a power of two")
    P = n_shards * parts_per_shard
    log2P = P.bit_length() - 1
    os.makedirs(out, exist_ok=True)
    tmp = spill_dir or tempfile.mkdtemp(prefix="pangea_spill_",
                                        dir=os.path.dirname(out) or ".")
    os.makedirs(tmp, exist_ok=True)
    spiller = _Spiller(tmp, P, buffer_bytes=spill_buffer_mb << 20)
    try:
        # ---- phase 1: spill ------------------------------------------
        n_genomes = 0
        for codes, taxon in genomes:
            km = _kmers_of_genome(np.asarray(codes, dtype=np.uint8), k, w)
            rec = np.empty(km.shape[0], dtype=_REC)
            rec["k"] = km
            rec["t"] = np.int32(int(taxon))
            if P > 1:
                part = (hash32_np(km) >> np.uint32(32 - log2P)) \
                    .astype(np.int32)
                order = np.argsort(part, kind="stable")
                spiller.add(part[order], rec[order])
            else:
                spiller.add(np.zeros(km.shape[0], np.int32), rec)
            n_genomes += 1
            if progress and n_genomes % 64 == 0:
                progress(f"spill: {n_genomes} genomes")
        spiller.flush()

        # ---- phase 2: per-shard reduce + layout ----------------------
        shard_buckets, shard_stash = [], []
        n_kmers = 0
        for s in range(n_shards):
            uks, uts = [], []
            for p in range(s * parts_per_shard, (s + 1) * parts_per_shard):
                rec = spiller.read_part(p)
                uk, ut = dedupe_lca(rec["k"].copy(), rec["t"].copy(),
                                    taxonomy)
                del rec
                uks.append(uk)
                uts.append(ut)
                spiller.drop_part(p)
            uk = np.concatenate(uks) if uks else np.zeros(0, np.uint64)
            ut = np.concatenate(uts) if uts else np.zeros(0, np.int32)
            del uks, uts
            order = np.argsort(uk, kind="stable")
            key_hi, key_lo, val, stash, nb = layout_table(
                uk[order], ut[order], load_factor, ways=ways)
            del uk, ut, order
            save_shard(out, s, key_hi, key_lo, val, stash)
            shard_buckets.append(nb)
            shard_stash.append(int(stash.shape[1]))
            n_kmers += int((key_hi != np.uint32(0xFFFFFFFF)).sum()
                           + stash.shape[1])
            if progress:
                progress(f"shard {s}: {nb} buckets, "
                         f"stash {stash.shape[1]}")
            del key_hi, key_lo, val, stash
    finally:
        if spill_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    from .. import SEMANTICS_VERSION
    meta = ShardedIndexMeta(
        k=k, w=w, ways=ways, n_shards=n_shards, n_kmers=n_kmers,
        shard_buckets=shard_buckets, shard_stash=shard_stash,
        taxonomy_hash=taxonomy.content_hash(),
        semantics_version=SEMANTICS_VERSION)
    save_meta(out, meta, taxonomy)
    return ShardedIndex.load(out)
