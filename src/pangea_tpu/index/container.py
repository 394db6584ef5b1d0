"""Index container & serialization (SURVEY.md C7/C8).

The on-device layout IS the on-disk layout: a single-probe bucketized
power-of-two table (SEMANTICS.md §5 v5 — NB buckets × 32 ways) as three
dense arrays (``key_hi``/``key_lo`` uint32[NB, 32], ``val`` int32[NB, 32])
plus a tiny overflow ``stash`` (uint32 [3, n_stash] rows hi/lo/val-bits,
n_stash ≤ 128), all of which `jax.device_put` can ship to device memory
unchanged. A lookup gathers ONE contiguous bucket row and compares its
lanes, then scans the (usually empty) stash in parallel for every query —
the array replacement for a pointer/probe-chain hash table. On disk an
index is a directory::

    meta.json      header: k, w, n_buckets, ways, counts, hashes
    key_hi.npy     uint32[NB, 32]   (np.load mmap-able)
    key_lo.npy     uint32[NB, 32]
    val.npy        int32[NB, 32]
    stash.npy      uint32[3, n_stash]
    taxonomy.npz   the taxonomy the index was built against

Empty lanes carry ``key_hi == EMPTY_HI`` (0xFFFFFFFF — unreachable for valid
k-mers with k ≤ 31).
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass

import numpy as np

from ..taxonomy import Taxonomy

EMPTY_HI = np.uint32(0xFFFFFFFF)
FORMAT_VERSION = 4


@dataclass
class IndexMeta:
    k: int
    w: int                  # minimizer window (1 = every k-mer)
    n_buckets: int          # NB (power of two)
    ways: int               # lanes per bucket (32)
    n_kmers: int            # distinct k-mers stored
    n_stash: int            # overflow k-mers in the stash (≤ 128)
    taxonomy_hash: str
    semantics_version: int
    format_version: int = FORMAT_VERSION

    @property
    def size(self) -> int:
        """Total slots (NB × ways + stash)."""
        return self.n_buckets * self.ways + self.n_stash


class Index:
    """An immutable k-mer → taxon single-probe table + its taxonomy."""

    def __init__(self, meta: IndexMeta, key_hi, key_lo, val,
                 taxonomy: Taxonomy, stash=None):
        self.meta = meta
        self.key_hi = np.asarray(key_hi, dtype=np.uint32)
        self.key_lo = np.asarray(key_lo, dtype=np.uint32)
        self.val = np.asarray(val, dtype=np.int32)
        self.stash = (np.asarray(stash, dtype=np.uint32)
                      if stash is not None else np.zeros((3, 0), np.uint32))
        self.taxonomy = taxonomy

    # ------------------------------------------------------------ lookups
    def lookup_np(self, canon: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Host-side lookup (golden path). canon uint64 → taxon int32
        (0 = miss). Exactly per SEMANTICS.md §5 v5: gather the bucket row,
        compare all 32 lanes, then scan the stash."""
        from .build import bucket_of_np
        canon = np.asarray(canon, dtype=np.uint64)
        hi = (canon >> np.uint64(32)).astype(np.uint32)
        lo = (canon & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        b = bucket_of_np(canon, self.meta.n_buckets)
        out = np.zeros(canon.shape, dtype=np.int32)
        alive = np.asarray(valid, dtype=bool)
        idx = np.flatnonzero(alive)
        hitlane = ((self.key_hi[b[idx]] == hi[idx, None])
                   & (self.key_lo[b[idx]] == lo[idx, None]))
        anyhit = hitlane.any(axis=1)
        lane = np.argmax(hitlane, axis=1)
        out[idx[anyhit]] = self.val[b[idx[anyhit]], lane[anyhit]]
        if self.stash.shape[1]:
            s_hi, s_lo, s_val = self.stash
            shit = (hi[idx, None] == s_hi[None, :]) \
                & (lo[idx, None] == s_lo[None, :])
            sany = shit.any(axis=1)
            sl = np.argmax(shit, axis=1)
            out[idx[sany]] = s_val.view(np.int32)[sl[sany]]
        return out

    # -------------------------------------------------------------- serde
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump(asdict(self.meta), fh, indent=2, sort_keys=True)
        np.save(os.path.join(path, "key_hi.npy"), self.key_hi)
        np.save(os.path.join(path, "key_lo.npy"), self.key_lo)
        np.save(os.path.join(path, "val.npy"), self.val)
        np.save(os.path.join(path, "stash.npy"), self.stash)
        self.taxonomy.save(os.path.join(path, "taxonomy.npz"))

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "Index":
        with open(os.path.join(path, "meta.json")) as fh:
            meta = IndexMeta(**json.load(fh))
        if meta.format_version != FORMAT_VERSION:
            raise ValueError(
                f"{path}: index format v{meta.format_version} != "
                f"v{FORMAT_VERSION} — rebuild the index")
        mode = "r" if mmap else None
        key_hi = np.load(os.path.join(path, "key_hi.npy"), mmap_mode=mode)
        key_lo = np.load(os.path.join(path, "key_lo.npy"), mmap_mode=mode)
        val = np.load(os.path.join(path, "val.npy"), mmap_mode=mode)
        stash = np.load(os.path.join(path, "stash.npy"))
        taxonomy = Taxonomy.load(os.path.join(path, "taxonomy.npz"))
        if meta.taxonomy_hash != taxonomy.content_hash():
            raise ValueError(f"{path}: taxonomy hash mismatch — index was "
                             "built against a different taxonomy")
        return cls(meta, key_hi, key_lo, val, taxonomy, stash=stash)

    # --------------------------------------------------------------- misc
    @property
    def nbytes(self) -> int:
        return (self.key_hi.nbytes + self.key_lo.nbytes + self.val.nbytes
                + self.stash.nbytes)

    def __repr__(self) -> str:
        m = self.meta
        return (f"Index(k={m.k}, w={m.w}, slots={m.size}, kmers={m.n_kmers}, "
                f"stash={m.n_stash}, {self.nbytes/1e6:.1f} MB)")
