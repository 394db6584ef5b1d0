"""pangea_tpu — metagenomic read classification engine in JAX.

A from-scratch rebuild of the capabilities of the reference
``Bioinfo-Tools/PANGEA-plus`` pipeline (reads → k-mer decomposition →
minimizer/hash index lookup → per-read consensus/LCA scoring → reports),
built for an accelerator (an NVIDIA H100 today): dense device-resident
hash tables, fixed-shape batched XLA programs, and ``shard_map`` over a
named device mesh for index sharding / data parallelism.

Reference-parity semantics are frozen in ``docs/SEMANTICS.md`` (the
reference checkout was empty at build time — see SURVEY.md §0 — so the
golden numpy model in :mod:`pangea_tpu.golden` is the parity oracle).
"""

__version__ = "0.1.0"
SEMANTICS_VERSION = 5
