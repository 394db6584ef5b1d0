"""Config/flag system (SURVEY.md §6): dataclass config tree loaded from
JSON with ``--key.dotted=value`` CLI overrides; every run dumps its resolved
config next to its outputs for reproducibility.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class TrimCfg:
    min_qual: float = 0.0
    window: int = 4
    min_len: int = 0
    max_len: int = 0


@dataclass
class DemuxCfg:
    barcodes: list = field(default_factory=list)  # [[sample, barcode], ...]
    max_mismatch: int = 0


@dataclass
class InputCfg:
    reads: list = field(default_factory=list)        # mate-1 / single files
    mates: list = field(default_factory=list)        # mate-2 files (optional)
    samples: list = field(default_factory=list)      # per-file sample names
    batch_size: int = 4096
    max_read_len: int = 256
    # Long-read handling: reads longer than max_read_len classify EXACTLY
    # through power-of-two length buckets (max_read_len * 2^j) up to
    # max_long_read_len; anything longer is truncated WITH a warning.
    # long_reads=True forces the general (bucketing) path even when the
    # native fast path would apply; the fast path itself truncates at
    # max_read_len and reports a truncated_reads count + warning.
    long_reads: bool = False
    max_long_read_len: int = 16384


@dataclass
class ClassifyCfg:
    index: list = field(default_factory=list)  # 1 path, or 2+ for multi-k
    confidence_threshold: float = 0.0
    out_dir: str = "out"
    resume: bool = False
    # Precompile the steady-state classify program on a zeros batch before
    # streaming: a first compile costs seconds to minutes per shape, and
    # without warmup that bill lands silently inside batch 1. Compiles
    # after warmup (long-read buckets, unexpected shapes) are counted +
    # warned.
    warmup: bool = True


@dataclass
class MeshCfg:
    n_data: int = 0    # 0 = auto from jax.device_count()
    n_shard: int = 0   # 0 = auto placement policy
    # Index placement budget per device. 0 = the device's own
    # memory_stats()["bytes_limit"] minus the batch working set
    # (dist.mesh.memory_budget); > 0 overrides. A device without memory
    # stats (CPU) uses this value, and 0 there means unbounded.
    per_device_hbm_budget_gb: float = 0.0
    # Shard-axis query routing: "broadcast" (every shard probes every
    # query, one psum) or "alltoall" (exact-capacity owner routing —
    # S-fold less gather work, guarded fallback on bin overflow; see
    # dist.mesh._local_classify_routed). Env PANGEA_ROUTE overrides.
    routing: str = "broadcast"


@dataclass
class DistCfg:
    """Multi-process (multi-host) bring-up (SURVEY.md §3.4, §4.3).

    num_processes > 1 makes run_classify call jax.distributed.initialize
    before touching any device: every process must run the same CLI with
    the same config except process_id (or leave process_id -1 to take it
    from the launcher's JAX env). The mesh then spans all processes'
    devices. It is for several hosts, one process each: one process
    already drives every card of its machine, and a second JAX process on
    the same machine would open the same cards."""
    coordinator: str = ""       # "host:port" of process 0
    num_processes: int = 1
    process_id: int = -1        # -1 = let jax.distributed auto-detect


@dataclass
class RunConfig:
    input: InputCfg = field(default_factory=InputCfg)
    classify: ClassifyCfg = field(default_factory=ClassifyCfg)
    mesh: MeshCfg = field(default_factory=MeshCfg)
    trim: TrimCfg = field(default_factory=TrimCfg)
    demux: DemuxCfg = field(default_factory=DemuxCfg)
    dist: DistCfg = field(default_factory=DistCfg)


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _NESTED:
            v = _from_dict(_NESTED[f.name], v)
        kwargs[f.name] = v
    return cls(**kwargs)


_NESTED = {"input": InputCfg, "classify": ClassifyCfg, "mesh": MeshCfg,
           "trim": TrimCfg, "demux": DemuxCfg, "dist": DistCfg}


def load_config(path: str | None = None, overrides=()) -> RunConfig:
    """Load RunConfig from a JSON file, then apply dotted overrides like
    ``classify.confidence_threshold=0.1`` (values parsed as JSON when
    possible, else kept as strings; lists accept JSON syntax)."""
    data = {}
    if path:
        with open(path) as fh:
            data = json.load(fh)
    cfg = _from_dict(RunConfig, data)
    for ov in overrides:
        key, _, raw = ov.partition("=")
        if not _:
            raise ValueError(f"override {ov!r} must be key.path=value")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        if not hasattr(obj, parts[-1]):
            raise ValueError(f"unknown config key {key!r}")
        setattr(obj, parts[-1], val)
    return cfg


def dump_config(cfg: RunConfig, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2, sort_keys=True)
