"""Benchmark harness (SURVEY.md C23, §7): device step time of the classify
program.

- :func:`run_bench` — the headline: a config-2-like world (48 species,
  100k paired 150 bp reads), a w=8 minimizer index replicated on one
  device, steady-state reads/s of the device step plus golden bit-parity.
- :func:`run_bench_extras` — the dense (w=1) index and a deep table
  (~17M k-mers, beyond the plain-gather row bound) on the same harness.
- :func:`time_index` — the step time of a built index on real reads
  (``pangea-tpu bench --index``), with the trace-time step plan.

Timing: one warm-up call compiles; then the host clock runs around
``iters`` steady-state calls ended by ``jax.block_until_ready``. Every
result names the device it ran on. ``vs_baseline`` divides by an HBM
roofline built from the device's published peak bandwidth in
:data:`PEAK_HBM_BYTES_PER_SEC`; a device missing from that table is an
error, never a default.
"""
from __future__ import annotations

import time

import numpy as np

# Published peak HBM bandwidth per device, keyed by jax device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 80 GB: 3.35 TB/s.
PEAK_HBM_BYTES_PER_SEC = {"NVIDIA H100 80GB HBM3": 3.35e12}


def peak_hbm_bytes_per_sec(device_kind: str) -> float:
    """The device's published HBM bandwidth; ValueError when unknown."""
    try:
        return PEAK_HBM_BYTES_PER_SEC[device_kind]
    except KeyError:
        raise ValueError(
            f"no published HBM peak for device kind {device_kind!r}: add it "
            f"to PEAK_HBM_BYTES_PER_SEC with its source") from None


def device_info() -> dict:
    """platform, device_kind and count of the devices JAX runs on."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def time_step(fn, args, iters: int = 10):
    """(compile_sec, step_sec, out): the first call (trace + compile +
    run) timed alone, then the mean of `iters` steady-state calls."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    compile_sec = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return compile_sec, (time.perf_counter() - t0) / iters, out


def make_bench_world(n_reads=100_000, read_len=150, paired=True,
                     n_species=48, genome_len=50_000, k=21, seed=0):
    """Config-2-scale synthetic world: 48-species reference (2 phyla x 8
    genera x 3 species), reads with planted truth, dense k=21 index."""
    from .index import build_index
    from .utils import datagen
    per_genus = 3
    genera = max(n_species // per_genus // 2, 1)
    tax = datagen.make_taxonomy(n_phyla=2, genera_per_phylum=genera,
                                species_per_genus=per_genus, seed=seed)
    genomes = datagen.make_genomes(tax, genome_len=genome_len,
                                   seed=seed + 1)
    idx = build_index(genomes, tax, k=k, ways=0)
    rs = datagen.sample_reads(genomes, n_reads, read_len=read_len,
                              paired=paired, n_prob=0.005, seed=seed + 2)
    return tax, genomes, idx, rs


def run_scaling_bench(n_devices=(1, 2, 4, 8), per_device_batch=2048,
                      read_len=150, k=21, w=8, axis="data",
                      iters=10) -> dict:
    """Weak-scaling harness: fixed per-device batch, growing mesh.

    axis="data": reads scale out, index replicated (communication-free).
    axis="shard": index hash-sharded, one psum merges disjoint hits."""
    import jax

    from .classify.engine import pad_batch
    from .dist import MeshConfig, make_mesh, place_index
    from .dist.mesh import batch_sharding, make_sharded_classify_fn
    from .index import build_index

    dev = device_info()
    tax, genomes, _, rs = make_bench_world(n_reads=20_000,
                                           read_len=read_len)
    idx = build_index(genomes, tax, k=k, w=w)
    results = []
    base = None
    for n in n_devices:
        if n > len(jax.devices()):
            break
        mcfg = (MeshConfig(n_data=n, n_shard=1) if axis == "data"
                else MeshConfig(n_data=1, n_shard=n))
        mesh = make_mesh(mcfg, devices=jax.devices()[:n])
        di = place_index(idx, mesh, 0.0)
        fn = make_sharded_classify_fn(di.cfg, mesh, paired=True)
        B = per_device_batch * (n if axis == "data" else 1)
        reps = (B + len(rs.seqs) - 1) // len(rs.seqs)
        sh = batch_sharding(mesh)
        d1 = jax.device_put(pad_batch((rs.seqs * reps)[:B], B, read_len), sh)
        d2 = jax.device_put(pad_batch((rs.mates * reps)[:B], B, read_len),
                            sh)
        _, step, _ = time_step(fn, (di.tables, d1, d2), iters)
        rps = B / step
        if base is None:
            base = rps / n if axis == "data" else rps
        eff = (rps / (base * n)) if axis == "data" else (rps / base)
        results.append({"devices": n, "batch": B, "step_ms": step * 1e3,
                        "reads_per_sec": rps,
                        "weak_scaling_eff" if axis == "data" else
                        "speedup_vs_1": eff})
    return {"axis": axis, "per_device_batch": per_device_batch,
            "device": dev, "points": results}


def _golden_parity(out, index, rs, n: int, threshold: float,
                   paired: bool = True) -> bool:
    """Bit-parity of device outputs vs the golden oracle on n reads."""
    from .golden import classify_reads_golden
    gold = classify_reads_golden(rs.seqs[:n], index, threshold,
                                 mates=rs.mates[:n] if paired else None)
    got = np.stack([np.asarray(out[k])[:n]
                    for k in ("taxon", "best", "nvalid")], axis=1)
    want = np.array([(g.taxon, g.best, g.nvalid) for g in gold])
    return bool(np.array_equal(got, want))


def _ancestor_consistency(tax, taxa, truth) -> float:
    taxa = np.asarray(taxa)
    return float(((taxa == truth)
                  | tax.is_ancestor_or_self(np.abs(taxa), truth)).mean())


def _measure_index(idx, rs, batch, read_len, paired, iters):
    import jax

    from .classify.engine import DeviceIndex, make_classify_fn, pad_batch
    di = DeviceIndex.from_index(idx, confidence_threshold=0.0)
    fn = make_classify_fn(di.cfg, paired=paired)
    args = [di.tables,
            jax.device_put(pad_batch(rs.seqs[:batch], batch, read_len))]
    if paired:
        args.append(jax.device_put(pad_batch(rs.mates[:batch], batch,
                                             read_len)))
    compile_sec, step, out = time_step(fn, tuple(args), iters)
    return di, compile_sec, step, out


def run_bench(n_reads=100_000, batch=16_384, read_len=150, iters=10,
              minimizer_w=8, parity_reads=2048) -> dict:
    """Headline: steady-state device throughput of the w=8 minimizer
    config (SEMANTICS.md §3) + golden bit-parity on `parity_reads`."""
    dev = device_info()
    bw = peak_hbm_bytes_per_sec(dev["kind"])    # fails before any work
    from .index import build_index
    tax, genomes, idx_dense, rs = make_bench_world(n_reads=n_reads,
                                                   read_len=read_len)
    idx = build_index(genomes, tax, k=idx_dense.meta.k, w=minimizer_w)
    di, compile_sec, step, out = _measure_index(idx, rs, batch, read_len,
                                                True, iters)
    reads_per_sec = batch / step
    n_par = min(parity_reads, batch)
    parity = _golden_parity(out, idx, rs, n_par, 0.0)
    # HBM roofline: each probed position fetches one fused bucket row.
    k = idx.meta.k
    rows_per_read = 2 * ((read_len - k + 1) // max(minimizer_w, 1))
    f0 = di.fused[0] if isinstance(di.fused, tuple) else di.fused
    row_bytes = int(f0.shape[-1]) * 4
    roofline = bw / (rows_per_read * row_bytes)
    return {
        "metric": ("reads/sec/device (paired-end 16S classify, "
                   "config-2-like, minimizer w=%d)" % minimizer_w),
        "value": reads_per_sec,
        "unit": "reads/s/device",
        "vs_baseline": reads_per_sec / roofline,
        "device": dev,
        "detail": {
            "batch": batch, "read_len": read_len, "k": k,
            "minimizer_w": minimizer_w, "step_ms": step * 1e3,
            "compile_sec": compile_sec, "row_bytes": row_bytes,
            "rows_per_read": rows_per_read,
            "roofline_reads_per_sec": roofline,
            "ancestor_consistency": _ancestor_consistency(
                tax, out["taxon"], rs.truth[:batch]),
            "parity_vs_golden": parity, "parity_reads": n_par,
            "index": repr(idx),
        },
    }


def run_bench_extras(n_reads=100_000, batch=16_384, read_len=150,
                     iters=10, parity_reads=2048) -> dict:
    """The dense (w=1) parity index on the headline world, and a deep
    table (24 species x 700 kb, ~17M k-mers) with single-end reads."""
    from .index import build_index
    from .utils import datagen
    dev = device_info()
    tax, genomes, idx_dense, rs = make_bench_world(n_reads=n_reads,
                                                   read_len=read_len)
    di, compile_sec, step, out = _measure_index(idx_dense, rs, batch,
                                                read_len, True, iters)
    n_par = min(parity_reads, batch)
    res = {
        "device": dev,
        "dense_reads_per_sec": batch / step,
        "dense_step_ms": step * 1e3,
        "dense_compile_sec": compile_sec,
        "dense_ancestor_consistency": _ancestor_consistency(
            tax, out["taxon"], rs.truth[:batch]),
        "dense_parity_vs_golden": _golden_parity(out, idx_dense, rs, n_par,
                                                 0.0),
        "dense_index": repr(idx_dense),
        "dense_layout": di.cfg.layout,
    }
    tax_b = datagen.make_taxonomy(n_phyla=2, genera_per_phylum=8,
                                  species_per_genus=3, seed=31)
    genomes_b = list(datagen.make_genomes(tax_b, genome_len=700_000,
                                          seed=32))[:24]
    rs_b = datagen.sample_reads(genomes_b, batch, read_len=read_len,
                                paired=False, n_prob=0.005, seed=33)
    idx_b = build_index(genomes_b, tax_b, k=21, w=1)
    di_b, compile_b, step_b, out_b = _measure_index(idx_b, rs_b, batch,
                                                    read_len, False, iters)
    f0 = di_b.fused[0] if isinstance(di_b.fused, tuple) else di_b.fused
    res.update({
        "deep_reads_per_sec": batch / step_b,
        "deep_step_ms": step_b * 1e3,
        "deep_compile_sec": compile_b,
        "deep_table_rows": int(f0.shape[-2]),
        "deep_table_bytes": int(f0.nbytes),
        "deep_n_kmers": idx_b.meta.n_kmers,
        "deep_ancestor_consistency": _ancestor_consistency(
            tax_b, out_b["taxon"], rs_b.truth[:batch]),
        "deep_parity_vs_golden": _golden_parity(out_b, idx_b, rs_b, n_par,
                                                0.0, paired=False),
    })
    return res


def time_index(index_path, reads, batch: int, max_read_len: int,
               confidence_threshold: float = 0.0, iters: int = 10,
               out_npz: str | None = None) -> dict:
    """Step time of a built index on the first `batch` single-end records
    of a FASTA/FASTQ file, on one device, through the same sharded step
    the pipeline runs. out_npz: where to save that batch's (taxon, best,
    nvalid)."""
    import jax

    from .classify.engine import pad_batch, step_plan
    from .dist import MeshConfig, make_mesh, place_index
    from .dist.mesh import batch_sharding, make_sharded_classify_fn
    from .index import load_index_any
    from .io import read_batches

    dev = device_info()
    first = next(read_batches(reads, batch))
    mesh = make_mesh(MeshConfig(1, 1))
    bases = jax.device_put(pad_batch(first.seqs, batch, max_read_len),
                           batch_sharding(mesh))
    di = place_index(load_index_any(index_path), mesh, confidence_threshold)
    fn = make_sharded_classify_fn(di.cfg, mesh)
    compile_sec, step, out = time_step(fn, (di.tables, bases), iters)
    if out_npz:
        np.savez(out_npz, **{k: np.asarray(v)[:len(first)]
                             for k, v in out.items()})
    return {"device": dev, "batch": batch, "reads": len(first),
            "step_ms": step * 1e3, "compile_sec": compile_sec,
            "device_reads_per_sec": batch / step,
            "plan": step_plan(di, batch, max_read_len, False)}
