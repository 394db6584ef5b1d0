"""RefSeq-scale out-of-core build + sharded classify proof (VERDICT r1 #4).

Builds a >=500M-k-mer synthetic index (~12 GB on disk) with the out-of-core
partitioned builder — genomes streamed from a seeded generator, never held
together in RAM — then classifies a read batch against it SHARDED on the
8-virtual-CPU-device mesh and checks assignments are ancestors-or-self of
the planted truth. Records wall time and peak RSS per phase.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
     python -u experiments/build_scale.py --out IDX_DIR [--genomes 96]
     [--genome-mbp 5.5]
The defaults give ~528M distinct 21-mers (random 4-ary sequences of this
length are nearly collision-free in 4^21 space).
"""
import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, "src")

import numpy as np


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=96)
    ap.add_argument("--genome-mbp", type=float, default=5.5)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--parts-per-shard", type=int, default=8)
    ap.add_argument("--load-factor", type=float, default=0.7)
    ap.add_argument("--out", required=True)
    ap.add_argument("--reads", type=int, default=16384)
    ap.add_argument("--skip-build", action="store_true")
    args = ap.parse_args()

    from pangea_tpu.index import build_index_ooc, load_index_any
    from pangea_tpu.taxonomy import Taxonomy

    G = args.genomes
    GL = int(args.genome_mbp * 1e6)

    # --- taxonomy: genera x species over the genome set ------------------
    n_genera = max(G // 4, 1)
    T = 1 + n_genera + G            # root + genera + species
    parent = np.zeros(T + 1, dtype=np.int32)
    rank = np.zeros(T + 1, dtype=np.int8)
    names = ["unclassified", "root"]
    parent[1], rank[1] = 1, 1
    for g in range(n_genera):
        parent[2 + g] = 1
        rank[2 + g] = 7
        names.append(f"genus{g}")
    for s in range(G):
        parent[2 + n_genera + s] = 2 + (s % n_genera)
        rank[2 + n_genera + s] = 8
        names.append(f"species{s}")
    tax = Taxonomy(parent=parent, rank=rank, names=names)

    def genome_codes(i):
        rng = np.random.default_rng(1000 + i)
        return rng.integers(0, 4, size=GL, dtype=np.int8).astype(np.uint8)

    def genomes():
        for i in range(G):
            yield genome_codes(i), 2 + n_genera + i

    report = {"genomes": G, "genome_bp": GL, "shards": args.shards}
    if not args.skip_build:
        t0 = time.time()
        sidx = build_index_ooc(
            genomes(), tax, k=21, out=args.out, n_shards=args.shards,
            parts_per_shard=args.parts_per_shard,
            load_factor=args.load_factor,
            progress=lambda m: print(f"  [{time.time()-t0:7.1f}s "
                                     f"rss={rss_gb():.1f}GB] {m}",
                                     flush=True))
        report["build_sec"] = round(time.time() - t0, 1)
        report["build_peak_rss_gb"] = round(rss_gb(), 2)
        print("built:", sidx, flush=True)
    sidx = load_index_any(args.out)
    report["n_kmers"] = sidx.meta.n_kmers
    report["index_gb"] = round(sidx.nbytes / 1e9, 2)

    # --- classify sharded on the virtual mesh ----------------------------
    # Force the CPU backend via jax.config (works while no backend has
    # initialized yet): this proof runs on the virtual CPU mesh.
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu" and len(jax.devices()) >= 8, \
        "run with XLA_FLAGS=--xla_force_host_platform_device_count=8"
    from pangea_tpu.classify.engine import pad_batch
    from pangea_tpu.dist import (MeshConfig, make_mesh, place_index,
                                 make_sharded_classify_fn)
    from pangea_tpu.dist.mesh import batch_sharding

    t0 = time.time()
    mesh = make_mesh(MeshConfig(n_data=1, n_shard=8))
    di = place_index(sidx, mesh)
    fn = make_sharded_classify_fn(di.cfg, mesh)
    report["place_sec"] = round(time.time() - t0, 1)
    print(f"placed on mesh (1,8) in {report['place_sec']}s "
          f"rss={rss_gb():.1f}GB", flush=True)

    B, L = args.reads, 150
    rng = np.random.default_rng(77)
    gsel = rng.integers(0, G, size=B)
    seqs = []
    truth = np.zeros(B, dtype=np.int32)
    by_g: dict[int, list[int]] = {}
    for i, g in enumerate(gsel.tolist()):
        by_g.setdefault(g, []).append(i)
    for g, idxs in by_g.items():
        codes = genome_codes(g)
        pos = rng.integers(0, GL - L, size=len(idxs))
        for i, p in zip(idxs, pos.tolist()):
            seqs.append((i, codes[p:p + L]))
            truth[i] = 2 + n_genera + g
    seqs.sort(key=lambda x: x[0])
    bases = pad_batch([s for _, s in seqs], B, L)
    t0 = time.time()
    out = fn(di.tables, jax.device_put(bases, batch_sharding(mesh)))
    taxa = np.asarray(out["taxon"])
    report["classify_sec"] = round(time.time() - t0, 1)
    ok = tax.is_ancestor_or_self(taxa, truth) | (taxa == 0)
    report["reads"] = B
    report["pct_classified"] = round(100.0 * float((taxa != 0).mean()), 2)
    report["ancestor_consistency"] = round(float(ok.mean()), 4)
    report["exact_match_pct"] = round(
        100.0 * float((taxa == truth).mean()), 2)
    report["peak_rss_gb"] = round(rss_gb(), 2)
    print(json.dumps(report, sort_keys=True), flush=True)
    path = os.path.join(os.path.dirname(__file__), "..",
                        "docs", "scale_build_report.json")
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)


if __name__ == "__main__":
    main()
