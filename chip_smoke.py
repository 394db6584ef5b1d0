#!/usr/bin/env python
"""Smoke run of pangea-tpu on NVIDIA GPUs through the user's entry points.

    python chip_smoke.py               # one card: config2, multik, deep
    python chip_smoke.py --four-cards  # the sharded deep index on four cards

Every step is a ``pangea-tpu`` CLI call (gen-testdata -> build -> classify
-> report) in a child process with ``JAX_PLATFORMS=cuda``, one at a time,
so that exactly one process holds the card and a machine without a GPU is
an error, not a CPU run. The children share the compile cache
(``$JAX_COMPILATION_CACHE_DIR``, else ``<repo>/.jax_cache``). This parent
never imports JAX: it checks each phase's outputs with the numpy golden
model (bit-exact taxon/best/nvalid on the first 2,048 reads) and the planted
truth. A failed phase fails the run. Work files go to ``<repo>/.smoke``.

One-card phases:
- config2: 100,000 paired 150 bp reads over a 48-species x 50 kb world,
  k=21 w=8 and k=21 w=1 indexes, configs/config2_16s_paired.json;
- multik: k=21 and k=31 indexes over that world, 1,000,000 single-end
  reads, fused multi-k classify with configs/config4_multik.json;
- deep: the same tree at 700 kb per species (~33M k-mers, a deep q8
  table), 1,000,000 single-end reads, configs/config3_shotgun_sharded.json;
  then the device step time of the sorted and the plain chunked lookup on
  that table (``pangea-tpu bench --index``), checked bit-identical.

``--four-cards`` builds the deep index as a 4-shard container and checks
the assignment TSVs of mesh (1 data x 4 shard) with broadcast and with
all_to_all routing, and of mesh (4 x 1), byte for byte against a one-card
run of the same reads and index.

Every number printed sits on a line that names the card and its power
limit. The last line is the JSON contract
{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")
WORK = os.path.join(REPO, ".smoke")
PARITY_READS = 2048
CHILD_TIMEOUT = 1100           # seconds; a hung child is killed
C2_READS = 100_000             # paired, config 2
C2_GENOME_LEN = 50_000
MULTIK_READS = 1_000_000       # single-end, config 4 cut from 10M
DEEP_GENOME_LEN = 700_000      # ~33M k=21 k-mers
DEEP_READS = 1_000_000         # single-end, config 3
DEEP_BATCH = 262_144           # config 3's batch_size
DEEP_OVERRIDES = ()            # extra classify overrides for the deep runs
# The world of configs 2 and 4 (matches pangea_tpu.bench.make_bench_world).
TREE = ["--n-phyla", "2", "--genera-per-phylum", "8",
        "--species-per-genus", "3", "--seed", "0"]
CARD = "?"                     # "<name>, <power limit>" once known


class SmokeError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def _card() -> str:
    """The cards' names and power limits, as nvidia-smi reports them (one
    line per card; identical lines are counted)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except FileNotFoundError:
        raise SmokeError("no NVIDIA GPU: nvidia-smi is not installed")
    if r.returncode != 0 or not r.stdout.strip():
        raise SmokeError(f"no NVIDIA GPU: nvidia-smi failed: "
                         f"{(r.stderr or r.stdout).strip()[-500:]}")
    lines = [x.strip() for x in r.stdout.strip().splitlines()]
    return "; ".join(f"{x} x{lines.count(x)}" if lines.count(x) > 1 else x
                     for x in dict.fromkeys(lines))


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cuda"
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env.update(extra)
    return env


def _run(name: str, argv: list, **env_extra) -> str:
    """Run one child to completion; its stderr goes to a log file whose
    tail is shown when it fails. Returns its stdout."""
    log = os.path.join(WORK, f"{name}.log")
    with open(log, "w") as err:
        try:
            r = subprocess.run(argv, env=_env(**env_extra), cwd=REPO,
                               stdout=subprocess.PIPE, stderr=err,
                               text=True, timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            raise SmokeError(f"{name}: killed after {CHILD_TIMEOUT} s")
    if r.returncode != 0:
        with open(log) as fh:
            tail = fh.read()[-3000:]
        raise SmokeError(f"{name}: exit {r.returncode}\n{tail}")
    return r.stdout


def _cli(name: str, *args, **env_extra) -> str:
    return _run(name, [sys.executable, "-m", "pangea_tpu.cli", *args],
                **env_extra)


_PROBE = """
import json, jax, jaxlib
d = jax.devices()
print(json.dumps({"jax": jax.__version__, "jaxlib": jaxlib.__version__,
                  "devices": [str(x) for x in d], "platform": d[0].platform,
                  "kind": d[0].device_kind, "count": len(d)}))
"""


def _probe() -> dict:
    try:
        out = _run("probe", [sys.executable, "-c", _PROBE])
    except SmokeError as e:
        raise SmokeError(f"JAX found no GPU (JAX_PLATFORMS=cuda): {e}")
    dev = json.loads(out.strip().splitlines()[-1])
    if dev["platform"] != "gpu":
        raise SmokeError(f"JAX found no GPU: platform {dev['platform']!r}")
    return dev


# ----------------------------------------------------------------- checks
def _summary(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "run_summary.json")) as fh:
        s = json.load(fh)
    dev = s["device"]
    if dev["platform"] != "gpu":
        raise SmokeError(f"{out_dir}: ran on {dev['platform']}, not gpu")
    if not dev["native_ingest"]:
        raise SmokeError(f"{out_dir}: the native ingest path did not run")
    return s


def _tsv_rows(path: str, n: int | None = None):
    """(taxon, best, nvalid) int64 [n, 3] from an assignment TSV."""
    import numpy as np
    rows = []
    with open(path, "rb") as fh:
        for i, line in enumerate(fh):
            if n is not None and i >= n:
                break
            f = line.split(b"\t")
            best, nvalid = f[5].split(b"/")
            rows.append((int(f[2]), int(best), int(nvalid)))
    return np.array(rows, dtype=np.int64).reshape(-1, 3)


def _golden(index_dirs, reads: str, mates, threshold: float):
    """Golden (taxon, best, nvalid) of the first PARITY_READS records;
    two indexes are merged by the multi-k rule (SEMANTICS.md §9)."""
    import itertools

    import numpy as np

    from pangea_tpu.golden import (classify_reads_golden,
                                   merge_multik_golden)
    from pangea_tpu.index import load_index_any
    from pangea_tpu.io import FastxReader

    def first(path):
        return [c for _, c, _ in itertools.islice(FastxReader(path),
                                                  PARITY_READS)]
    seqs = first(reads)
    mseqs = first(mates) if mates else None
    res = None
    for d in index_dirs:
        idx = load_index_any(d)
        r = classify_reads_golden(seqs, idx, threshold, mates=mseqs)
        res = r if res is None else [
            merge_multik_golden(a, b, idx.taxonomy) for a, b in zip(res, r)]
    return np.array([(g.taxon, g.best, g.nvalid) for g in res],
                    dtype=np.int64)


def _consistency(index_dir: str, tsv: str, truth_npy: str):
    """(fraction classified, fraction of classified reads whose taxon is
    the planted truth or one of its ancestors), over all reads."""
    import numpy as np

    from pangea_tpu.taxonomy import Taxonomy
    tax = Taxonomy.load(os.path.join(index_dir, "taxonomy.npz"))
    taxa = _tsv_rows(tsv)[:, 0]
    truth = np.load(truth_npy)
    if taxa.shape != truth.shape:
        raise SmokeError(f"{tsv}: {taxa.size} rows for {truth.size} reads")
    cls = taxa != 0
    ok = tax.is_ancestor_or_self(taxa[cls], truth[cls])
    return float(cls.mean()), float(ok.mean()) if cls.any() else 0.0


def _check_parity(name: str, got, want) -> None:
    bad = (got[:len(want)] != want).any(axis=1)
    if got.shape[0] < len(want) or bad.any():
        i = int(bad.argmax()) if bad.any() else got.shape[0]
        raise SmokeError(f"{name}: device output differs from the golden "
                         f"model (first mismatch at read {i})")


# ----------------------------------------------------------------- phases
def _gen(out: str, reads: int, genome_len: int, paired: bool) -> None:
    _cli(f"gen-{os.path.basename(out)}", "gen-testdata", "--out", out,
         "--bulk", "--reads", str(reads), "--read-len", "150",
         "--genome-len", str(genome_len), *TREE,
         *(["--paired"] if paired else []))


def _build(name: str, world: str, out: str, k: int, *extra) -> None:
    _cli(name, "build", "--refs", f"{world}/refs.fasta", "--taxonomy",
         f"{world}/taxonomy.tsv", "--k", str(k), "--out", out, *extra)


def _classify(name: str, config: str, indexes, reads: str, mates,
              out: str, *overrides, **env_extra) -> dict:
    args = ["classify", "--config", os.path.join(REPO, "configs", config),
            "--index", *indexes, "--reads", reads, "--samples", name,
            "--out", out]
    if mates:
        args += ["--mates", mates]
    _cli(f"classify-{name}", *args, *overrides, **env_extra)
    return _summary(out)


def _report_phase(name: str, s: dict, parity_n: int, classified: float,
                  consistency: float, wall: float) -> None:
    plans = "; ".join(f"layout={p['layout']} rows={p['table_rows']} "
                      f"lookup={p['lookup']} pscore={p['pscore']}"
                      for p in s["step_plans"])
    dev = s["device"]
    say(f"{name}: {plans}")
    say(f"{name}: reads={s['reads']} compile+warmup_s="
        f"{s.get('warmup_compile_sec')} e2e_reads_per_s="
        f"{s['reads_per_sec']} device_reads_per_sec="
        f"{s.get('device_reads_per_sec', 'not measured')} "
        f"peak_bytes_in_use={dev['peak_bytes_in_use']} "
        f"memory_budget_bytes={dev['memory_budget_bytes']} "
        f"({dev['memory_budget_source']})")
    say(f"{name}: golden parity {parity_n}/{parity_n} reads bit-exact; "
        f"classified={classified:.4f} ancestor_consistency="
        f"{consistency:.4f} over all reads; phase wall_s={wall:.1f}")


def _single_phase(name, config, indexes, reads, mates, threshold, t0,
                  overrides=()) -> dict:
    out = os.path.join(WORK, f"out-{name}")
    s = _classify(name, config, indexes, reads, mates, out, *overrides)
    tsv = os.path.join(out, f"{name}.assign.tsv")
    _cli(f"report-{name}", "report", "--assignments", tsv, "--samples",
         name, "--taxonomy", os.path.join(indexes[0], "taxonomy.npz"),
         "--out-dir", os.path.join(out, "report"))
    want = _golden(indexes, reads, mates, threshold)
    _check_parity(name, _tsv_rows(tsv, PARITY_READS), want)
    cls, cons = _consistency(indexes[0], tsv, reads + ".truth.npy")
    _report_phase(name, s, len(want), cls, cons, time.time() - t0)
    return s


def phase_config2() -> None:
    t0 = time.time()
    w = os.path.join(WORK, "c2")
    _gen(w, C2_READS, C2_GENOME_LEN, paired=True)
    _build("build-c2-k21w8", w, f"{w}/idx21w8", 21, "--minimizer-w", "8")
    _build("build-c2-k21", w, f"{w}/idx21", 21)
    r1, r2 = f"{w}/reads_1.fastq", f"{w}/reads_2.fastq"
    _single_phase("config2-w8", "config2_16s_paired.json",
                  [f"{w}/idx21w8"], r1, r2, 0.0, t0)
    t0 = time.time()
    _single_phase("config2-w1", "config2_16s_paired.json",
                  [f"{w}/idx21"], r1, r2, 0.0, t0)


def phase_multik() -> None:
    t0 = time.time()
    c2, w = os.path.join(WORK, "c2"), os.path.join(WORK, "c4")
    _gen(w, MULTIK_READS, C2_GENOME_LEN, paired=False)
    for f in ("refs.fasta", "taxonomy.tsv"):      # the config2 world
        with open(f"{c2}/{f}", "rb") as a, open(f"{w}/{f}", "rb") as b:
            if a.read() != b.read():
                raise SmokeError(f"multik: {f} differs from config2's")
    _build("build-c2-k31", c2, f"{c2}/idx31", 31)
    _single_phase("multik", "config4_multik.json",
                  [f"{c2}/idx21", f"{c2}/idx31"], f"{w}/reads_1.fastq",
                  None, 0.05, t0)


def _deep_world() -> str:
    w = os.path.join(WORK, "deep")
    _gen(w, DEEP_READS, DEEP_GENOME_LEN, paired=False)
    return w


def phase_deep() -> None:
    t0 = time.time()
    w = _deep_world()
    _build("build-deep", w, f"{w}/idx", 21)
    reads = f"{w}/reads_1.fastq"
    s = _single_phase("deep", "config3_shotgun_sharded.json", [f"{w}/idx"],
                      reads, None, 0.05, t0, DEEP_OVERRIDES)
    plan = s["step_plans"][0]
    if plan["lookup"] != "sorted":
        raise SmokeError(f"deep: lookup path {plan['lookup']}, not sorted")
    # Device step time of the sorted and the plain chunked lookup on the
    # same table and batch (ROADMAP S2), each checked against golden.
    import numpy as np
    want = _golden([f"{w}/idx"], reads, None, 0.05)
    res = {}
    for label, sort in (("sorted", "1"), ("plain", "0")):
        npz = os.path.join(WORK, f"deep-step-{label}.npz")
        line = _cli(f"bench-deep-{label}", "bench", "--index", f"{w}/idx",
                    "--reads", reads, "--batch", str(DEEP_BATCH),
                    "--max-read-len", "300", "--threshold", "0.05",
                    "--out-npz", npz, PANGEA_DEEP_SORT=sort)
        r = json.loads(line.strip().splitlines()[-1])
        out = np.load(npz)
        got = np.stack([out[k] for k in ("taxon", "best", "nvalid")], 1)
        _check_parity(f"deep-step-{label}", got, want)
        res[label] = (r, got)
    if not np.array_equal(res["sorted"][1], res["plain"][1]):
        raise SmokeError("deep: sorted and plain lookups disagree")
    (rs, _), (rp, _) = res["sorted"], res["plain"]
    if rs["plan"]["lookup"] != "sorted" or rp["plan"]["lookup"] == "sorted":
        raise SmokeError(f"deep step: paths {rs['plan']['lookup']} and "
                         f"{rp['plan']['lookup']}, wanted sorted and not")
    say(f"deep step, batch {DEEP_BATCH} x 300: sorted "
        f"({rs['plan']['lookup']})"
        f" step_ms={rs['step_ms']}, plain ({rp['plan']['lookup']})"
        f" step_ms={rp['step_ms']}; outputs bit-identical, golden "
        f"parity {len(want)}/{len(want)}; compile_s sorted="
        f"{rs['compile_sec']} plain={rp['compile_sec']}")


def phase_four_cards() -> None:
    t0 = time.time()
    w = _deep_world()
    _build("build-deep-4shard", w, f"{w}/idx4", 21, "--ooc-shards", "4")
    reads = f"{w}/reads_1.fastq"
    say(f"four-cards: data + 4-shard index ready in "
        f"{time.time() - t0:.1f} s")
    runs = [("one-card", ("mesh.n_data=1", "mesh.n_shard=1")),
            ("shard4-broadcast", ("mesh.n_data=1", "mesh.n_shard=4",
                                  "mesh.routing=broadcast")),
            ("shard4-alltoall", ("mesh.n_data=1", "mesh.n_shard=4",
                                 "mesh.routing=alltoall")),
            ("data4", ("mesh.n_data=4", "mesh.n_shard=1"))]
    ref = None
    for name, ov in runs:
        t1 = time.time()
        out = os.path.join(WORK, f"out-{name}")
        s = _classify(name, "config3_shotgun_sharded.json", [f"{w}/idx4"],
                      reads, None, out, *ov, *DEEP_OVERRIDES)
        with open(os.path.join(out, f"{name}.assign.tsv"), "rb") as fh:
            body = fh.read()
        # Sample names differ per run and are not in the TSV rows; the
        # rows (read id, taxon, rank, name, best/nvalid, conf) must match.
        if ref is None:
            ref = body
            verdict = "reference"
        elif body != ref:
            raise SmokeError(f"{name}: assignment TSV differs from the "
                             f"one-card run")
        else:
            verdict = "byte-identical to one-card"
        p = s["step_plans"][0]
        say(f"{name}: mesh={s['mesh']} routing={s['routing']} "
            f"layout={p['layout']} "
            f"lookup={p['lookup']} reads={s['reads']} compile+warmup_s="
            f"{s.get('warmup_compile_sec')} e2e_reads_per_s="
            f"{s['reads_per_sec']} device_reads_per_sec="
            f"{s.get('device_reads_per_sec', 'not measured')} "
            f"peak_bytes_in_use={s['device']['peak_bytes_in_use']}; "
            f"{verdict}; wall_s={time.time() - t1:.1f}")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(SRC, "pangea_tpu")):
        print("chip_smoke.py must run from a pangea-tpu checkout "
              f"(no {SRC}/pangea_tpu)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    t_all = time.time()
    try:
        CARD = _card()
        print(f"nvidia-smi: {CARD}", flush=True)
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        dev = _probe()
        print(f"jax {dev['jax']} jaxlib {dev['jaxlib']} devices "
              f"{dev['devices']}", flush=True)
        need = 4 if args.four_cards else 1
        if dev["count"] < need:
            raise SmokeError(f"need {need} GPUs, JAX sees {dev['count']}")
        phases = ([phase_four_cards] if args.four_cards
                  else [phase_config2, phase_multik, phase_deep])
        for phase in phases:
            t0 = time.time()
            phase()
            say(f"{phase.__name__} done in {time.time() - t0:.1f} s")
        if "jax" in sys.modules:
            raise SmokeError("the parent process imported JAX")
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    say(f"all phases passed in {time.time() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": need}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
