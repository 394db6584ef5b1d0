"""Batch-size sweep for the config-4 e2e pipeline.

Runs the real config-4 job (fused multi-k, fast path) at each batch size
and records both e2e reads/s and device_reads_per_sec (median ready-gap
rate), repeated REPS times.

DATA holds reads_1.fastq and the idx21w8/idx31w8 indexes built from
`pangea-tpu gen-testdata` output. One classify process at a time, so the
card is never shared:

    python experiments/sweep_batch.py DATA OUT.json
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (16384, 32768, 65536, 131072, 262144, 524288)
REPS = 2


def run_once(data: str, batch: int, rep: int) -> dict:
    out = os.path.join(data, f"out_b{batch}_{rep}")
    subprocess.run(["rm", "-rf", out], check=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "pangea_tpu.cli", "classify",
         "--config", "configs/config4_multik.json",
         f'input.reads=["{data}/reads_1.fastq"]',
         f'classify.index=["{data}/idx21w8","{data}/idx31w8"]',
         f"classify.out_dir={out}", "input.max_read_len=150",
         f"input.batch_size={batch}"],
        env=env, cwd=REPO, capture_output=True, text=True)
    if r.returncode != 0:
        return {"batch": batch, "rep": rep, "error": r.stderr[-500:]}
    s = json.load(open(os.path.join(out, "run_summary.json")))
    return {"batch": batch, "rep": rep,
            "e2e_reads_per_sec": s["reads_per_sec"],
            "device_reads_per_sec": s.get("device_reads_per_sec"),
            "compile_sec": s.get("compile_sec"),
            "wall_sec": s["wall_sec"],
            "sweep_wall": round(time.time() - t0, 1)}


def main():
    data, out_path = sys.argv[1], sys.argv[2]
    rows = []
    for batch in BATCHES:
        for rep in range(REPS):
            row = run_once(data, batch, rep)
            print(json.dumps(row), flush=True)
            rows.append(row)
    ok = [r for r in rows if "error" not in r
          and r.get("device_reads_per_sec")]
    best = {}
    for r in ok:
        best.setdefault(r["batch"], []).append(r)
    table = {b: {"device_reads_per_sec":
                 max(x["device_reads_per_sec"] for x in v),
                 "e2e_reads_per_sec":
                 [x["e2e_reads_per_sec"] for x in v]}
             for b, v in sorted(best.items())}
    result = {"rows": rows, "by_batch": table}
    with open(out_path, "w") as fh:
        json.dump(result, fh, indent=1, sort_keys=True)
    print(json.dumps({"by_batch": table}, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()
