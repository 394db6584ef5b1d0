#!/usr/bin/env python
"""Benchmark entry: prints ONE JSON line
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}
for the headline (pangea_tpu.bench.run_bench), then the extras (dense and
deep tables) as a second JSON line on stderr. vs_baseline = measured over
the HBM roofline of the device's published peak bandwidth. A failure in
either part fails the run. Needs an accelerator the peak table knows.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from pangea_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

if __name__ == "__main__":
    enable_compile_cache()
    from pangea_tpu.bench import run_bench, run_bench_extras
    print(json.dumps(run_bench(), sort_keys=True), flush=True)
    print("extras: " + json.dumps(run_bench_extras(), sort_keys=True),
          file=sys.stderr, flush=True)
