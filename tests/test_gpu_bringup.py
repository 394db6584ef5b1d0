"""GPU bring-up: the compile-cache rule, the device memory budget, the peak
table, the run summary's device fields, chip_smoke.py without a GPU, and
one golden-parity test that runs only on the card (marker ``gpu``)."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from pangea_tpu import cli
from pangea_tpu.bench import PEAK_HBM_BYTES_PER_SEC, peak_hbm_bytes_per_sec
from pangea_tpu.dist.mesh import (batch_working_set_bytes, choose_mesh,
                                  memory_budget)
from pangea_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PRINT_CACHE = ("from pangea_tpu.utils.compile_cache import cache_dir; "
                "print(cache_dir())")


def _child_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra)
    return env


def test_compile_cache_uses_env_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert compile_cache.cache_dir() == str(tmp_path / "cc")


def test_compile_cache_default_is_fixed_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.cache_dir() == want
    # Two processes started at different times and cwds agree on it.
    got = {subprocess.run([sys.executable, "-c", _PRINT_CACHE],
                          env=_child_env(), cwd=cwd, capture_output=True,
                          text=True, check=True).stdout.strip()
           for cwd in (REPO, os.path.join(REPO, "tests"))}
    assert got == {want}


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_memory_budget_from_device_bytes_limit():
    ws = batch_working_set_bytes(262144, 300, paired=False)
    assert ws == 262144 * 300 * 32
    devs = [_Dev({"bytes_limit": 60 << 30}), _Dev({"bytes_limit": 50 << 30})]
    assert memory_budget(devs, 0.0, ws) == ((50 << 30) - ws,
                                            "device bytes_limit")


def test_memory_budget_config_override_and_no_stats():
    devs = [_Dev({"bytes_limit": 60 << 30})]
    assert memory_budget(devs, 2.0, 123) == (2 << 30, "config")
    budget, source = memory_budget([_Dev(None)], 0.0, 123)
    assert budget is None and "no memory stats" in source
    # Unbounded budget replicates; a tight one shards.
    assert choose_mesh(4, 10 << 30, None).n_shard == 1
    assert choose_mesh(4, 10 << 30, 3 << 30).n_shard == 4


def test_peak_table_raises_on_unknown_device_kind():
    assert peak_hbm_bytes_per_sec("NVIDIA H100 80GB HBM3") == 3.35e12
    assert set(PEAK_HBM_BYTES_PER_SEC) == {"NVIDIA H100 80GB HBM3"}
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(ValueError, match="no published HBM peak"):
            peak_hbm_bytes_per_sec(kind)


def test_chip_smoke_without_gpu_fails(tmp_path):
    """With no GPU the script exits non-zero, names the missing GPU and
    never prints the ok line; alone in a directory it fails too."""
    env = _child_env()
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "GPU" in r.stderr
    assert '"ok": true' not in r.stdout + r.stderr
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout + r.stderr


@pytest.fixture(scope="module")
def testdata(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gpu_td"))
    assert cli.main(["gen-testdata", "--out", d, "--reads", "300",
                     "--read-len", "120", "--paired",
                     "--genome-len", "4000"]) == 0
    assert cli.main(["build", "--refs", f"{d}/refs.fasta", "--taxonomy",
                     f"{d}/taxonomy.tsv", "--k", "21", "--out",
                     f"{d}/idx21"]) == 0
    return d


@pytest.mark.parametrize("native", [True, False])
def test_run_summary_names_the_device(testdata, tmp_path, monkeypatch,
                                      native):
    d = testdata
    if not native:
        monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    out = str(tmp_path / "out")
    assert cli.main(["classify", "--index", f"{d}/idx21",
                     "--reads", f"{d}/reads_1.fastq",
                     "--mates", f"{d}/reads_2.fastq", "--samples", "s",
                     "--out", out, "input.batch_size=64",
                     "input.max_read_len=120"]) == 0
    with open(os.path.join(out, "run_summary.json")) as fh:
        s = json.load(fh)
    dev = s["device"]
    assert dev["platform"] == "cpu" and dev["device_kind"] == "cpu"
    assert dev["n_devices"] == 8
    assert dev["native_ingest"] is native
    assert dev["peak_bytes_in_use"] is None       # CPU: no memory stats
    assert dev["memory_budget_bytes"] is None
    assert "no memory stats" in dev["memory_budget_source"]
    (plan,) = s["step_plans"]
    assert plan["probes_per_read"] == 2 * (120 - 21 + 1)
    assert plan["lookup"] in ("plain", "chunked", "fused-chunk", "sorted")
    assert plan["pscore"] == "quadratic"


# ------------------------------------------------------------- on the card
_GPU_PARITY = r"""
import jax, numpy as np
from pangea_tpu.classify.engine import DeviceIndex, make_classify_fn, pad_batch
from pangea_tpu.golden import classify_reads_golden
from pangea_tpu.index import build_index
from pangea_tpu.utils import datagen
assert jax.devices()[0].platform == "gpu", jax.devices()
tax = datagen.make_taxonomy(seed=0)
genomes = datagen.make_genomes(tax, genome_len=4000, seed=1)
rs = datagen.sample_reads(genomes, 256, read_len=120, paired=True,
                          n_prob=0.02, seed=2)
for w in (1, 8):
    idx = build_index(genomes, tax, k=21, w=w)
    di = DeviceIndex.from_index(idx, confidence_threshold=0.05)
    out = make_classify_fn(di.cfg, paired=True)(
        di.tables, pad_batch(rs.seqs, 256, 120), pad_batch(rs.mates, 256, 120))
    got = np.stack([np.asarray(out[k]) for k in ("taxon", "best", "nvalid")], 1)
    want = [(g.taxon, g.best, g.nvalid) for g in
            classify_reads_golden(rs.seqs, idx, 0.05, mates=rs.mates)]
    assert (got == np.array(want)).all(), w
print("GPU-PARITY-OK", jax.devices()[0].device_kind)
"""


@pytest.fixture
def gpu():
    """Skips unless an NVIDIA GPU answers; decided here, at run time."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU (nvidia-smi not found)")
    r = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True)
    if r.returncode != 0 or "GPU" not in r.stdout:
        pytest.skip("no NVIDIA GPU (nvidia-smi lists none)")


@pytest.mark.gpu
def test_golden_parity_on_gpu(gpu):
    """The classify step on the card, bit-exact against golden. The tests
    force the CPU backend in-process, so the card runs in a child."""
    env = _child_env(JAX_PLATFORMS="cuda")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _GPU_PARITY], env=env,
                       cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "GPU-PARITY-OK" in r.stdout
