"""Multi-process (multi-host) execution tests — default-on (VERDICT r1 #1).

Two local processes rendezvous via jax.distributed over localhost TCP (the
DCN stand-in), each contributing 2 forced CPU devices to a global 2x2
(data, shard) mesh, and run the public CLI classify path end-to-end. The
reports must be byte-identical to a single-process run (SEMANTICS.md §11:
integer tallies + disjoint shard supports make every mesh shape and every
process count bit-exact).
"""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def testdata(tmp_path_factory):
    from pangea_tpu import cli
    d = str(tmp_path_factory.mktemp("mp_td"))
    assert cli.main(["gen-testdata", "--out", d, "--reads", "500",
                     "--paired"]) == 0
    assert cli.main(["build", "--refs", f"{d}/refs.fasta",
                     "--taxonomy", f"{d}/taxonomy.tsv", "--k", "21",
                     "--out", f"{d}/idx21"]) == 0
    return d


def _classify_args(d, out, extra=()):
    return (["classify", "--index", f"{d}/idx21",
             "--reads", f"{d}/reads_1.fastq",
             "--mates", f"{d}/reads_2.fastq", "--samples", "s",
             "--out", out, "input.batch_size=64",
             "input.max_read_len=120"] + list(extra))


def _spawn(d, out, n_local_devices, extra=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                        f"{n_local_devices}")
    return subprocess.Popen(
        [sys.executable, "-m", "pangea_tpu.cli"]
        + _classify_args(d, out, extra),
        env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def test_two_process_classify_byte_identical(testdata, tmp_path):
    d = testdata
    # Single-process baseline through the same subprocess CLI path
    # (4 forced devices, data=2 x shard=2 — same mesh shape as below).
    single = str(tmp_path / "single")
    p = _spawn(d, single, 4, ["mesh.n_data=2", "mesh.n_shard=2"])
    _, err = p.communicate(timeout=600)
    assert p.returncode == 0, err.decode()

    multi = str(tmp_path / "multi")
    port = _free_port()
    extra = [f"dist.coordinator=127.0.0.1:{port}", "dist.num_processes=2",
             "mesh.n_data=2", "mesh.n_shard=2"]
    procs = [_spawn(d, multi, 2, extra + [f"dist.process_id={i}"])
             for i in range(2)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()

    for f in ("s.assign.tsv", "s.summary.tsv", "stats.json"):
        a = open(os.path.join(single, f), "rb").read()
        b = open(os.path.join(multi, f), "rb").read()
        assert a == b, f"{f} differs between 1-process and 2-process runs"


def test_two_process_routed_alltoall_byte_identical(testdata, tmp_path):
    """mesh.routing=alltoall over a 2-process mesh: the owner-routing
    all_to_all rides the DCN stand-in; outputs must stay byte-identical
    to the broadcast-psum single-process run (round 5, VERDICT r4 #4)."""
    d = testdata
    single = str(tmp_path / "single_r")
    p = _spawn(d, single, 4, ["mesh.n_data=2", "mesh.n_shard=2"])
    _, err = p.communicate(timeout=600)
    assert p.returncode == 0, err.decode()

    multi = str(tmp_path / "multi_r")
    port = _free_port()
    extra = [f"dist.coordinator=127.0.0.1:{port}", "dist.num_processes=2",
             "mesh.n_data=2", "mesh.n_shard=2", "mesh.routing=alltoall"]
    procs = [_spawn(d, multi, 2, extra + [f"dist.process_id={i}"])
             for i in range(2)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()
    for f in ("s.assign.tsv", "s.summary.tsv", "stats.json"):
        a = open(os.path.join(single, f), "rb").read()
        b = open(os.path.join(multi, f), "rb").read()
        assert a == b, f"{f} differs (routed 2-proc vs broadcast 1-proc)"


def test_two_process_streaming_quot_placement(testdata, tmp_path):
    """2-process STREAMING q8 placement (ShardedIndex whose shard count
    matches the mesh): exercises the cross-process max all-reduce that
    makes the common bucket count — and any overflow restart — globally
    agreed (r4 review finding). Outputs byte-identical to 1-process."""
    from pangea_tpu import cli
    d = testdata
    assert cli.main(["build", "--refs", f"{d}/refs.fasta",
                     "--taxonomy", f"{d}/taxonomy.tsv", "--k", "21",
                     "--ooc-shards", "2",
                     "--out", f"{d}/idx21s2"]) == 0

    def args(out, extra=()):
        return (["classify", "--index", f"{d}/idx21s2",
                 "--reads", f"{d}/reads_1.fastq",
                 "--mates", f"{d}/reads_2.fastq", "--samples", "s",
                 "--out", out, "input.batch_size=64",
                 "input.max_read_len=120", "mesh.n_data=2",
                 "mesh.n_shard=2"] + list(extra))

    def spawn(out, n_dev, extra=()):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(REPO, "src")
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                            f"{n_dev}")
        return subprocess.Popen(
            [sys.executable, "-m", "pangea_tpu.cli"] + args(out, extra),
            env=env, cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)

    single = str(tmp_path / "single")
    p = spawn(single, 4)
    _, err = p.communicate(timeout=600)
    assert p.returncode == 0, err.decode()

    multi = str(tmp_path / "multi")
    port = _free_port()
    extra = [f"dist.coordinator=127.0.0.1:{port}",
             "dist.num_processes=2"]
    procs = [spawn(multi, 2, extra + [f"dist.process_id={i}"])
             for i in range(2)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()
    for f in ("s.assign.tsv", "s.summary.tsv"):
        a = open(os.path.join(single, f), "rb").read()
        b = open(os.path.join(multi, f), "rb").read()
        assert a == b, f"{f} differs between 1-process and 2-process runs"
