"""Integration tests: CLI build/classify/report end-to-end on the CPU
backend (driver config-1 style — SURVEY.md §5.5), incl. paired-end,
multi-k merge, demux cohort, and checkpoint/resume bit-safety."""
import json
import os

import numpy as np
import pytest

from pangea_tpu import cli
from pangea_tpu.golden import (classify_reads_golden, merge_multik_golden)
from pangea_tpu.index import Index
from pangea_tpu.io import read_batches
from pangea_tpu.report.writers import AssignmentRecord, format_assignment


@pytest.fixture(scope="module")
def testdata(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("td"))
    assert cli.main(["gen-testdata", "--out", d, "--reads", "300",
                     "--read-len", "120", "--paired",
                     "--genome-len", "4000"]) == 0
    assert cli.main(["build", "--refs", f"{d}/refs.fasta", "--taxonomy",
                     f"{d}/taxonomy.tsv", "--k", "21", "--out",
                     f"{d}/idx21"]) == 0
    assert cli.main(["build", "--refs", f"{d}/refs.fasta", "--taxonomy",
                     f"{d}/taxonomy.tsv", "--k", "31", "--out",
                     f"{d}/idx31"]) == 0
    return d


def _golden_lines(d, idx_paths, threshold, paired):
    idxs = [Index.load(p) for p in idx_paths]
    tax = idxs[0].taxonomy
    mate = f"{d}/reads_2.fastq" if paired else None
    batch = next(read_batches(f"{d}/reads_1.fastq", 10**6, mate_path=mate))
    per_k = [classify_reads_golden(batch.seqs, ix, threshold,
                                   mates=batch.mate_seqs if paired else None)
             for ix in idxs]
    res = per_k[0]
    for other in per_k[1:]:
        res = [merge_multik_golden(a, b, tax) for a, b in zip(res, other)]
    return [format_assignment(
        AssignmentRecord(batch.ids[i], r.taxon, r.best, r.nvalid), tax)
        for i, r in enumerate(res)]


def test_classify_paired_multik_matches_golden(testdata, tmp_path):
    d = testdata
    out = str(tmp_path / "out")
    assert cli.main(["classify", "--index", f"{d}/idx21", f"{d}/idx31",
                     "--reads", f"{d}/reads_1.fastq",
                     "--mates", f"{d}/reads_2.fastq",
                     "--samples", "mock", "--out", out,
                     "input.batch_size=128", "input.max_read_len=120",
                     "classify.confidence_threshold=0.05"]) == 0
    got = open(f"{out}/mock.assign.tsv").readlines()
    want = _golden_lines(d, [f"{d}/idx21", f"{d}/idx31"], 0.05, paired=True)
    assert got == want
    summary = open(f"{out}/mock.summary.tsv").read()
    assert summary.splitlines()[1].split("\t")[3] == "root"
    assert os.path.exists(f"{out}/stats.json")
    assert os.path.exists(f"{out}/run_config.json")


@pytest.mark.parametrize("native", [True, False])
def test_resume_bit_safety(testdata, tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    from pangea_tpu.io.native import native_available
    if native and not native_available():
        pytest.skip("native io unavailable")
    d = testdata
    full = str(tmp_path / "full")
    args = ["classify", "--index", f"{d}/idx21",
            "--reads", f"{d}/reads_1.fastq", "--samples", "s",
            "input.batch_size=64", "input.max_read_len=120"]
    assert cli.main(args + ["--out", full]) == 0

    # Interrupted run: same config, but manifest rolled back MID-batch-2
    # (100 reads: exercises the partial-batch skip arithmetic) and the
    # assignment file torn past the durable offset (simulating a crash).
    part = str(tmp_path / "part")
    assert cli.main(args + ["--out", part]) == 0
    man = json.load(open(f"{part}/manifest.json"))
    key = f"{d}/reads_1.fastq"
    man["files"][key] = 100
    apath = f"{part}/s.assign.tsv"
    lines = open(apath).readlines()
    durable = sum(len(l) for l in lines[:100])
    man["outputs"][apath] = durable
    json.dump(man, open(f"{part}/manifest.json", "w"))
    with open(apath, "r+") as fh:                # torn tail past the offset
        fh.truncate(durable + 37)
    assert cli.main(args + ["--out", part, "--resume"]) == 0
    assert open(f"{part}/s.assign.tsv").read() == \
        open(f"{full}/s.assign.tsv").read()
    assert open(f"{part}/s.summary.tsv").read() == \
        open(f"{full}/s.summary.tsv").read()
    # A second resume after completion is a no-op (counts stayed exact).
    man2 = json.load(open(f"{part}/manifest.json"))
    assert man2["files"][key] == 300
    assert cli.main(args + ["--out", part, "--resume"]) == 0
    assert open(f"{part}/s.assign.tsv").read() == \
        open(f"{full}/s.assign.tsv").read()


def test_fast_path_matches_python_path(testdata, tmp_path, monkeypatch):
    from pangea_tpu.io.native import native_available
    if not native_available():
        pytest.skip("native io unavailable")
    d = testdata
    # batch_size=32 -> ~10 batches, enough for the ready-gap gauge to
    # emit a steady-state rate past its pipeline-fill skip window.
    args = ["classify", "--index", f"{d}/idx21", f"{d}/idx31",
            "--reads", f"{d}/reads_1.fastq",
            "--mates", f"{d}/reads_2.fastq", "--samples", "m",
            "input.batch_size=32", "input.max_read_len=120",
            "classify.confidence_threshold=0.05"]
    fast = str(tmp_path / "fast")
    assert cli.main(args + ["--out", fast]) == 0
    summary = json.load(open(f"{fast}/run_summary.json"))
    assert summary.get("fast_path")
    # Observability schema: the ready-gap device gauge + cumulative
    # compile bill must be present in every summary.
    assert summary["device_reads_per_sec"] > 0
    assert summary["compile_sec"] >= 0
    # Declared warmup: the steady shape compiles at
    # warmup; a fixed-shape run must see NO late (mid-stream) compiles.
    assert summary["warmup_compile_sec"] >= 0
    assert summary["late_compiled_shapes"] == 0
    first = json.loads(open(f"{fast}/metrics.jsonl").readline())
    assert "fetch_sec" in first and "ready_gap_sec" in first
    slow = str(tmp_path / "slow")
    monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    assert cli.main(args + ["--out", slow]) == 0
    for f in ("m.assign.tsv", "m.summary.tsv"):
        assert open(f"{fast}/{f}").read() == open(f"{slow}/{f}").read()


def test_demux_cohort(testdata, tmp_path):
    d = testdata
    # Prefix half the reads with barcode AACCGG, half with TTGGCC.
    import numpy as np
    from pangea_tpu.io.fastx import FastxReader
    src = list(FastxReader(f"{d}/reads_1.fastq"))
    bpath = str(tmp_path / "bc.fastq")
    with open(bpath, "w") as fh:
        for i, (rid, codes, q) in enumerate(src):
            bc = "AACCGG" if i % 2 == 0 else "TTGGCC"
            seq = bc + "".join("ACGTN"[c] for c in codes)
            fh.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    out = str(tmp_path / "cohort")
    assert cli.main(["classify", "--index", f"{d}/idx21",
                     "--reads", bpath, "--out", out,
                     "input.batch_size=128", "input.max_read_len=126",
                     'demux.barcodes=[["sampleA","AACCGG"],["sampleB","TTGGCC"]]',
                     ]) == 0
    assert os.path.exists(f"{out}/sampleA.assign.tsv")
    assert os.path.exists(f"{out}/sampleB.assign.tsv")
    assert os.path.exists(f"{out}/cohort.summary.tsv")
    na = len(open(f"{out}/sampleA.assign.tsv").readlines())
    nb = len(open(f"{out}/sampleB.assign.tsv").readlines())
    assert na == 150 and nb == 150
    # Barcode-stripped reads classify the same as the originals.
    want = _golden_lines(d, [f"{d}/idx21"], 0.0, paired=False)
    got = {}
    for s in ("sampleA", "sampleB"):
        for line in open(f"{out}/{s}.assign.tsv"):
            got[line.split("\t")[1]] = line
    for w in want:
        rid = w.split("\t")[1]
        assert got[rid] == w


def test_report_command(testdata, tmp_path):
    d = testdata
    out1 = str(tmp_path / "c1")
    assert cli.main(["classify", "--index", f"{d}/idx21",
                     "--reads", f"{d}/reads_1.fastq", "--samples", "s1",
                     "--out", out1, "input.batch_size=256",
                     "input.max_read_len=120"]) == 0
    rout = str(tmp_path / "rep")
    assert cli.main(["report", "--assignments", f"{out1}/s1.assign.tsv",
                     "--taxonomy", f"{d}/idx21/taxonomy.npz",
                     "--out-dir", rout]) == 0
    assert open(f"{rout}/s1.summary.tsv").read() == \
        open(f"{out1}/s1.summary.tsv").read()
    stats = json.load(open(f"{rout}/stats.json"))
    assert "shannon" in stats["s1"]
