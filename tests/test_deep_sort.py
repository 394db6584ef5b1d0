"""Sorted-sliced deep-table gather (round 5, kernels.lookup._sorted_pk):
bit-exactness vs the plain chunked path, both cond branches (spans fit →
sliced; spans exceed the slice → guarded fallback), q8 and q12 layouts.

The deep thresholds are module constants read at trace time, so tests
shrink them via monkeypatch to make small worlds "deep"."""
import jax
import numpy as np
import pytest

from pangea_tpu.classify.engine import (DeviceIndex, make_classify_fn,
                                        pad_batch)
from pangea_tpu.golden import classify_reads_golden
from pangea_tpu.kernels import lookup as LK

from .helpers import small_world


@pytest.fixture(scope="module")
def world():
    return small_world(n_reads=192)


def _run(idx, rs, layout, deep_on, monkeypatch, slice_rows):
    monkeypatch.setenv("PANGEA_DEEP_SORT", "1" if deep_on else "0")
    monkeypatch.setattr(LK, "_DEEP_ROWS", 1 << 9)
    monkeypatch.setattr(LK, "_DEEP_SLICE", slice_rows)
    monkeypatch.setattr(
        LK, "_deep_chunk",
        lambda n, nb, rb=512, min_chunk=8192:
        2048 if deep_on and n > 2048 else None)
    di = DeviceIndex.from_index(idx, confidence_threshold=0.05,
                                layout=layout)
    fn = make_classify_fn(di.cfg)
    out = fn(di.tables, pad_batch(rs.seqs, 192, 120))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("layout", ["q8", "q12", "std"])
@pytest.mark.parametrize("slice_rows", [1 << 14, 1 << 6])
def test_deep_sorted_bit_exact(world, layout, slice_rows, monkeypatch):
    """slice_rows = 2^14 ≥ nb: every span fits → the SLICED branch runs;
    2^6: spans exceed it → the guarded fallback runs. Both must equal
    the plain path and golden."""
    tax, _, idx, rs = world
    a = _run(idx, rs, layout, True, monkeypatch, slice_rows)
    b = _run(idx, rs, layout, False, monkeypatch, slice_rows)
    for k in ("taxon", "best", "nvalid"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = classify_reads_golden(rs.seqs, idx, 0.05)
    np.testing.assert_array_equal(a["taxon"], [r.taxon for r in want])


def test_deep_chunk_policy():
    """Engagement rule: enough probes per table row, power-of-two chunk,
    capped; tiny probe counts decline."""
    assert LK._deep_chunk(524288, 1 << 20) == 8192
    assert LK._deep_chunk(8388608, 1 << 20) == 131072
    assert LK._deep_chunk(32768, 1 << 20) is None      # too few probes
    assert LK._deep_chunk(1 << 24, 1 << 18) == (1 << 19)  # capped
    # table-bytes cap: no win measured beyond ~2 GB (mb_deep4)
    assert LK._deep_chunk(8388608, 1 << 24, 512) is None
    assert LK._deep_chunk(1 << 25, 1 << 24, 512) is None
    assert LK._deep_chunk(8388608, 1 << 22, 512) == 32768
    # std 256 B rows: same byte budget admits 2^23 rows, but std's
    # heavier sorts demand min_chunk=32768 (28M-shard std arm loss)
    assert LK._deep_chunk(1 << 24, 1 << 23, 256, min_chunk=32768) == 32768
    assert LK._deep_chunk(1 << 23, 1 << 23, 256, min_chunk=32768) is None


@pytest.mark.parametrize("layout", ["q8", "q12", "std"])
@pytest.mark.parametrize("deep_on", [True, False])
def test_step_plan_names_the_traced_path(world, layout, deep_on,
                                         monkeypatch):
    """run_summary's step plan reports the gather the lookup traces."""
    from pangea_tpu.classify.engine import step_plan
    _, _, idx, _ = world
    monkeypatch.setenv("PANGEA_DEEP_SORT", "1" if deep_on else "0")
    monkeypatch.setattr(LK, "_DEEP_ROWS", 1 << 9)
    monkeypatch.setattr(
        LK, "_deep_chunk",
        lambda n, nb, rb=512, min_chunk=8192:
        2048 if deep_on and n > 2048 else None)
    di = DeviceIndex.from_index(idx, confidence_threshold=0.05,
                                layout=layout)
    plan = step_plan(di, 192, 120, paired=False)
    assert plan["layout"] == layout
    assert plan["probes_per_read"] == 100
    assert plan["lookup"] == ("sorted" if deep_on else "plain")
    assert plan["pscore"] == "quadratic"
    if not deep_on:   # 4096 reads x 100 probes > one 32768-probe chunk
        assert step_plan(di, 4096, 120, False)["lookup"] == "fused-chunk"
