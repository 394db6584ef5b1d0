"""Exact-capacity all_to_all k-mer routing (round 5, VERDICT r4 #4):
the routed sharded classify must be bit-identical to the broadcast-psum
path and to golden, across mesh shapes, layouts, and BOTH cond branches
(capacity fits → routed; forced overflow → broadcast fallback)."""
import jax
import numpy as np
import pytest

from pangea_tpu.classify.engine import pad_batch
from pangea_tpu.dist import (MeshConfig, make_mesh,
                             make_sharded_classify_fn, place_index)
from pangea_tpu.dist import mesh as M
from pangea_tpu.dist.mesh import batch_sharding
from pangea_tpu.golden import classify_reads_golden

from .helpers import small_world


@pytest.fixture(scope="module")
def world():
    return small_world(n_reads=128)


def _outs(fn, tables, bases):
    return {k: np.asarray(v) for k, v in fn(tables, bases).items()}


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (4, 2)])
def test_routed_bit_exact(world, shape, monkeypatch):
    tax, _, idx, rs = world
    mesh = make_mesh(MeshConfig(*shape))
    di = place_index(idx, mesh, confidence_threshold=0.1)
    bases = jax.device_put(pad_batch(rs.seqs, 128, 120),
                           batch_sharding(mesh))
    a = _outs(make_sharded_classify_fn(di.cfg, mesh, routing="alltoall"),
              di.tables, bases)
    b = _outs(make_sharded_classify_fn(di.cfg, mesh, routing="broadcast"),
              di.tables, bases)
    for k in ("taxon", "best", "nvalid"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = classify_reads_golden(rs.seqs, idx, 0.1)
    np.testing.assert_array_equal(a["taxon"], [r.taxon for r in want])


def test_routed_overflow_fallback(world, monkeypatch):
    """cap_frac so small every bin overflows → the in-program guard must
    take the broadcast branch and stay bit-exact."""
    tax, _, idx, rs = world
    mesh = make_mesh(MeshConfig(2, 4))
    di = place_index(idx, mesh, confidence_threshold=0.1)
    bases = jax.device_put(pad_batch(rs.seqs, 128, 120),
                           batch_sharding(mesh))
    orig = M._local_classify_routed
    monkeypatch.setattr(
        M, "_local_classify_routed",
        lambda *a, **kw: orig(*a, **{**kw, "cap_frac": 0.01}))
    a = _outs(make_sharded_classify_fn(di.cfg, mesh, routing="alltoall"),
              di.tables, bases)
    want = classify_reads_golden(rs.seqs, idx, 0.1)
    np.testing.assert_array_equal(a["taxon"], [r.taxon for r in want])


def test_routed_env_flag(world, monkeypatch):
    """PANGEA_ROUTE=alltoall engages routing without code changes."""
    tax, _, idx, rs = world
    monkeypatch.setenv("PANGEA_ROUTE", "alltoall")
    mesh = make_mesh(MeshConfig(1, 8))
    di = place_index(idx, mesh, confidence_threshold=0.0)
    bases = jax.device_put(pad_batch(rs.seqs, 128, 120),
                           batch_sharding(mesh))
    a = _outs(make_sharded_classify_fn(di.cfg, mesh), di.tables, bases)
    want = classify_reads_golden(rs.seqs, idx, 0.0)
    np.testing.assert_array_equal(a["taxon"], [r.taxon for r in want])


def test_agree_any_takes_one_value_across_the_mesh():
    """The routed path's overflow flag is OR-reduced over the mesh before
    its lax.cond, so every device takes the same branch even when only
    one device's bins overflow."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    mesh = make_mesh(MeshConfig(2, 4))
    spec = P((M.DATA_AXIS, M.SHARD_AXIS))
    fn = jax.jit(shard_map(lambda f: M.agree_any(f[0])[None], mesh=mesh,
                           in_specs=spec, out_specs=spec))
    for hot in (None, 0, 5, 7):
        flags = np.zeros(8, bool)
        if hot is not None:
            flags[hot] = True
        got = np.asarray(fn(jax.numpy.asarray(flags)))
        assert got.tolist() == [hot is not None] * 8, hot


def test_routed_one_owner_overflows(world):
    """Half the batch is poly-A reads, whose k-mers all hash to ONE owner
    shard: that owner's bin overflows while the others fit. The guarded
    fallback must keep routed == broadcast == golden bit for bit. Reads
    carry no N: invalid positions all route to shard 0."""
    from pangea_tpu.core import canonical_kmers, hash32_np
    from pangea_tpu.utils import datagen
    tax, genomes, idx, _ = world
    rs = datagen.sample_reads(genomes, 64, read_len=120, n_prob=0.0,
                              seed=5)
    polya = np.zeros(120, np.uint8)
    seqs = list(rs.seqs) + [polya] * 64
    S, N = 8, 128 * (120 - 21 + 1)
    cap = int(-(-N // S) * 1.25 + 0.5)
    owners = []
    for s in seqs:
        canon, valid = canonical_kmers(s, 21)
        owners.append(np.where(valid, hash32_np(canon) >> 29, 0))
    fill = np.bincount(np.concatenate(owners), minlength=S)
    assert (fill > cap).sum() == 1, (fill, cap)
    mesh = make_mesh(MeshConfig(1, 8))
    di = place_index(idx, mesh, confidence_threshold=0.1)
    bases = jax.device_put(pad_batch(seqs, 128, 120), batch_sharding(mesh))
    a = _outs(make_sharded_classify_fn(di.cfg, mesh, routing="alltoall"),
              di.tables, bases)
    b = _outs(make_sharded_classify_fn(di.cfg, mesh, routing="broadcast"),
              di.tables, bases)
    want = classify_reads_golden(seqs, idx, 0.1)
    for k in ("taxon", "best", "nvalid"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a[k], [getattr(r, k) for r in want],
                                      err_msg=k)
