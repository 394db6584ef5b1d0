"""Golden parity of the device (jnp) path — the spine of the test strategy
(SURVEY.md §5.1): every device component bit-exact vs the numpy golden
model. Runs on the CPU backend (conftest.py); the same code path runs
unchanged on the GPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pangea_tpu.classify import DeviceIndex, make_classify_fn, merge_multik_jnp
from pangea_tpu.classify.engine import pad_batch
from pangea_tpu.core import canonical_kmers, hash32_np
from pangea_tpu.golden import classify_reads_golden, merge_multik_golden
from pangea_tpu.index.shard import extract_pairs
from pangea_tpu.kernels import extract_kmers_jnp, hash32_jnp, lookup_jnp
from pangea_tpu.kernels.score import lca_pairs_jnp

from .helpers import small_world


@pytest.fixture(scope="module")
def world():
    return small_world(n_reads=150)


def _codes_batch(rng, B, L, ambig=True):
    hi = 5 if ambig else 4
    return rng.integers(0, hi, size=(B, L)).astype(np.int8)


@pytest.mark.parametrize("k", [5, 21, 31])
def test_extract_kmers_matches_numpy(k):
    rng = np.random.default_rng(0)
    bases = _codes_batch(rng, 8, 100)
    hi, lo, valid = jax.jit(extract_kmers_jnp, static_argnums=1)(bases, k)
    hi, lo, valid = map(np.asarray, (hi, lo, valid))
    for b in range(8):
        canon, v = canonical_kmers(bases[b].astype(np.uint8), k)
        np.testing.assert_array_equal(valid[b], v)
        got = (hi[b].astype(np.uint64) << np.uint64(32)) | lo[b]
        np.testing.assert_array_equal(got[v], canon[v])


@pytest.mark.parametrize("k", [5, 21, 31])
def test_extract_packed_matches_unpacked(k):
    """The packed wire format (native transport) must decode to exactly the
    int8-path outputs. Packing here replicates pangea_io.cpp's layout in
    numpy (the C++ packer itself is tested in test_io_native.py)."""
    from pangea_tpu.kernels.encode import extract_kmers_packed_jnp
    rng = np.random.default_rng(7)
    B, L = 8, 100
    bases = _codes_batch(rng, B, L)
    w16, w32 = (L + 15) // 16, (L + 31) // 32
    rows = np.zeros((B, w16 + w32), dtype=np.uint32)
    for b in range(B):
        for j in range(L):
            c = int(bases[b, j])
            rows[b, j >> 4] |= (c & 3) << (2 * (j & 15))
            if c > 3:
                rows[b, w16 + (j >> 5)] |= 1 << (j & 31)
    want = jax.jit(extract_kmers_jnp, static_argnums=1)(bases, k)
    got = jax.jit(extract_kmers_packed_jnp,
                  static_argnums=(1, 2))(rows, L, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_hash_matches_numpy():
    rng = np.random.default_rng(1)
    canon = rng.integers(0, 1 << 62, size=1000).astype(np.uint64)
    hi = (canon >> np.uint64(32)).astype(np.uint32)
    lo = (canon & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(hash32_jnp(jnp.array(hi), jnp.array(lo))),
        hash32_np(canon))


def test_lookup_matches_numpy(world):
    _, _, idx, _ = world
    # layout="std": this test pins lookup_jnp on std fused rows (the q8
    # twin is tests/test_q8.py::test_q8_layout_roundtrip).
    di = DeviceIndex.from_index(idx, device_put=False, layout="std")
    rng = np.random.default_rng(2)
    canon, _ = extract_pairs(idx)
    probes = np.concatenate([
        rng.choice(canon, 500),
        rng.integers(0, 1 << 42, size=500).astype(np.uint64)]).reshape(4, 250)
    hi = (probes >> np.uint64(32)).astype(np.uint32)
    lo = (probes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    valid = np.ones(probes.shape, bool)
    got, g_tin, g_tout = lookup_jnp(
        jnp.array(hi), jnp.array(lo), jnp.array(valid),
        jnp.array(di.fused[0]), jnp.array(di.stash[0]))
    want = idx.lookup_np(probes.ravel(), valid.ravel()).reshape(4, 250)
    np.testing.assert_array_equal(np.asarray(got), want)
    # Euler intervals ride along with hits (0 at misses).
    tax = idx.taxonomy
    hitm = want != 0
    np.testing.assert_array_equal(np.asarray(g_tin)[hitm],
                                  tax.tin[want[hitm]])
    np.testing.assert_array_equal(np.asarray(g_tout)[hitm],
                                  tax.tout[want[hitm]])
    np.testing.assert_array_equal(np.asarray(g_tin)[~hitm], 0)


def test_lca_pairs_matches_taxonomy(world):
    tax, _, _, _ = world
    arrs = {k: jnp.array(v) for k, v in tax.device_arrays().items()}
    rng = np.random.default_rng(3)
    T = tax.num_taxa
    u = rng.integers(0, T + 1, size=500).astype(np.int32)
    v = rng.integers(0, T + 1, size=500).astype(np.int32)
    got = np.asarray(lca_pairs_jnp(jnp.array(u), jnp.array(v),
                                   arrs["parent"], arrs["depth"], arrs["up"]))
    want = np.array([tax.lca(int(a), int(b)) for a, b in zip(u, v)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.9])
def test_classify_bit_exact_vs_golden(world, threshold):
    tax, _, idx, rs = world
    di = DeviceIndex.from_index(idx, confidence_threshold=threshold)
    fn = make_classify_fn(di.cfg)
    bases = pad_batch(rs.seqs, len(rs.seqs), 120)
    out = {k: np.asarray(v) for k, v in fn(di.tables, bases).items()}
    want = classify_reads_golden(rs.seqs, idx, threshold)
    np.testing.assert_array_equal(out["taxon"], [r.taxon for r in want])
    np.testing.assert_array_equal(out["best"], [r.best for r in want])
    np.testing.assert_array_equal(out["nvalid"], [r.nvalid for r in want])


@pytest.mark.parametrize("impl", ["quad", "rank"])
def test_pscore_impls_bit_exact(world, impl, monkeypatch):
    """Both pscore implementations (quadratic containment matrix and
    sort-rank counting — kernels/score.py) must match golden exactly."""
    monkeypatch.setenv("PANGEA_PSCORE", impl)
    tax, _, idx, rs = world
    di = DeviceIndex.from_index(idx, confidence_threshold=0.3)
    fn = make_classify_fn(di.cfg)
    bases = pad_batch(rs.seqs, len(rs.seqs), 120)
    out = {k: np.asarray(v) for k, v in fn(di.tables, bases).items()}
    want = classify_reads_golden(rs.seqs, idx, 0.3)
    np.testing.assert_array_equal(out["taxon"], [r.taxon for r in want])
    np.testing.assert_array_equal(out["best"], [r.best for r in want])
    np.testing.assert_array_equal(out["nvalid"], [r.nvalid for r in want])


def test_classify_paired_bit_exact(world):
    tax, genomes, idx, _ = world
    from pangea_tpu.utils import datagen
    rs = datagen.sample_reads(genomes, 100, read_len=110, paired=True,
                              n_prob=0.02, seed=7)
    di = DeviceIndex.from_index(idx, confidence_threshold=0.1)
    fn = make_classify_fn(di.cfg, paired=True)
    b1 = pad_batch(rs.seqs, 100, 110)
    b2 = pad_batch(rs.mates, 100, 110)
    out = {k: np.asarray(v) for k, v in fn(di.tables, b1, b2).items()}
    want = classify_reads_golden(rs.seqs, idx, 0.1, mates=rs.mates)
    np.testing.assert_array_equal(out["taxon"], [r.taxon for r in want])
    np.testing.assert_array_equal(out["best"], [r.best for r in want])
    np.testing.assert_array_equal(out["nvalid"], [r.nvalid for r in want])


def test_multik_merge_bit_exact(world):
    tax, genomes, idx, rs = world
    from pangea_tpu.index import build_index
    idx31 = build_index(genomes, tax, k=31)
    arrs = {k: jnp.array(v) for k, v in tax.device_arrays().items()}
    r21 = classify_reads_golden(rs.seqs, idx, 0.0)
    r31 = classify_reads_golden(rs.seqs, idx31, 0.0)
    def to_dev(rr):
        return {"taxon": jnp.array([r.taxon for r in rr], jnp.int32),
                "best": jnp.array([r.best for r in rr], jnp.int32),
                "nvalid": jnp.array([r.nvalid for r in rr], jnp.int32)}
    got = merge_multik_jnp(to_dev(r21), to_dev(r31), arrs)
    want = [merge_multik_golden(a, b, tax) for a, b in zip(r21, r31)]
    np.testing.assert_array_equal(np.asarray(got["taxon"]),
                                  [r.taxon for r in want])
    np.testing.assert_array_equal(np.asarray(got["best"]),
                                  [r.best for r in want])
    np.testing.assert_array_equal(np.asarray(got["nvalid"]),
                                  [r.nvalid for r in want])


def test_chunked_long_read_equivalence(world):
    """SURVEY.md §6 long-read rule: (k-1)-overlap chunking of the hit list
    is exact. Verified by classifying a long read whole vs as the padded
    batch of its chunks with concatenated hit arrays — here approximated by
    checking nvalid and assignment agree through the public path."""
    tax, genomes, idx, _ = world
    rng = np.random.default_rng(11)
    codes, taxon = genomes[3]
    long_read = codes[100:1300]  # 1200 bp "nanopore-style" read
    k = idx.meta.k
    # whole
    from pangea_tpu.golden import classify_read_golden
    whole = classify_read_golden(long_read, idx, 0.0)
    # chunked with k-1 overlap, tallies merged = concatenate hit lists
    W = 400
    chunks = [long_read[s:s + W] for s in range(0, len(long_read) - k + 1,
                                                W - (k - 1))]
    from pangea_tpu.golden.golden import _read_hits, _score_hits
    taxa = []
    nvalid = 0
    for c in chunks:
        t, nv = _read_hits(c, idx)
        taxa.append(t)
        nvalid += nv
    merged = _score_hits(np.concatenate(taxa), nvalid, tax, 0.0)
    assert merged.taxon == whole.taxon
    assert merged.best == whole.best and merged.nvalid == whole.nvalid


@pytest.mark.parametrize("w", [4, 8])
def test_classify_minimizer_bit_exact(w):
    # w>1 path: disjoint-window query minimizers (SEMANTICS.md §3 v4) must
    # be bit-exact vs golden, including short/padded reads and N runs.
    tax, genomes, idx, rs = small_world(n_reads=120, w=w, n_prob=0.03,
                                        read_len=97)
    assert idx.meta.w == w
    di = DeviceIndex.from_index(idx, confidence_threshold=0.05)
    assert di.cfg.w == w
    fn = make_classify_fn(di.cfg)
    bases = pad_batch(rs.seqs, len(rs.seqs), 120)  # pad past read length
    out = {k: np.asarray(v) for k, v in fn(di.tables, bases).items()}
    want = classify_reads_golden(rs.seqs, idx, 0.05)
    np.testing.assert_array_equal(out["nvalid"], [r.nvalid for r in want])
    np.testing.assert_array_equal(out["best"], [r.best for r in want])
    np.testing.assert_array_equal(out["taxon"], [r.taxon for r in want])


def test_minimizer_select_matches_numpy():
    from pangea_tpu.core import disjoint_query_minimizers
    from pangea_tpu.kernels import select_minimizers_jnp
    rng = np.random.default_rng(11)
    B, P, w = 16, 101, 8
    hi = rng.integers(0, 4, size=(B, P)).astype(np.uint32)
    lo = rng.integers(0, 2**31, size=(B, P)).astype(np.uint32)
    valid = rng.random((B, P)) < 0.9
    hi_m, lo_m, wv = jax.jit(select_minimizers_jnp, static_argnums=3)(
        hi, lo, valid, w)
    hi_m, lo_m, wv = map(np.asarray, (hi_m, lo_m, wv))
    for b in range(B):
        canon = (hi[b].astype(np.uint64) << np.uint64(32)) | lo[b]
        pos, wvalid = disjoint_query_minimizers(canon, valid[b], w)
        np.testing.assert_array_equal(wv[b], wvalid)
        np.testing.assert_array_equal(hi_m[b][wvalid], hi[b][pos][wvalid])
        np.testing.assert_array_equal(lo_m[b][wvalid], lo[b][pos][wvalid])


def test_query_minimizers_subset_of_build(w=8):
    # Every disjoint query window's selection must be stored by the
    # overlapping-window build pass (SEMANTICS.md §3 guarantee).
    from pangea_tpu.core import (canonical_kmers, disjoint_query_minimizers,
                                 minimizer_mask)
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, size=2000).astype(np.uint8)
    canon, valid = canonical_kmers(codes, 21)
    build_sel = set(canon[minimizer_mask(canon, valid, w)].tolist())
    pos, wvalid = disjoint_query_minimizers(canon, valid, w)
    query_sel = set(canon[pos[wvalid]].tolist())
    assert query_sel <= build_sel


def test_pscore_chunked_bit_exact(world):
    """The chunked-quadratic pscore (VERDICT r2 #3: replaces the silent
    70x sort-rank fallback past B*P^2 = 2^31) must equal both the plain
    quadratic and the sort-rank form on real laminar Euler intervals."""
    from pangea_tpu.kernels.score import (_pscore_quad_chunked,
                                          _pscore_quadratic, _pscore_ranked)
    tax, _, _, _ = world
    rng = np.random.default_rng(11)
    B, P = 37, 19                      # odd sizes exercise the pad path
    taxa = rng.integers(0, tax.num_taxa + 1, size=(B, P)).astype(np.int32)
    hit = jnp.array(taxa != 0)
    t_in = jnp.array(tax.tin[taxa])
    t_out = jnp.array(tax.tout[taxa])
    want = np.asarray(_pscore_quadratic(t_in, t_out, hit))
    # tiny max_elems forces many chunks (bc = 1 and bc = 4 regimes)
    for me in (P * P, 4 * P * P, 10**9):
        got = np.asarray(_pscore_quad_chunked(t_in, t_out, hit,
                                              max_elems=me))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(_pscore_ranked(t_in, t_out, hit))[np.asarray(hit)],
        want[np.asarray(hit)])


def test_pscore_auto_selects_chunked(world, monkeypatch):
    """auto must route big-B*P^2 / small-P shapes to the chunked quadratic
    (not sort-rank), and huge-P shapes to sort-rank."""
    from pangea_tpu.kernels import score as score_mod
    calls = []
    real = score_mod._pscore_quad_chunked

    def spy(*a, **kw):
        calls.append("chunked")
        return real(*a, **kw)

    monkeypatch.setattr(score_mod, "_pscore_quad_chunked", spy)
    monkeypatch.delenv("PANGEA_PSCORE", raising=False)
    tax, _, _, _ = world
    rng = np.random.default_rng(12)
    P = 512                            # P <= _RANKED_MIN_P, B*P^2 > 2^31
    B = 2**31 // (P * P) + 7
    taxa = rng.integers(0, tax.num_taxa + 1, size=(B, P)).astype(np.int32)
    hit = jnp.array(taxa != 0)
    t_in = jnp.array(tax.tin[taxa])
    t_out = jnp.array(tax.tout[taxa])
    got = np.asarray(score_mod._pscore(t_in, t_out, hit))
    assert calls == ["chunked"]
    want = np.asarray(score_mod._pscore_quadratic(t_in, t_out, hit))
    np.testing.assert_array_equal(got, want)


def test_multik_merge_three_way_fold(world):
    """SEMANTICS.md §9: >2 classifiers merge by a LEFT FOLD in index
    order. Device fold of three results must equal the golden fold."""
    tax, genomes, idx, rs = world
    from pangea_tpu.index import build_index
    idx17 = build_index(genomes, tax, k=17)
    idx31 = build_index(genomes, tax, k=31)
    arrs = {k: jnp.array(v) for k, v in tax.device_arrays().items()}
    rr = [classify_reads_golden(rs.seqs, ix, 0.0)
          for ix in (idx, idx17, idx31)]

    def to_dev(r):
        return {"taxon": jnp.array([x.taxon for x in r], jnp.int32),
                "best": jnp.array([x.best for x in r], jnp.int32),
                "nvalid": jnp.array([x.nvalid for x in r], jnp.int32)}

    got = to_dev(rr[0])
    for r in rr[1:]:
        got = merge_multik_jnp(got, to_dev(r), arrs)
    want = rr[0]
    for r in rr[1:]:
        want = [merge_multik_golden(a, b, tax) for a, b in zip(want, r)]
    np.testing.assert_array_equal(np.asarray(got["taxon"]),
                                  [x.taxon for x in want])
    np.testing.assert_array_equal(np.asarray(got["best"]),
                                  [x.best for x in want])
    np.testing.assert_array_equal(np.asarray(got["nvalid"]),
                                  [x.nvalid for x in want])
