"""ArrowIndex serving facade tests."""

import numpy as np
import pytest

from arrowspace_tpu.index import ArrowIndex
from data import make_moons_hd
from helpers import cosine_topk


def _index(seed=42, **kw):
    rows = make_moons_hd(80, noise=0.08, hd_noise=0.04, dims=12, seed=1)
    return rows, ArrowIndex.build(rows.tolist(), eps=1.0, k=5, topk=3,
                                  seed=seed, **kw)


def test_build_and_search_batch():
    rows, idx = _index()
    queries = rows[:4] * 1.02
    scores, ids = idx.search(queries, k=5, alpha=0.9)
    assert scores.shape == (4, 5) and ids.shape == (4, 5)
    # each query's own source item ranks first
    for b in range(4):
        assert ids[b][0] == b


def test_search_one_matches_batch():
    rows, idx = _index()
    q = rows[7] * 1.03
    single = idx.search_one(q, k=5, alpha=0.8)
    scores, ids = idx.search(q, k=5, alpha=0.8)
    assert [i for i, _ in single] == list(ids[0])


def test_alpha1_matches_cosine():
    rows, idx = _index()
    q = rows[9] * 1.01
    _, ids = idx.search(q, k=5, alpha=1.0)
    oracle_ids, _ = cosine_topk(q, rows, 5)
    assert list(ids[0]) == list(oracle_ids)


def test_save_load_roundtrip(tmp_path):
    rows, idx = _index()
    idx.save(tmp_path, "facade")
    idx2 = ArrowIndex.load(tmp_path, "facade")
    np.testing.assert_allclose(idx2.lambdas, idx.lambdas, rtol=1e-12)
    q = rows[3] * 1.02
    s1, i1 = idx.search(q, k=5, alpha=0.9)
    s2, i2 = idx2.search(q, k=5, alpha=0.9)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-9)


def test_range_and_stats():
    rows, idx = _index()
    lam = idx.lambdas
    hits = idx.range(float(lam.min()), float(lam.max()))
    assert len(hits) == idx.nitems
    st = idx.stats()
    assert st["n_items"] == 80
    assert st["graph_nodes"] == 12
    assert st["lambda_min"] <= st["lambda_mean"] <= st["lambda_max"]


def test_build_energy_facade():
    from data import make_gaussian_hd
    rows = make_gaussian_hd(90, spread=0.5, dims=96, seed=2)
    idx = ArrowIndex.build_energy(rows.tolist(), seed=5)
    assert idx.nitems == 90
    assert np.all(np.isfinite(idx.lambdas))


def test_facade_search_energy():
    from data import make_gaussian_hd
    rows = make_gaussian_hd(70, spread=0.5, dims=96, seed=3)
    idx = ArrowIndex.build_energy(rows.tolist(), seed=9)
    scores, ids = idx.search_energy(rows[:2] * 1.01, k=5)
    assert scores.shape == (2, 5)
    assert np.all(scores <= 0.0)  # negated energy distances


def test_loaded_index_resave_preserves_config(tmp_path):
    """load -> save -> load keeps the live config: a loaded index has no
    builder attached, so save() must synthesize the config from live state
    instead of falling back to defaults (which would silently change
    query-lambda preparation on the next load)."""
    from arrowspace_tpu.taumode import TauMode
    rows = make_moons_hd(80, noise=0.08, hd_noise=0.04, dims=12, seed=4)
    idx = ArrowIndex.build(rows.tolist(), eps=0.7, k=5, topk=3, seed=42,
                           taumode=TauMode.mean())
    idx.save(tmp_path, "a")
    idx2 = ArrowIndex.load(tmp_path, "a")
    assert idx2.builder is None
    idx2.save(tmp_path, "b")
    idx3 = ArrowIndex.load(tmp_path, "b")

    assert idx3.aspace.taumode == idx.aspace.taumode
    assert idx3.gl.graph_params.eps == idx.gl.graph_params.eps
    assert idx3.gl.graph_params.k == idx.gl.graph_params.k

    q = rows[5] * 1.02
    lam1 = idx.aspace.prepare_query_item(q, idx.gl)
    lam3 = idx3.aspace.prepare_query_item(q, idx3.gl)
    assert lam1 == pytest.approx(lam3, rel=1e-9)
    s1, i1 = idx.search(q, k=5, alpha=0.9)
    s3, i3 = idx3.search(q, k=5, alpha=0.9)
    np.testing.assert_array_equal(i1, i3)


def test_projected_facade_roundtrip(tmp_path):
    """ArrowIndex.save/load round-trips a dims-reduced index including the
    projection, so search results match the live index exactly."""
    from data import make_gaussian_hd
    rows = make_gaussian_hd(90, spread=0.5, dims=96, seed=8)
    idx = ArrowIndex.build(rows.tolist(), eps=1.0, k=5, seed=13,
                           dims_reduction=True, rp_eps=0.5)
    assert idx.aspace.projection_matrix is not None
    idx.save(tmp_path, "proj")
    idx2 = ArrowIndex.load(tmp_path, "proj")
    assert idx2.aspace.projection_matrix is not None

    q = rows[2] * 1.01
    s1, i1 = idx.search(q, k=5, alpha=0.9)
    s2, i2 = idx2.search(q, k=5, alpha=0.9)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-9)


def test_search_session_matches_search():
    """The compiled streaming session (fused prep+score+top-k, pipelined)
    must return the same results as the one-shot search API."""
    rows, idx = _index()
    rng = np.random.default_rng(5)
    batches = [rows[rng.integers(0, 80, 4)] * 1.02 for _ in range(6)]

    sess = idx.make_search_session(batch_size=4, k=5, alpha=0.9, depth=2)
    sess.warmup()
    got = list(sess.search_stream(batches))
    assert len(got) == 6
    for qb, (s, i) in zip(batches, got):
        s_ref, i_ref = idx.search(qb, k=5, alpha=0.9)
        np.testing.assert_array_equal(i, i_ref)
        np.testing.assert_allclose(s, s_ref, rtol=1e-9)


def test_search_session_dim_mismatch_raises():
    """A query batch with the wrong feature count must fail with a clear
    error naming both dimensions, not a jit shape error."""
    rows, idx = _index()
    sess = idx.make_search_session(batch_size=4, k=5, alpha=0.9)
    bad = np.ones((4, rows.shape[1] + 3))
    with pytest.raises(ValueError, match="features"):
        list(sess.search_stream([bad]))


def test_search_session_bf16_precision_option():
    """precision="bf16" scores with bf16 operands and f32 accumulation on
    every backend: scores track the f32 session to bf16 rounding, the
    self-match stays first, the one-shot API gives the session's
    result, and an unknown precision must be rejected."""
    rows, idx = _index()
    rng = np.random.default_rng(6)
    picks = [rng.integers(0, 80, 4) for _ in range(3)]
    batches = [rows[p] * 1.02 for p in picks]

    ref = idx.make_search_session(batch_size=4, k=5, alpha=0.9)
    bf = idx.make_search_session(batch_size=4, k=5, alpha=0.9,
                                 precision="bf16")
    for p, qb, (s_r, i_r), (s_b, i_b) in zip(
            picks, batches, ref.search_stream(batches),
            bf.search_stream(batches)):
        np.testing.assert_array_equal(i_b[:, 0], p)
        np.testing.assert_allclose(s_b, s_r, atol=2e-2)
        s_1, i_1 = idx.search(qb, k=5, alpha=0.9, precision="bf16")
        np.testing.assert_array_equal(i_1, i_b)
        np.testing.assert_allclose(s_1, s_b, rtol=1e-12)

    with pytest.raises(ValueError):
        idx.make_search_session(batch_size=4, k=5, precision="fp8")


def test_search_session_with_projection():
    """Streaming session over a dims-reduced index: queries are projected
    for lambda preparation on device, scored raw."""
    from data import make_gaussian_hd
    rows = make_gaussian_hd(90, spread=0.5, dims=96, seed=21)
    idx = ArrowIndex.build(rows.tolist(), eps=1.0, k=5, seed=23,
                           dims_reduction=True, rp_eps=0.5)
    assert idx.aspace.projection_matrix is not None
    batches = [rows[i * 3:(i + 1) * 3] * 1.01 for i in range(4)]
    sess = idx.make_search_session(batch_size=3, k=5, alpha=0.9)
    got = list(sess.search_stream(batches))
    assert len(got) == 4
    for qb, (s, i) in zip(batches, got):
        s_ref, i_ref = idx.search(qb, k=5, alpha=0.9)
        np.testing.assert_array_equal(i, i_ref)
        np.testing.assert_allclose(s, s_ref, rtol=1e-6)


def test_search_session_partial_batch():
    """A stream tail smaller than batch_size is padded (no mid-stream
    retrace) and its results sliced back."""
    rows, idx = _index()
    sess = idx.make_search_session(batch_size=8, k=5, alpha=0.9)
    batches = [rows[:8] * 1.01, rows[8:11] * 1.01]  # tail of 3
    got = list(sess.search_stream(batches))
    assert got[0][1].shape == (8, 5)
    assert got[1][1].shape == (3, 5)
    s_ref, i_ref = idx.search(batches[1], k=5, alpha=0.9)
    np.testing.assert_array_equal(got[1][1], i_ref)


def test_search_session_tall_graph_index():
    """A session over an allow_tall_graphs energy index must prepare
    query λ with padding instead of raising the n>F error."""
    from arrowspace_tpu import energymaps as en
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.energymaps import EnergyParams
    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 1, (40, 16))
    rows = centers[rng.integers(0, 40, 800)] + rng.normal(0, 0.02, (800, 16))
    b = (ArrowSpaceBuilder().with_seed(7).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    aspace, gl = en.build_energy(
        b, rows.tolist(),
        EnergyParams(split_quantile=0.2, allow_tall_graphs=True))
    assert gl.shape()[0] > aspace.nfeatures
    idx = ArrowIndex(aspace, gl, b)
    sess = idx.make_search_session(batch_size=4, k=5, alpha=0.9)
    sess.warmup()
    (s, i), = list(sess.search_stream([rows[:4] * 1.01]))
    assert s.shape == (4, 5)
    s_ref, i_ref = idx.search(rows[:4] * 1.01, k=5, alpha=0.9)
    np.testing.assert_array_equal(i, i_ref)


def test_stream_driver_host_casts_batches():
    """The driver casts batches to the session dtype on the HOST: the
    step must receive dt arrays (an f64 batch would otherwise cross
    the interconnect at double width and compile a device-side convert
    on the first production search)."""
    import jax.numpy as jnp
    from arrowspace_tpu.index import stream_search

    seen = []

    def step(q):
        seen.append((q.dtype, np.asarray(q)))
        s = jnp.zeros((4, 3), jnp.float32)
        i = jnp.zeros((4, 3), jnp.int32)
        return s, i

    batches = [np.ones((4, 8), dtype=np.float64) * 0.1,
               np.ones((4, 8), dtype=np.int32)]
    list(stream_search(step, batches, 4, 1, np.float32))
    assert [d for d, _ in seen] == [jnp.float32, jnp.float32]
    # values match a single host-side rounding of the f64 input
    np.testing.assert_array_equal(
        seen[0][1], (np.ones((4, 8)) * 0.1).astype(np.float32))


def test_warm_step_compiles_production_driver_path():
    """warm_step must push one full batch through the production stream
    driver (not just probe the step): the step sees exactly one
    driver-cast batch of the session's shape and dtype."""
    import jax.numpy as jnp
    from arrowspace_tpu.index import warm_step

    bsz, dim, k = 4, 8, 3
    step_calls = []

    def step(q):
        step_calls.append((np.asarray(q).dtype, q.shape))
        return (jnp.zeros((bsz, k), jnp.float32),
                jnp.zeros((bsz, k), jnp.int32))

    warm_step(step, bsz, dim, jnp.float32)
    assert step_calls == [(np.float32, (bsz, dim))]


def test_f64_rescore_pool_parameter():
    """rescore_pool widens the f64_rescore candidate pool; with a pool
    covering the duplicate multiplicity the exact f64 order is
    recovered even on massively duplicated corpora."""
    rng = np.random.default_rng(3)
    base = rng.uniform(0.1, 1.0, (5, 24))
    rows = base[rng.integers(0, 5, 2000)] + rng.normal(0, 1e-3, (2000, 24))
    idx = ArrowIndex.build(rows, eps=1.0, k=4, topk=3, seed=3)
    q = rows[77] * 1.001
    s1, i1 = idx.search(q, k=5, alpha=1.0, precision="f64_rescore",
                        rescore_pool=1000)
    qn = rows @ q / (np.linalg.norm(rows, axis=1) * np.linalg.norm(q))
    gt = np.lexsort((np.arange(2000), -qn))[:5]
    np.testing.assert_array_equal(i1[0], gt)
