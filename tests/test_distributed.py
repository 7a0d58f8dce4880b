"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arrowspace_tpu.graph import GraphParams
from arrowspace_tpu.parallel import (distributed_index_step,
                                     distributed_lambda_aware_topk,
                                     make_mesh,
                                     sharded_compute_taumode_lambdas)
from arrowspace_tpu.ops.search import batched_lambda_aware_topk
from arrowspace_tpu.taumode import TauMode, compute_taumode_lambdas
from helpers import oracle_adjacency, oracle_laplacian
from data import make_moons_hd


@pytest.fixture(scope="module")
def mesh(request):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def _setup(n=128, f=16, seed=0):
    rows = make_moons_hd(n, noise=0.08, hd_noise=0.05, dims=f, seed=seed)
    adj = oracle_adjacency(rows[:12], eps=1.0, topk=4, p=2.0, sigma=None)
    lap = oracle_laplacian(adj)[:f, :f] if adj.shape[0] >= f else None
    # build a graph over features instead (canonical shape): use transpose
    adjf = oracle_adjacency(rows.T[:, :32], eps=1.0, topk=4, p=2.0,
                            sigma=None)
    lapf = oracle_laplacian(adjf)
    return jnp.asarray(rows), jnp.asarray(lapf)


def test_sharded_lambdas_match_single_device(mesh):
    items, lap = _setup()
    single = compute_taumode_lambdas(items, lap, TauMode.median())
    sharded = sharded_compute_taumode_lambdas(items, lap, TauMode.median(),
                                              mesh)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-12)
    # result is actually sharded over the mesh
    assert len(sharded.sharding.device_set) == 8


def test_distributed_topk_matches_single_device(mesh):
    items, lap = _setup(n=256)
    lambdas = compute_taumode_lambdas(items, lap, TauMode.median())
    queries = items[:4] * 1.01
    q_lam = compute_taumode_lambdas(queries, lap, TauMode.median())
    alpha = jnp.asarray(0.8, dtype=items.dtype)

    s_single, i_single = batched_lambda_aware_topk(
        queries, q_lam, items, lambdas, alpha, k=10)
    s_dist, i_dist = distributed_lambda_aware_topk(
        queries, q_lam, items, lambdas, 0.8, 10, mesh)

    np.testing.assert_allclose(np.asarray(s_dist), np.asarray(s_single),
                               rtol=1e-12)
    # indices may differ only on exact ties; verify score-set equality and
    # index agreement away from ties
    np.testing.assert_array_equal(np.asarray(i_dist), np.asarray(i_single))


def test_distributed_search_session_matches_single(mesh):
    """The pipelined multi-chip serving session must return exactly what
    the single-program query path returns (λ prep + scoring + merged
    top-k fused into one sharded dispatch), including partial batches."""
    from arrowspace_tpu.parallel import DistributedSearchSession

    items, lap = _setup(n=256)
    lambdas = compute_taumode_lambdas(items, lap, TauMode.median())

    sess = DistributedSearchSession(items, lambdas, lap, mesh,
                                    batch_size=8, k=10, alpha=0.8,
                                    taumode=TauMode.median(), depth=2)
    sess.warmup()

    rng = np.random.default_rng(11)
    batches = [np.asarray(items[rng.integers(0, 256, 8)]) * 1.01
               for _ in range(5)] + [np.asarray(items[:3]) * 1.02]
    got = list(sess.search_stream(batches))
    assert len(got) == 6
    assert got[-1][1].shape == (3, 10)

    for qb, (s, i) in zip(batches, got):
        q = jnp.asarray(qb)
        qlam = compute_taumode_lambdas(q, lap, TauMode.median())
        s_ref, i_ref = batched_lambda_aware_topk(
            q, qlam, items, lambdas, jnp.asarray(0.8, items.dtype), k=10)
        np.testing.assert_array_equal(i, np.asarray(i_ref))
        np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-12)


def test_distributed_session_projected_index(mesh):
    """from_index over a dims-reduced index: the projected query prepares
    λ against the r x r graph while the raw query scores raw items —
    results must match the one-shot ArrowIndex.search exactly (both
    paths share the same f64 CPU backend here)."""
    from arrowspace_tpu.index import ArrowIndex
    from arrowspace_tpu.parallel import DistributedSearchSession

    rng = np.random.default_rng(17)
    centers = rng.uniform(0.2, 0.8, (6, 96))
    rows = centers[rng.integers(0, 6, 512)] + rng.normal(0, 0.05,
                                                         (512, 96))
    idx = ArrowIndex.build(rows, eps=1.0, k=5, topk=3, seed=9,
                           sampling=None, dims_reduction=True, rp_eps=0.9)
    assert idx.aspace.projection_matrix is not None

    sess = DistributedSearchSession.from_index(idx, mesh, batch_size=8,
                                               k=7, alpha=0.85)
    sess.warmup()
    q = rows[:8] * 1.01
    (s, i), = tuple(sess.search_stream([q]))
    s_ref, i_ref = idx.search(q, k=7, alpha=0.85)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-10)

    # an un-projected session over a reduced graph must refuse clearly
    with pytest.raises(ValueError, match="projection"):
        DistributedSearchSession(
            idx.aspace.data, idx.aspace.lambdas,
            jnp.asarray(idx.gl.matrix), mesh, batch_size=8, k=7)


def test_distributed_session_tall_graph_index(mesh):
    """from_index over an allow_tall_graphs energy index (graph nodes >
    F): query-λ preparation must pad instead of raising the n>F error,
    matching the single-chip session (regression: pad_tall was not
    threaded through the mesh session)."""
    from arrowspace_tpu import energymaps as en
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.energymaps import EnergyParams
    from arrowspace_tpu.index import ArrowIndex
    from arrowspace_tpu.parallel import DistributedSearchSession

    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 1, (40, 16))
    rows = centers[rng.integers(0, 40, 800)] + rng.normal(0, 0.02,
                                                          (800, 16))
    b = (ArrowSpaceBuilder().with_seed(7).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    aspace, gl = en.build_energy(
        b, rows.tolist(),
        EnergyParams(split_quantile=0.2, allow_tall_graphs=True))
    assert gl.shape()[0] > aspace.nfeatures
    idx = ArrowIndex(aspace, gl, b)

    sess = DistributedSearchSession.from_index(idx, mesh, batch_size=4,
                                               k=5, alpha=0.9)
    sess.warmup()
    (s, i), = tuple(sess.search_stream([rows[:4] * 1.01]))
    s_ref, i_ref = idx.search(rows[:4] * 1.01, k=5, alpha=0.9)
    np.testing.assert_array_equal(i, np.asarray(i_ref))


def test_distributed_index_step_runs(mesh):
    """The full device-side step compiles and executes over the mesh."""
    items, _ = _setup(n=128, f=16)
    centroids = items[:10]
    queries = items[:2] * 1.02
    params = GraphParams(eps=1.0, k=5, topk=3, p=2.0, sigma=None,
                         normalise=False, sparsity_check=False)
    lambdas, scores, idx = distributed_index_step(
        items, centroids, queries, TauMode.median(), params, 5, mesh)
    assert lambdas.shape == (128,)
    assert scores.shape == (2, 5)
    assert idx.shape == (2, 5)
    assert np.all(np.isfinite(np.asarray(scores)))


def test_distributed_pruned_matches_oracle(mesh):
    """Mesh-sharded cell screen: unflagged rows equal the full-scan
    oracle (same lowest-global-id ties); flags reduce any-shard OR."""
    from arrowspace_tpu.parallel import distributed_pruned_topk
    from arrowspace_tpu.pruned import build_cells

    rng = np.random.default_rng(11)
    cents = rng.uniform(0.2, 0.8, (8, 24))
    rows = cents[rng.integers(0, 8, 768)] \
        + rng.normal(0, 0.03, (768, 24))
    lam = rng.uniform(0, 1, 768)
    cells = build_cells(rows, lam, cap=16, seed=3, iters=4)
    assert cells.cent.shape[0] % 8 == 0   # unit axis shards evenly
    qi = rng.integers(0, 768, 12)
    q, ql = rows[qi] * 1.02, lam[qi]
    so, io = batched_lambda_aware_topk(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(rows),
        jnp.asarray(lam), jnp.asarray(0.9), k=10)
    s, i, fl = distributed_pruned_topk(
        jnp.asarray(q), jnp.asarray(ql), cells, 0.9, 10, mesh,
        m_cells=4)
    s, i, fl = np.asarray(s), np.asarray(i), np.asarray(fl)
    certified = 0
    for b in range(12):
        if not fl[b]:
            certified += 1
            np.testing.assert_array_equal(i[b], np.asarray(io)[b])
            np.testing.assert_allclose(s[b], np.asarray(so)[b],
                                       rtol=1e-12)
    # per-shard m=4 scans 32 cells total on clustered data: most of a
    # clustered batch must certify or the mesh screen is useless
    assert certified >= 8, (certified, fl)


def test_distributed_pruned_duplicate_cross_shard_tie(mesh):
    """Exact duplicates placed in DIFFERENT shards must resolve to the
    lowest global id after the mesh merge (the two-key sort upgrade
    over a plain top_k merge)."""
    from arrowspace_tpu.parallel import distributed_pruned_topk
    from arrowspace_tpu.pruned import build_cells

    rng = np.random.default_rng(13)
    rows = _clustered_rows(rng, n=512, f=16, centers=6)
    rows[400] = rows[7]
    lam = rng.uniform(0, 1, 512)
    lam[400] = lam[7]
    cells = build_cells(rows, lam, cap=8, seed=5, iters=4)
    u = cells.cent.shape[0]
    q, ql = rows[7:8] * 1.01, lam[7:8]
    # scan everything: exact, no flags, ties by global id
    s, i, fl = distributed_pruned_topk(
        jnp.asarray(q), jnp.asarray(ql), cells, 0.9, 6, mesh,
        m_cells=u // 8)
    i = np.asarray(i)
    assert not np.asarray(fl)[0]
    assert 7 in i[0] and 400 in i[0]
    assert list(i[0]).index(7) < list(i[0]).index(400)


def _clustered_rows(rng, n, f, centers):
    c = rng.uniform(0.2, 0.8, (centers, f))
    return c[rng.integers(0, centers, n)] + rng.normal(0, 0.03, (n, f))


def test_uneven_shard_raises(mesh):
    items, lap = _setup(n=130)
    lambdas = compute_taumode_lambdas(items, lap, TauMode.median())
    with pytest.raises(AssertionError, match="padded"):
        distributed_lambda_aware_topk(items[:2], lambdas[:2], items,
                                      lambdas, 0.8, 5, mesh)


def test_hierarchical_2d_topk_matches_single_device():
    """(dcn=2, ici=4) mesh: hierarchical merge must equal the flat top-k."""
    from arrowspace_tpu.parallel import (distributed_lambda_aware_topk_2d,
                                         make_mesh_2d)
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh2d = make_mesh_2d(2, 4)
    items, lap = _setup(n=256)
    lambdas = compute_taumode_lambdas(items, lap, TauMode.median())
    queries = items[:4] * 1.01
    q_lam = compute_taumode_lambdas(queries, lap, TauMode.median())

    s_single, i_single = batched_lambda_aware_topk(
        queries, q_lam, items, lambdas,
        jnp.asarray(0.8, items.dtype), k=10)
    s_2d, i_2d = distributed_lambda_aware_topk_2d(
        queries, q_lam, items, lambdas, 0.8, 10, mesh2d)

    np.testing.assert_allclose(np.asarray(s_2d), np.asarray(s_single),
                               rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(i_2d), np.asarray(i_single))


def test_streamed_matches_in_memory():
    """Out-of-core streaming (chunked) must equal the in-memory paths."""
    from arrowspace_tpu.ops.streaming import (streamed_lambda_topk,
                                              streamed_taumode_lambdas)
    from arrowspace_tpu.ops.search import batched_lambda_aware_topk
    rng = np.random.default_rng(5)
    n, f = 1000, 16
    items = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
    graph_rows = rng.uniform(0.1, 1.0, (f, 8))
    from helpers import oracle_adjacency, oracle_laplacian
    lap = oracle_laplacian(oracle_adjacency(graph_rows, eps=1.0, topk=4,
                                            p=2.0, sigma=None))

    lam_stream = streamed_taumode_lambdas(items, lap, TauMode.median(),
                                          chunk=256)
    lam_ref = np.asarray(compute_taumode_lambdas(
        jnp.asarray(items), jnp.asarray(lap, dtype=jnp.float32),
        TauMode.median()))
    np.testing.assert_allclose(lam_stream, lam_ref, rtol=1e-5)

    q = items[:4] * 1.01
    qlam = lam_ref[:4]
    s_stream, i_stream = streamed_lambda_topk(q, qlam, items, lam_ref,
                                              0.9, 10, chunk=256)
    s_ref, i_ref = batched_lambda_aware_topk(
        jnp.asarray(q), jnp.asarray(qlam), jnp.asarray(items),
        jnp.asarray(lam_ref), jnp.float32(0.9), k=10)
    np.testing.assert_allclose(s_stream, np.asarray(s_ref), rtol=1e-5)
    np.testing.assert_array_equal(i_stream, np.asarray(i_ref))


def test_sharded_clustering_invariants(mesh):
    """Mesh-sharded incremental clustering: device distance tiles, host
    rules.  Invariants of the incremental scan must hold, and the result
    must land within the single-chip chunked mode's cluster-count scale."""
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.parallel import sharded_incremental_clustering
    from arrowspace_tpu.sampling import SamplerType
    from arrowspace_tpu.clustering import _incremental_clustering_chunked

    rng = np.random.default_rng(29)
    centers = rng.uniform(0, 1, (6, 16))
    rows = centers[rng.integers(0, 6, 8192)] + rng.normal(0, 0.04,
                                                          (8192, 16))
    items = jax.device_put(jnp.asarray(rows),
                           jax.sharding.NamedSharding(
                               mesh, jax.sharding.PartitionSpec("items",
                                                                None)))

    b = ArrowSpaceBuilder()
    b.sampling = SamplerType.simple(0.6)
    s = SamplerType.simple(0.6).make(seed=5)
    cents, assigns, sizes = sharded_incremental_clustering(
        items, b, 16, 0.3, s, mesh, rounds_chunk=512)

    assert 1 <= cents.shape[0] <= 16
    assert len(assigns) == 8192
    assert sum(sizes) == sum(1 for a in assigns if a is not None)
    for a in assigns:
        assert a is None or 0 <= a < cents.shape[0]

    b2 = ArrowSpaceBuilder()
    b2.sampling = SamplerType.simple(0.6)
    s2 = SamplerType.simple(0.6).make(seed=5)
    c_chunk, _, _ = _incremental_clustering_chunked(
        b2, rows, 16, 16, 0.3, s2, chunk=512)
    assert abs(cents.shape[0] - c_chunk.shape[0]) <= 6


def test_distributed_build_step_end_to_end(mesh):
    """Sharded build -> query: clustering over the mesh feeds the
    replicated graph build, sharded λτ, and the distributed top-k — the
    full multi-chip path (SURVEY §2, build-tile sharding)."""
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.parallel import distributed_build_step

    rng = np.random.default_rng(31)
    centers = rng.uniform(0.2, 0.8, (5, 16))
    rows = centers[rng.integers(0, 5, 4096)] + rng.normal(0, 0.04,
                                                          (4096, 16))
    items = jnp.asarray(rows)
    queries = items[:4] * 1.01
    params = GraphParams(eps=1.0, k=5, topk=3, p=2.0, sigma=None,
                         normalise=False, sparsity_check=False)
    b = ArrowSpaceBuilder()
    b.sampling = None

    centroids, lambdas, scores, idx = distributed_build_step(
        items, b, queries, TauMode.median(), params, 5, mesh,
        max_clusters=12, radius=0.3)
    assert lambdas.shape == (4096,)
    assert scores.shape == (4, 5)
    # each query's own source item ranks first (clustered data)
    for qi in range(4):
        assert int(idx[qi][0]) == qi
    assert np.all(np.isfinite(np.asarray(lambdas)))


def test_sharded_clustering_tail_round(mesh):
    """shard_n not divisible by the round chunk: the clamped device
    window's results must align with the host rows (regression: the tail
    round silently paired rows with other rows' distances)."""
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.parallel import sharded_incremental_clustering
    from arrowspace_tpu.sampling import SamplerType

    rng = np.random.default_rng(61)
    centers = rng.uniform(0, 1, (6, 16))
    rows = centers[rng.integers(0, 6, 8192)] + rng.normal(0, 0.03,
                                                          (8192, 16))
    items = jax.device_put(jnp.asarray(rows),
                           jax.sharding.NamedSharding(
                               mesh, jax.sharding.PartitionSpec("items",
                                                                None)))
    b = ArrowSpaceBuilder()
    b.sampling = None
    s = SamplerType.simple(1.0).make(seed=1)
    # shard_n = 1024, chunk = 300 -> rounds of 300/300/300/124
    cents, assigns, sizes = sharded_incremental_clustering(
        items, b, 16, 0.3, s, mesh, rounds_chunk=300)
    assert len(assigns) == 8192
    assert all(a is not None for a in assigns)  # no sampling: all decided
    assert sum(sizes) == 8192
    # clustered data: every row's assigned centroid is its true nearest
    # within the relaxed radius
    d = np.linalg.norm(rows[:, None, :] - cents[None, :, :], axis=2) ** 2
    a = np.asarray(assigns)
    chosen = d[np.arange(8192), a]
    assert np.all(chosen <= 0.3 * 1.5 + 1e-9)


@pytest.fixture(scope="module")
def energy_index_800():
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.energymaps import EnergyParams, build_energy
    from arrowspace_tpu.index import ArrowIndex
    rng = np.random.default_rng(5)
    centers = rng.uniform(0, 1, (40, 16))
    rows = centers[rng.integers(0, 40, 800)] + rng.normal(0, 0.02,
                                                          (800, 16))
    b = (ArrowSpaceBuilder().with_seed(7).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    aspace, gl = build_energy(
        b, rows.tolist(),
        EnergyParams(split_quantile=0.2, allow_tall_graphs=True))
    return ArrowIndex(aspace, gl, b), rows


def test_distributed_energy_session_matches_single(mesh, energy_index_800):
    """from_index over a built energy index: the mesh session (per-shard
    z-plane + all_gather merge) must reproduce the one-shot
    search_energy API exactly on CPU/f64, incl. a partial tail batch."""
    from arrowspace_tpu.parallel import DistributedEnergySearchSession

    idx, rows = energy_index_800
    assert idx.nitems % 8 == 0, idx.nitems
    sess = DistributedEnergySearchSession.from_index(
        idx, mesh, batch_size=8, k=5, w_lambda=1.0, w_dirichlet=0.5)
    sess.warmup()
    batches = [rows[:8] * 1.01, rows[8:11] * 1.01]  # tail of 3
    got = list(sess.search_stream(batches))
    assert got[0][1].shape == (8, 5) and got[1][1].shape == (3, 5)
    for qb, (s, i) in zip(batches, got):
        s_ref, i_ref = idx.search_energy(qb, k=5, w_lambda=1.0,
                                         w_dirichlet=0.5)
        np.testing.assert_array_equal(i, np.asarray(i_ref))
        np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-9)


def test_distributed_energy_weight_sweep(mesh, energy_index_800):
    """Weights ride as closure constants per session; each pair matches
    the one-shot API (mirrors the single-chip weight-sweep test)."""
    from arrowspace_tpu.parallel import DistributedEnergySearchSession

    idx, rows = energy_index_800
    queries = rows[5:9] * 1.02
    for wl, wd in ((0.3, 1.7), (0.0, 1.0)):
        sess = DistributedEnergySearchSession.from_index(
            idx, mesh, batch_size=4, k=5, w_lambda=wl, w_dirichlet=wd)
        (s, i), = list(sess.search_stream([queries]))
        s_ref, i_ref = idx.search_energy(queries, k=5, w_lambda=wl,
                                         w_dirichlet=wd)
        np.testing.assert_array_equal(i, np.asarray(i_ref))
        np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-9)


def test_distributed_energy_session_projected_index(mesh):
    """from_index over a dims-reduced ENERGY index: queries must project
    inside the step (λ prep AND z-plane in reduced space) and match the
    one-shot search_energy exactly — regression for handing the session
    pre-projected items with no query projection."""
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.energymaps import EnergyParams, build_energy
    from arrowspace_tpu.index import ArrowIndex
    from arrowspace_tpu.parallel import DistributedEnergySearchSession

    rng = np.random.default_rng(17)
    centers = rng.uniform(0.2, 0.8, (6, 96))
    rows = centers[rng.integers(0, 6, 512)] + rng.normal(0, 0.05,
                                                         (512, 96))
    b = (ArrowSpaceBuilder().with_seed(9).with_dims_reduction(True, 0.9)
         .with_inline_sampling(None))
    aspace, gl = build_energy(
        b, rows.tolist(),
        EnergyParams(split_quantile=0.2, allow_tall_graphs=True))
    assert aspace.projection_matrix is not None
    idx = ArrowIndex(aspace, gl, b)
    assert idx.nitems % 8 == 0, idx.nitems

    sess = DistributedEnergySearchSession.from_index(idx, mesh,
                                                     batch_size=8, k=7)
    sess.warmup()
    q = rows[:8] * 1.01
    (s, i), = tuple(sess.search_stream([q]))
    s_ref, i_ref = idx.search_energy(q, k=7)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-9)


# ---------------------------------------------------------------------------
# The per-shard XLA step (ops.search.lambda_topk) + all_gather merge
# against the f64 oracle
# ---------------------------------------------------------------------------

def _oracle_topk(q, qlam, x, lam, alpha, k):
    def unit(a):
        n = np.linalg.norm(a, axis=1, keepdims=True)
        return np.where(n > 0, a / np.where(n > 0, n, 1.0), 0.0)
    cos = unit(np.asarray(q)) @ unit(np.asarray(x)).T
    dl = np.abs(np.asarray(qlam)[:, None] - np.asarray(lam)[None, :])
    s = alpha * cos + (1.0 - alpha) * (1.0 - np.minimum(dl, 1.0))
    idx = np.arange(s.shape[1])
    order = np.stack([np.lexsort((idx, -row))[:k] for row in s])
    return np.take_along_axis(s, order, axis=1), order


@pytest.mark.parametrize("k", [1, 10, 64, 128])
def test_distributed_topk_matches_f64_oracle(mesh, k):
    rng = np.random.default_rng(k)
    n, f = 8 * 256, 16
    x = rng.normal(size=(n, f))
    lam = rng.uniform(0, 1, n)
    q = rng.normal(size=(5, f))
    qlam = rng.uniform(0, 1, 5)
    s, i = distributed_lambda_aware_topk(
        jnp.asarray(q), jnp.asarray(qlam), jnp.asarray(x),
        jnp.asarray(lam), 0.8, k, mesh)
    s_o, i_o = _oracle_topk(q, qlam, x, lam, 0.8, k)
    np.testing.assert_array_equal(np.asarray(i), i_o)
    np.testing.assert_allclose(np.asarray(s), s_o, rtol=1e-12)


@pytest.mark.parametrize("rows", [
    [700, 705, 711, 760],           # all inside shard 2 (256-row shards)
    [3, 300, 1100, 2047]])          # one per shard, across the mesh
def test_distributed_duplicates_lowest_global_index(mesh, rows):
    """Exact copies of the query direction, within one shard or spread
    over shards, come back lowest GLOBAL index first."""
    rng = np.random.default_rng(1)
    n, f = 8 * 256, 16
    x = rng.uniform(0.1, 1.0, (n, f))
    q = rng.uniform(0.1, 1.0, (2, f))
    for g in rows:
        x[g] = q[0] * 2.0
    lam = np.full(n, 0.5)
    s, i = distributed_lambda_aware_topk(
        jnp.asarray(q), jnp.asarray([0.5, 0.5]), jnp.asarray(x),
        jnp.asarray(lam), 1.0, 6, mesh)
    assert list(np.asarray(i)[0][:len(rows)]) == sorted(rows)


@pytest.mark.parametrize("alpha", [1.0, 0.8])
def test_distributed_session_duplicate_storm(mesh, alpha):
    """A duplicate storm inside ONE shard through the mesh session: the
    result equals the single-device step on the same operands and the
    duplicates all come back, lowest global index first."""
    from arrowspace_tpu.parallel.distributed import (
        DistributedSearchSession)

    rng = np.random.default_rng(11)
    shard_n, f, b, k = 1024, 16, 4, 6
    n = 8 * shard_n
    items = np.asarray(rng.uniform(0.1, 1.0, (n, f)))
    q0 = np.asarray(rng.uniform(0.1, 1.0, (b, f)))
    dup_rows = [3 * shard_n + 5 + 37 * j for j in range(8)]
    for g in dup_rows:
        items[g] = q0[0]
    lambdas = np.full(n, 0.5)
    _, lap = _setup(64, f, seed=3)
    lap = jnp.asarray(np.asarray(lap)[:f, :f])

    sess = DistributedSearchSession(jnp.asarray(items),
                                    jnp.asarray(lambdas), lap, mesh, b,
                                    k=k, alpha=alpha)
    (s, i), = list(sess.search_stream([q0]))
    qlam = synthetic_qlam(q0, lap)
    s_1, i_1 = batched_lambda_aware_topk(
        jnp.asarray(q0), qlam, jnp.asarray(items), jnp.asarray(lambdas),
        jnp.asarray(alpha), k=k)
    np.testing.assert_array_equal(i, np.asarray(i_1))
    np.testing.assert_allclose(s, np.asarray(s_1), rtol=1e-12)
    assert list(i[0]) == dup_rows[:k]


def synthetic_qlam(q, lap):
    from arrowspace_tpu.taumode import select_tau_batch, synthetic_lambda_batch
    qd = jnp.asarray(q)
    return synthetic_lambda_batch(qd, lap,
                                  select_tau_batch(qd, TauMode.median()))


def test_distributed_energy_duplicate_storm(mesh):
    """Energy mesh session: copies of the query inside one shard (d² = 0)
    come back lowest global index first, matching the single-device
    energy step."""
    from arrowspace_tpu.energymaps import _energy_score_topk_chunked
    from arrowspace_tpu.parallel import DistributedEnergySearchSession

    rng = np.random.default_rng(31)
    shard_n, f, b, k = 1024, 16, 4, 6
    n = 8 * shard_n
    items = np.asarray(rng.uniform(0.1, 1.0, (n, f)))
    q0 = np.asarray(rng.uniform(0.1, 1.0, (b, f)))
    dup_rows = [5 * shard_n + 9 + 41 * j for j in range(8)]
    for g in dup_rows:
        items[g] = q0[0]
    lambdas = np.full(n, 0.5)
    _, lap = _setup(64, f, seed=3)
    lap = jnp.asarray(np.asarray(lap)[:f, :f])
    sess = DistributedEnergySearchSession(
        jnp.asarray(items), jnp.asarray(lambdas), lap, mesh, b, k=k,
        taumode=TauMode.median())
    (s, i), = list(sess.search_stream([q0]))
    qlam = synthetic_qlam(q0, lap)
    s_1, i_1 = _energy_score_topk_chunked(
        jnp.asarray(q0), qlam, jnp.asarray(items), jnp.asarray(lambdas),
        jnp.asarray(1.0), jnp.asarray(0.5), k=k)
    np.testing.assert_array_equal(i, np.asarray(i_1))
    assert list(i[0]) == dup_rows[:k]


@pytest.mark.parametrize("mode", [TauMode.median(), TauMode.mean(),
                                  TauMode.fixed(0.3),
                                  TauMode.percentile(0.25)])
def test_sharded_lambdas_every_taumode(mesh, mode):
    items, lap = _setup()
    single = compute_taumode_lambdas(items, lap, mode)
    sharded = sharded_compute_taumode_lambdas(items, lap, mode, mesh)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-12)
