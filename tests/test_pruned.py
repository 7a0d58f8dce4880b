"""Exact cell-screened search (arrowspace_tpu/pruned.py).

The pruning contract: a query's unflagged result equals the full-scan
oracle exactly (same ids, lowest-global-id tie order); flagged queries
fall back to the oracle path, so the SESSION result always equals the
oracle.  Bounds are validated brute-force in f64.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arrowspace_tpu.index import ArrowIndex
from arrowspace_tpu.ops.search import batched_lambda_aware_topk
from arrowspace_tpu.pruned import PrunedCells, build_cells, pruned_topk


def _clustered(n=600, f=24, centers=8, noise=0.03, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (centers, f))
    rows = c[rng.integers(0, centers, n)] + rng.normal(0, noise, (n, f))
    return rows


def _uniform(n=400, f=32, seed=5):
    return np.random.default_rng(seed).normal(size=(n, f))


# ---------------------------------------------------------------- cells


def test_build_cells_partitions_rows():
    rows = _clustered()
    lam = np.random.default_rng(0).uniform(0, 1, rows.shape[0])
    cells = build_cells(rows, lam, cap=32, seed=1, iters=4)
    ids = np.asarray(cells.ids)
    real = ids[ids >= 0]
    assert sorted(real.tolist()) == list(range(rows.shape[0]))
    # grouped rows/λ match the source at each id
    xhat = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    gx = np.asarray(cells.x)
    glam = np.asarray(cells.lam)
    pos = np.nonzero(ids >= 0)[0]
    np.testing.assert_allclose(gx[pos], xhat[ids[pos]], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(glam[pos], lam[ids[pos]], rtol=1e-6)
    # unit sizes respect cap; dummies carry the -2 radius sentinel
    u = cells.cent.shape[0]
    per_unit = ids.reshape(u, cells.cap)
    rad = np.asarray(cells.radius)
    for uu in range(u):
        members = per_unit[uu][per_unit[uu] >= 0]
        assert len(members) <= cells.cap
        if len(members) == 0:
            assert rad[uu] == -2.0


def test_cell_bounds_dominate_member_scores():
    """Brute-force f64 check of the pruning inequality pruned_topk
    actually uses — the spherical-cap supremum: for every unit and a
    batch of queries,

      U'(q, unit) = α·capsup(q̂·ĉ, cosr, sinr) − c1·min(dmin, 1)
                  >= max member shifted score,

    where capsup = 1 if c >= cosr else c·cosr + √(1−c²)·sinr."""
    rows = _clustered(n=300, f=16, seed=7)
    lam = np.random.default_rng(1).uniform(0, 2, 300)
    cells = build_cells(rows, lam, cap=16, seed=2, iters=4)
    alpha = 0.8
    c1 = 1 - alpha
    rng = np.random.default_rng(9)
    queries = rng.normal(size=(5, 16))
    qlam = rng.uniform(0, 2, 5)
    qhat = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    xhat = rows / np.linalg.norm(rows, axis=1, keepdims=True)

    ids = np.asarray(cells.ids)
    cent = np.asarray(cells.cent, dtype=np.float64)
    cosr = np.asarray(cells.cosr, dtype=np.float64)
    sinr = np.asarray(cells.sinr, dtype=np.float64)
    lo = np.asarray(cells.lam_lo, dtype=np.float64)
    hi = np.asarray(cells.lam_hi, dtype=np.float64)
    u = cent.shape[0]
    per_unit = ids.reshape(u, cells.cap)
    for b in range(5):
        for uu in range(u):
            members = per_unit[uu][per_unit[uu] >= 0]
            if len(members) == 0:
                continue
            s = alpha * (xhat[members] @ qhat[b]) - c1 * np.minimum(
                np.abs(qlam[b] - lam[members]), 1.0)
            dmin = max(0.0, lo[uu] - qlam[b], qlam[b] - hi[uu])
            c = float(qhat[b] @ cent[uu])
            if c >= cosr[uu]:
                capsup = 1.0
            else:
                capsup = c * cosr[uu] \
                    + np.sqrt(max(0.0, 1.0 - c * c)) * sinr[uu]
            bound = alpha * capsup - c1 * min(dmin, 1.0)
            assert bound >= s.max() - 1e-12
            # slack-free cross-check from raw member geometry: the cap
            # supremum is never weaker than the old additive
            # Cauchy-Schwarz form it replaced (q̂·ĉ + max‖x̂−ĉ‖).  (The
            # STORED cosr/sinr carry conservative slacks that near
            # θr=0 inflate sinr by √(2·slack) ≈ 1.4e-3, so the
            # comparison must use slack-free values.)
            cosr0 = float(np.clip((xhat[members] @ cent[uu]).min(),
                                  -1.0, 1.0))
            sinr0 = np.sqrt(max(0.0, 1.0 - cosr0 * cosr0))
            rad0 = float(np.sqrt(
                ((xhat[members] - cent[uu]) ** 2).sum(axis=1).max()))
            cap0 = 1.0 if c >= cosr0 else c * cosr0 \
                + np.sqrt(max(0.0, 1.0 - c * c)) * sinr0
            assert cap0 <= min(1.0, c + rad0) + 1e-12


def test_build_cells_large_n_knobs():
    """n_clusters + lloyd_sample (the large-N path): clusters larger
    than cap split into λ-sorted units; the partition stays exact and
    the screen still certifies clustered queries."""
    rows = _clustered(n=600, f=24, seed=71)
    lam = np.random.default_rng(40).uniform(0, 1, 600)
    cells = build_cells(rows, lam, cap=32, seed=1, iters=4,
                        n_clusters=8, lloyd_sample=200)
    ids = np.asarray(cells.ids)
    real = ids[ids >= 0]
    assert sorted(real.tolist()) == list(range(600))
    # 8 clusters of ~75 rows -> >= 8 units, each <= cap
    assert cells.n_units >= 8
    rng = np.random.default_rng(41)
    queries = rows[rng.integers(0, 600, 6)] * 1.02
    qlam = lam[rng.integers(0, 600, 6)]
    so, io = _oracle(queries, qlam, rows, lam, 0.9, 10)
    sp, ip, fl = _run_pruned(cells, queries, qlam, 0.9, 10, m_cells=10)
    for b in range(6):
        if not fl[b]:
            np.testing.assert_array_equal(ip[b], io[b])
    assert fl.sum() <= 2


def test_build_cells_device_partitions_and_bounds():
    """The device-resident build: exact partition, grouped values match
    the _safe_unit-normalised source, and the f32/_DEV_META_SLACK
    bounds still dominate member scores (brute-force in f64)."""
    from arrowspace_tpu.pruned import build_cells_device
    rows = _clustered(n=500, f=16, centers=10, seed=73)
    lam = np.random.default_rng(42).uniform(0, 2, 500)
    cells = build_cells_device(rows, lam, cap=16, seed=2, iters=4)
    ids = np.asarray(cells.ids)
    real = ids[ids >= 0]
    assert sorted(real.tolist()) == list(range(500))
    xhat = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    gx = np.asarray(cells.x)
    pos = np.nonzero(ids >= 0)[0]
    np.testing.assert_allclose(gx[pos], xhat[ids[pos]], rtol=1e-6,
                               atol=1e-9)
    # brute-force domination of the stored (slacked) cap bound
    alpha, c1 = 0.8, 0.2
    rng = np.random.default_rng(43)
    queries = rng.normal(size=(5, 16))
    qhat = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    qlam = rng.uniform(0, 2, 5)
    cent = np.asarray(cells.cent, dtype=np.float64)
    cosr = np.asarray(cells.cosr, dtype=np.float64)
    sinr = np.asarray(cells.sinr, dtype=np.float64)
    lo = np.asarray(cells.lam_lo, dtype=np.float64)
    hi = np.asarray(cells.lam_hi, dtype=np.float64)
    u = cent.shape[0]
    per_unit = ids.reshape(u, cells.cap)
    for b in range(5):
        for uu in range(u):
            members = per_unit[uu][per_unit[uu] >= 0]
            if len(members) == 0:
                assert np.asarray(cells.radius)[uu] == -2.0
                continue
            s = alpha * (xhat[members] @ qhat[b]) - c1 * np.minimum(
                np.abs(qlam[b] - lam[members]), 1.0)
            dmin = max(0.0, lo[uu] - qlam[b], qlam[b] - hi[uu])
            c = float(qhat[b] @ cent[uu])
            capsup = 1.0 if c >= cosr[uu] else c * cosr[uu] \
                + np.sqrt(max(0.0, 1.0 - c * c)) * sinr[uu]
            bound = alpha * capsup - c1 * min(dmin, 1.0)
            assert bound >= s.max() - 1e-9, (b, uu)


def test_build_cells_device_edge_cases():
    """Single-unit corpora and zero rows: the device build must keep
    the full-sphere cap on degenerate geometry and never lose a row."""
    from arrowspace_tpu.pruned import build_cells_device
    # n < cap -> one cluster, one unit
    rows = _clustered(n=40, f=8, centers=2, seed=79)
    lam = np.random.default_rng(50).uniform(0, 1, 40)
    cells = build_cells_device(rows, lam, cap=64, seed=1, iters=2)
    ids = np.asarray(cells.ids)
    assert sorted(ids[ids >= 0].tolist()) == list(range(40))
    assert cells.n_units == 1
    # a zero row: _safe_unit maps it to the zero vector; it must stay
    # in the partition and the containing unit's bound stays sound
    rows2 = _clustered(n=60, f=8, centers=2, seed=83)
    rows2[17] = 0.0
    lam2 = np.random.default_rng(51).uniform(0, 1, 60)
    cells2 = build_cells_device(rows2, lam2, cap=8, seed=2, iters=2)
    ids2 = np.asarray(cells2.ids)
    assert sorted(ids2[ids2 >= 0].tolist()) == list(range(60))
    # the zero row's unit has a wide cap (the zero vector is far from
    # any unit centroid in d2), so its bound saturates high — find it
    u0 = int(np.nonzero(ids2 == 17)[0][0]) // cells2.cap
    assert np.asarray(cells2.radius)[u0] > 0.9  # ||0 - chat|| = 1


def test_build_cells_device_session_matches_full_search():
    """A session on device-built cells (the production large-N path)
    equals the full search exactly, certified rows included."""
    from arrowspace_tpu.pruned import PrunedSearchSession, \
        build_cells_device
    rows, idx = _pruned_index(n=700)
    cells = build_cells_device(idx.aspace.data, idx.aspace.lambdas,
                               cap=32, seed=5, n_clusters=16,
                               lloyd_sample=300)
    sess = PrunedSearchSession(idx, 8, k=5, alpha=0.9, cells=cells)
    sess.warmup()
    rng = np.random.default_rng(44)
    queries = rows[rng.integers(0, rows.shape[0], 8)] * 1.03
    sp, ip = sess.search(queries)
    so, io = idx.search(queries, k=5, alpha=0.9)
    np.testing.assert_array_equal(ip, io)
    np.testing.assert_allclose(sp, so, rtol=1e-12)


# ------------------------------------------------------------ pruned_topk


def _oracle(queries, qlam, rows, lam, alpha, k):
    s, i = batched_lambda_aware_topk(
        jnp.asarray(queries), jnp.asarray(qlam), jnp.asarray(rows),
        jnp.asarray(lam), jnp.asarray(alpha), k=k)
    return np.asarray(s), np.asarray(i)


def _run_pruned(cells, queries, qlam, alpha, k, m_cells, margin=1e-3):
    s, i, fl = pruned_topk(
        jnp.asarray(queries), jnp.asarray(qlam), cells.x, cells.lam,
        cells.ids, cells.cent, cells.radius, cells.cosr, cells.sinr,
        cells.lam_lo, cells.lam_hi, alpha, k=k, m_cells=m_cells,
        cap=cells.cap, margin=margin)
    return np.asarray(s), np.asarray(i), np.asarray(fl)


def test_pruned_matches_oracle_on_clustered_data():
    rows = _clustered(n=800, f=24, seed=11)
    lam = np.random.default_rng(2).uniform(0, 1, 800)
    cells = build_cells(rows, lam, cap=32, seed=3)
    rng = np.random.default_rng(4)
    queries = rows[rng.integers(0, 800, 6)] * 1.02
    qlam = lam[rng.integers(0, 800, 6)]
    for alpha in (1.0, 0.9, 0.0):
        so, io = _oracle(queries, qlam, rows, lam, alpha, 10)
        sp, ip, fl = _run_pruned(cells, queries, qlam, alpha, 10,
                                 m_cells=12)
        for b in range(6):
            if not fl[b]:
                np.testing.assert_array_equal(ip[b], io[b])
                np.testing.assert_allclose(sp[b], so[b], rtol=1e-12)
        if alpha >= 0.9:
            # clustered data must actually certify most queries, or the
            # screen is useless
            assert fl.sum() <= 2, (alpha, fl)
        # α=0 is a pure-λ search over cells built on COSINE geometry
        # with λ random inside each cell — bounds are legitimately
        # vacuous there (most queries flag, results stay exact via the
        # fallback); only the exactness of unflagged rows is asserted.


def test_pruned_scanning_all_units_is_exact_and_unflagged():
    """m_cells == all units -> full coverage, next bound is -inf, no
    flags, exact equality (the degenerate-exhaustive anchor)."""
    rows = _clustered(n=300, f=16, seed=13)
    lam = np.random.default_rng(3).uniform(0, 1, 300)
    cells = build_cells(rows, lam, cap=16, seed=1)
    u = cells.cent.shape[0]
    queries = _uniform(4, 16, seed=6)  # adversarial queries
    qlam = np.random.default_rng(7).uniform(0, 1, 4)
    so, io = _oracle(queries, qlam, rows, lam, 0.7, 7)
    sp, ip, fl = _run_pruned(cells, queries, qlam, 0.7, 7, m_cells=u)
    assert not fl.any()
    np.testing.assert_array_equal(ip, io)
    np.testing.assert_allclose(sp, so, rtol=1e-12)


def test_pruned_flags_when_bounds_cannot_certify():
    """Uniform high-d data: cosine bounds are vacuous, so with few
    scanned cells the kernel must FLAG rather than silently return an
    uncertified result."""
    rows = _uniform(n=512, f=64, seed=17)
    lam = np.random.default_rng(5).uniform(0, 1, 512)
    cells = build_cells(rows, lam, cap=32, seed=2)
    queries = _uniform(3, 64, seed=19)
    qlam = np.random.default_rng(6).uniform(0, 1, 3)
    sp, ip, fl = _run_pruned(cells, queries, qlam, 0.9, 10, m_cells=2)
    so, io = _oracle(queries, qlam, rows, lam, 0.9, 10)
    for b in range(3):
        if not fl[b]:
            np.testing.assert_array_equal(ip[b], io[b])
    assert fl.any()  # at least one uncertifiable query on this data


def test_pruned_duplicate_tie_order_matches_oracle():
    """Exact duplicates far apart in id space (and in different units)
    must resolve to the LOWEST global id, like lax.top_k."""
    rows = _clustered(n=200, f=16, seed=23)
    rows[150] = rows[10]          # duplicate pair across the corpus
    lam = np.random.default_rng(8).uniform(0, 1, 200)
    lam[150] = lam[10]
    cells = build_cells(rows, lam, cap=8, seed=4)
    q = rows[10:11] * 1.02
    qlam = lam[10:11]
    so, io = _oracle(q, qlam, rows, lam, 0.9, 6)
    sp, ip, fl = _run_pruned(cells, q, qlam, 0.9, 6,
                             m_cells=cells.cent.shape[0])
    assert not fl[0]
    assert 10 in io[0] and 150 in io[0]
    np.testing.assert_array_equal(ip[0], io[0])
    # the duplicate pair is bitwise-tied in the pruned scorer too
    p10 = list(ip[0]).index(10)
    p150 = list(ip[0]).index(150)
    assert sp[0][p10] == sp[0][p150]


def test_pruned_flags_underfilled_topk():
    """k larger than the gathered real rows must flag, not fabricate."""
    rows = _clustered(n=100, f=16, seed=29)
    lam = np.random.default_rng(9).uniform(0, 1, 100)
    cells = build_cells(rows, lam, cap=4, seed=5)
    q = rows[:1] * 1.01
    sp, ip, fl = _run_pruned(cells, q, lam[:1], 0.9, 8, m_cells=1)
    assert fl[0]  # 1 unit * cap 4 < k=8


# ------------------------------------------------------------- session


def _pruned_index(n=700, f=24, seed=31):
    rows = _clustered(n=n, f=f, seed=seed)
    idx = ArrowIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=7)
    return rows, idx


def test_session_matches_full_search():
    rows, idx = _pruned_index()
    sess = idx.make_pruned_session(batch_size=8, k=5, alpha=0.9, cap=32,
                                   seed=1)
    sess.warmup()
    rng = np.random.default_rng(12)
    queries = rows[rng.integers(0, rows.shape[0], 8)] * 1.03
    sp, ip = sess.search(queries)
    so, io = idx.search(queries, k=5, alpha=0.9)
    np.testing.assert_array_equal(ip, io)
    np.testing.assert_allclose(sp, so, rtol=1e-12)
    assert sess.queries_total >= 8


def test_session_fallback_equals_oracle_on_adversarial_data():
    """Uniform data + tiny m_cells: everything flags, the fallback path
    carries the result, and it still equals the full search exactly."""
    rows = _uniform(n=400, f=32, seed=37)
    idx = ArrowIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=7)
    sess = idx.make_pruned_session(batch_size=4, k=6, alpha=0.9, cap=32,
                                   m_cells=1, seed=2)
    queries = _uniform(4, 32, seed=41)
    sp, ip = sess.search(queries)
    so, io = idx.search(queries, k=6, alpha=0.9)
    np.testing.assert_array_equal(ip, io)
    np.testing.assert_allclose(sp, so, rtol=1e-12)
    assert sess.flag_rate > 0.5


def test_session_partial_batch_and_single_query():
    rows, idx = _pruned_index(n=400)
    sess = idx.make_pruned_session(batch_size=8, k=5, seed=3)
    sp, ip = sess.search(rows[42] * 1.02)       # single 1-D query
    assert sp.shape == (1, 5) and ip[0][0] == 42
    sp3, ip3 = sess.search(rows[:3] * 1.02)     # partial batch
    assert sp3.shape == (3, 5)
    for b in range(3):
        assert ip3[b][0] == b


def test_session_validation():
    rows, idx = _pruned_index(n=300)
    with pytest.raises(ValueError, match=r"\[1, 512\]"):
        idx.make_pruned_session(batch_size=1024)
    sess = idx.make_pruned_session(batch_size=4, seed=1)
    with pytest.raises(ValueError, match="batch"):
        sess.search(rows[:5])
    with pytest.raises(ValueError, match="dim"):
        sess.search(np.ones((2, 7)))


# ---------------------------------------------------- two-level (union)


def _run_union(cells, queries, qlam, alpha, k, m_vote, s_cells,
               margin=1e-3):
    from arrowspace_tpu.pruned import pruned_topk_union
    s, i, fl = pruned_topk_union(
        jnp.asarray(queries), jnp.asarray(qlam), cells.x, cells.lam,
        cells.ids, cells.cent, cells.radius, cells.cosr, cells.sinr,
        cells.lam_lo, cells.lam_hi, alpha, k=k, m_vote=m_vote,
        s_cells=s_cells, cap=cells.cap, margin=margin)
    return np.asarray(s), np.asarray(i), np.asarray(fl)


def test_extract_topk_lowest_id_matches_two_key_sort():
    """The masked-pass extraction (k <= 32 path) must equal the two-key
    (-score, id) sort on data dense with exact ties."""
    from arrowspace_tpu.pruned import _extract_topk_lowest_id
    rng = np.random.default_rng(2)
    # quantised scores -> many exact ties across shuffled id space
    sc = (rng.integers(0, 7, (5, 96)) / 7.0).astype(np.float64)
    ids = rng.permutation(960)[:96].astype(np.int32)
    sc[0, :50] = -np.inf                      # padding-heavy row
    s_j = jnp.asarray(sc)
    i_j = jnp.asarray(ids)
    for k in (1, 8, 13):
        ts, ti = _extract_topk_lowest_id(s_j, i_j, k)
        gid2 = jnp.broadcast_to(i_j[None, :], sc.shape)
        sneg, sid = jax.lax.sort((-s_j, gid2), num_keys=2, dimension=1)
        np.testing.assert_array_equal(np.asarray(ti),
                                      np.asarray(sid[:, :k]))
        np.testing.assert_array_equal(np.asarray(ts),
                                      np.asarray(-sneg[:, :k]))


def test_union_matches_oracle_on_hot_region_batch():
    """The union path's winning regime: a batch whose queries share a
    few hot regions (union of needed cells ≪ per-query gathers).  A
    cell certifies a query only if every unit whose cap reaches the
    query's k-th score is in the union, so batches spread over MANY
    clusters legitimately flag (covered by the overflow test) — the
    locality regime is where the certification must actually fire."""
    rows = _clustered(n=900, f=24, seed=43)
    lam = np.random.default_rng(21).uniform(0, 1, 900)
    cells = build_cells(rows, lam, cap=32, seed=3)
    rng = np.random.default_rng(22)
    # 24 queries around three corpus rows -> <= 3 hot clusters
    base = rows[[5, 300, 700]]
    queries = np.repeat(base, 8, axis=0) \
        * (1.0 + 0.02 * rng.uniform(size=(24, 1)))
    qlam = lam[np.repeat([5, 300, 700], 8)]
    for alpha in (1.0, 0.9):
        so, io = _oracle(queries, qlam, rows, lam, alpha, 10)
        sp, ip, fl = _run_union(cells, queries, qlam, alpha, 10,
                                m_vote=6, s_cells=24)
        for b in range(24):
            if not fl[b]:
                np.testing.assert_array_equal(ip[b], io[b])
                np.testing.assert_allclose(sp[b], so[b], rtol=1e-12)
        # the shared union must certify most of a hot-region batch
        assert fl.sum() <= 6, (alpha, fl.sum())


def test_union_all_units_is_exact_and_unflagged():
    """s_cells == all units -> the union covers the corpus: no flags,
    bitwise the oracle even for adversarial queries."""
    rows = _clustered(n=300, f=16, seed=47)
    lam = np.random.default_rng(23).uniform(0, 1, 300)
    cells = build_cells(rows, lam, cap=16, seed=1)
    u = cells.cent.shape[0]
    queries = _uniform(20, 16, seed=48)
    qlam = np.random.default_rng(24).uniform(0, 1, 20)
    so, io = _oracle(queries, qlam, rows, lam, 0.7, 7)
    sp, ip, fl = _run_union(cells, queries, qlam, 0.7, 7,
                            m_vote=4, s_cells=u)
    assert not fl.any()
    np.testing.assert_array_equal(ip, io)
    np.testing.assert_allclose(sp, so, rtol=1e-12)


def test_union_budget_overflow_flags_not_wrong():
    """A union budget far below the batch's spread of cells must FLAG
    the queries it cannot certify — and every unflagged row still
    equals the oracle (soundness under overflow, the property that
    makes truncation safe)."""
    rows = _clustered(n=800, f=24, centers=20, seed=53)
    lam = np.random.default_rng(25).uniform(0, 1, 800)
    cells = build_cells(rows, lam, cap=16, seed=2)
    rng = np.random.default_rng(26)
    queries = rows[rng.integers(0, 800, 32)] * 1.02
    qlam = lam[rng.integers(0, 800, 32)]
    so, io = _oracle(queries, qlam, rows, lam, 0.9, 8)
    sp, ip, fl = _run_union(cells, queries, qlam, 0.9, 8,
                            m_vote=4, s_cells=2)   # starved budget
    assert fl.any()
    for b in range(32):
        if not fl[b]:
            np.testing.assert_array_equal(ip[b], io[b])
            np.testing.assert_allclose(sp[b], so[b], rtol=1e-12)


def test_union_duplicate_tie_order_matches_oracle():
    rows = _clustered(n=240, f=16, seed=59)
    rows[190] = rows[12]
    lam = np.random.default_rng(27).uniform(0, 1, 240)
    lam[190] = lam[12]
    cells = build_cells(rows, lam, cap=8, seed=4)
    u = cells.cent.shape[0]
    q = np.repeat(rows[12:13] * 1.02, 20, axis=0)
    qlam = np.repeat(lam[12:13], 20)
    so, io = _oracle(q, qlam, rows, lam, 0.9, 6)
    sp, ip, fl = _run_union(cells, q, qlam, 0.9, 6, m_vote=4,
                            s_cells=u)
    assert not fl.any()
    np.testing.assert_array_equal(ip, io)
    assert 12 in ip[0] and 190 in ip[0]


def test_union_session_matches_full_search():
    """batch_size > 16 routes to the union step; the session result
    (certified + fallback rows) equals the full search exactly."""
    rows, idx = _pruned_index(n=900)
    sess = idx.make_pruned_session(batch_size=32, k=5, alpha=0.9,
                                   cap=32, seed=1, m_vote=6,
                                   union_cells=20)
    sess.warmup()
    rng = np.random.default_rng(28)
    queries = rows[rng.integers(0, rows.shape[0], 32)] * 1.03
    sp, ip = sess.search(queries)
    so, io = idx.search(queries, k=5, alpha=0.9)
    np.testing.assert_array_equal(ip, io)
    np.testing.assert_allclose(sp, so, rtol=1e-12)
    # partial batch through the union step
    sp2, ip2 = sess.search(queries[:5])
    np.testing.assert_array_equal(ip2, io[:5])


def test_auto_budget_grows_union_until_flags_clear():
    """A starved union budget on hot-region traffic must grow under
    auto_budget until the flag rate drops below target — and every
    result along the way equals the full search (growth is a latency
    policy, never a correctness one).  Measured trajectory this test
    pins (CPU/f64): flags 32 -> 32 -> 21 -> 0 as S grows 2 -> 4 -> 8
    -> 12 (the N/4-row cap)."""
    rows = _clustered(n=800, f=24, centers=20, seed=61)
    idx = ArrowIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=7)
    sess = idx.make_pruned_session(batch_size=32, k=5, alpha=0.9,
                                   cap=16, seed=2, m_vote=4,
                                   union_cells=2, auto_budget=True)
    sess.auto_window = 32          # judge each batch on its own
    rng = np.random.default_rng(30)
    base = rows[[5, 300, 700]]     # 3 hot regions
    last_flags = None
    for _ in range(8):
        queries = np.repeat(base, 11, axis=0)[:32] \
            * (1.0 + 0.02 * rng.uniform(size=(32, 1)))
        before = sess.flagged_total
        sp, ip = sess.search(queries)
        last_flags = sess.flagged_total - before
        so, io = idx.search(queries, k=5, alpha=0.9)
        np.testing.assert_array_equal(ip, io)
        np.testing.assert_allclose(sp, so, rtol=1e-12)
    assert sess.budget_growths >= 1
    assert sess.union_cells > 2
    # the growth cap: gathered rows stay under ~N/4
    assert sess.union_cells * sess.cells.cap <= max(
        800 // 4, sess.cells.cap)
    # with the grown budget the hot-region batch certifies
    assert last_flags <= 4, last_flags


def test_auto_budget_grows_m_cells_at_small_batch():
    """The B <= 16 regime grows m_cells under the same policy; on
    adversarial uniform data growth runs to the cap and stops (results
    stay exact via the fallback throughout)."""
    rows = _uniform(n=1024, f=32, seed=67)
    idx = ArrowIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=7)
    sess = idx.make_pruned_session(batch_size=4, k=5, alpha=0.9, cap=8,
                                   m_cells=1, seed=3, auto_budget=True)
    sess.auto_window = 4
    rng = np.random.default_rng(31)
    for _ in range(12):
        queries = rng.normal(size=(4, 32))
        sp, ip = sess.search(queries)
        qcheck = queries
        so, io = idx.search(qcheck, k=5, alpha=0.9)
        np.testing.assert_array_equal(ip, io)
    assert sess.budget_growths >= 1
    assert sess.m_cells <= sess._budget_max
    # uniform data keeps flagging at the cap: growth must have stopped
    # AT the cap rather than run away
    assert sess.m_cells == sess._budget_max


def test_auto_budget_idle_below_target():
    """Hot, certifiable traffic must never trigger growth."""
    rows, idx = _pruned_index(n=700)
    sess = idx.make_pruned_session(batch_size=32, k=5, alpha=0.9,
                                   cap=32, seed=1, m_vote=6,
                                   union_cells=24, auto_budget=True)
    sess.warmup()                  # warmup must not feed the window
    base = rows[5]
    rng = np.random.default_rng(33)
    for _ in range(4):
        queries = np.repeat(base[None, :], 32, axis=0) \
            * (1.0 + 0.01 * rng.uniform(size=(32, 1)))
        sess.search(queries)
    assert sess.budget_growths == 0
    assert sess.union_cells == 24


def test_session_device_engine_and_knobs():
    """make_pruned_session(engine='device', n_clusters, lloyd_sample)
    routes through build_cells_device and still equals the full
    search."""
    rows, idx = _pruned_index(n=600)
    sess = idx.make_pruned_session(batch_size=8, k=5, alpha=0.9,
                                   cap=32, seed=4, engine="device",
                                   n_clusters=24, lloyd_sample=300)
    rng = np.random.default_rng(45)
    queries = rows[rng.integers(0, rows.shape[0], 8)] * 1.02
    sp, ip = sess.search(queries)
    so, io = idx.search(queries, k=5, alpha=0.9)
    np.testing.assert_array_equal(ip, io)
    np.testing.assert_allclose(sp, so, rtol=1e-12)


def test_cells_save_load_roundtrip(tmp_path):
    """save_cells/load_cells: bitwise metadata round trip, and a
    session on loaded cells returns exactly what the builder session
    returns."""
    from arrowspace_tpu.pruned import (PrunedSearchSession, load_cells,
                                       save_cells)
    rows, idx = _pruned_index(n=500)
    cells = build_cells(idx.aspace.data, idx.aspace.lambdas, cap=32,
                        seed=6)
    p = str(tmp_path / "cells")
    save_cells(cells, p)
    loaded = load_cells(p)
    assert loaded.cap == cells.cap and loaded.n_units == cells.n_units
    for f in ("x", "lam", "ids", "cent", "radius", "cosr", "sinr",
              "lam_lo", "lam_hi"):
        np.testing.assert_array_equal(np.asarray(getattr(loaded, f)),
                                      np.asarray(getattr(cells, f)))
    q = rows[7:11] * 1.01
    s1 = PrunedSearchSession(idx, 4, k=5, cells=cells)
    s2 = PrunedSearchSession(idx, 4, k=5, cells=loaded)
    np.testing.assert_array_equal(s1.search(q)[1], s2.search(q)[1])
    with pytest.raises(ValueError, match="format"):
        bad = dict(np.load(p + ".npz"))
        bad["format"] = np.int64(99)
        np.savez(p + "_bad", **bad)
        load_cells(p + "_bad")


def test_session_reuses_prebuilt_cells():
    rows, idx = _pruned_index(n=300)
    from arrowspace_tpu.pruned import PrunedSearchSession
    cells = build_cells(idx.aspace.data, idx.aspace.lambdas, cap=32,
                        seed=9)
    s1 = PrunedSearchSession(idx, 4, k=5, cells=cells)
    s2 = idx.make_pruned_session(batch_size=4, k=5, cap=32, seed=9)
    q = rows[5:9] * 1.01
    np.testing.assert_array_equal(s1.search(q)[1], s2.search(q)[1])


def test_union_partial_batch_pads_do_not_displace_votes():
    """Partial batches pad by CYCLIC REPLICATION of the real queries:
    pad rows vote for cells the real queries already want, so the vote
    order the union gathers by is preserved.  Constant pad rows (the
    pre-fix behaviour) would put their m_vote junk cells in the top
    vote stratum and displace real cells from a tight union budget —
    flagging every real query on a batch that certifies when full."""
    rows = _clustered(n=800, f=24, centers=20, seed=44)
    idx = ArrowIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=7)
    sess = idx.make_pruned_session(batch_size=32, k=5, alpha=0.9,
                                   cap=16, seed=2, m_vote=4,
                                   union_cells=6)
    sess.warmup()
    base = rows[[5, 300]] * 1.01   # 2 hot-region queries

    before = sess.flagged_total
    s2, i2 = sess.search(base)     # 2 real rows, 30 pad rows
    flags_partial = sess.flagged_total - before
    assert flags_partial == 0      # replication pads certify

    # negative control — the pre-fix constant padding displaces the
    # real queries' cells from the 6-cell union and flags BOTH rows
    q_ones = np.pad(base.astype(np.float64), ((0, 30), (0, 0)),
                    constant_values=1.0).astype(np.dtype(sess._dt))
    _, _, fl_ones, _ = sess._step(jnp.asarray(q_ones))
    assert int(np.asarray(fl_ones)[:2].sum()) == 2

    so, io = idx.search(base, k=5, alpha=0.9)
    np.testing.assert_array_equal(i2, io)
    np.testing.assert_allclose(s2, so, rtol=1e-12)


def test_union_kernel_large_batch_exactness():
    """The union KERNEL stays exact past the session's 512 gate (the
    gate is a measured LATENCY boundary, not a correctness one — r5c:
    at certifying budgets the one-pass streaming accumulator beats the
    union's k-pass extraction for B > 512, see pruned.py's docstring).
    640 queries over a 900-row corpus, union = all units: unflagged
    rows equal the full-scan oracle."""
    rows = _clustered(n=900, f=24, centers=12, seed=31)
    lam = np.random.default_rng(32).uniform(0, 1, 900)
    cells = build_cells(rows, lam, cap=32, seed=1, iters=4)
    rng = np.random.default_rng(33)
    qi = rng.integers(0, 900, 640)
    queries = rows[qi] * 1.02
    qlam = lam[qi]
    sp, ip, fl = _run_union(cells, queries, qlam, 0.9, 5, m_vote=6,
                            s_cells=cells.cent.shape[0])
    assert not fl.any()
    so, io = _oracle(queries, qlam, rows, lam, 0.9, 5)
    np.testing.assert_array_equal(ip, io)


def test_pruned_k_above_32_sort_fallback_matches_oracle():
    """k > 32 routes _extract_topk_lowest_id to the two-key sort (the
    masked passes are capped at 32); both pruned kernels must still
    equal the full-scan oracle there — ids, scores, and the
    lowest-global-id tie order the sort implements directly."""
    rows = _clustered(n=700, f=24, centers=10, seed=51)
    lam = np.random.default_rng(52).uniform(0, 1, 700)
    cells = build_cells(rows, lam, cap=64, seed=1, iters=4)
    rng = np.random.default_rng(53)
    qi = rng.integers(0, 700, 8)
    queries = rows[qi] * 1.02
    qlam = lam[qi]
    k = 40
    so, io = _oracle(queries, qlam, rows, lam, 0.9, k)

    sp, ip, fl = _run_pruned(cells, queries, qlam, 0.9, k,
                             m_cells=cells.cent.shape[0])
    assert not fl.any()          # all units screened -> certified
    np.testing.assert_array_equal(ip, io)
    np.testing.assert_allclose(sp, so, rtol=1e-12)

    up, ui, ufl = _run_union(cells, queries, qlam, 0.9, k, m_vote=4,
                             s_cells=cells.cent.shape[0])
    assert not ufl.any()
    np.testing.assert_array_equal(ui, io)


def _zero_row_cells(f, cap=8):
    """Two hand-grouped units: unit 0 = rows along d plus one ZERO row,
    unit 1 = rows along e with e·d = -0.2; bound metadata from the
    device build's _meta_block_device."""
    from arrowspace_tpu.pruned import _meta_block_device
    d = np.zeros(f)
    d[0] = 1.0
    e = np.zeros(f)
    e[0], e[1] = 0.2, np.sqrt(1 - 0.04)
    rng = np.random.default_rng(f)
    a_rows = d + rng.normal(0, 0.01, (cap - 1, f))
    b_rows = e + rng.normal(0, 0.01, (cap, f))
    rows = np.concatenate([a_rows, np.zeros((1, f)), b_rows])
    xhat = np.where(np.linalg.norm(rows, axis=1, keepdims=True) > 0,
                    rows / np.maximum(np.linalg.norm(rows, axis=1,
                                                     keepdims=True), 1e-30),
                    0.0)
    ids = np.arange(2 * cap, dtype=np.int32)
    lam = np.full(2 * cap, 0.5)
    meta = _meta_block_device(jnp.asarray(xhat), jnp.asarray(lam),
                              jnp.asarray(ids), cap=cap)
    cent, radius, cosr, sinr, lo, hi = meta
    cells = PrunedCells(x=jnp.asarray(xhat), lam=jnp.asarray(lam),
                        ids=jnp.asarray(ids), cent=cent, radius=radius,
                        cosr=cosr, sinr=sinr, lam_lo=lo, lam_hi=hi,
                        cap=cap, n_units=2)
    return rows, xhat, lam, cells, d


@pytest.mark.parametrize("f", [8, 24])
def test_device_meta_cosr_is_min_member_dot(f):
    """cosr never exceeds the smallest member dot x̂·ĉ — including a
    zero-norm member, whose dot is 0 (the 1 − d²/2 identity would give
    0.5 there)."""
    rows, xhat, lam, cells, d = _zero_row_cells(f)
    cent = np.asarray(cells.cent)
    cosr = np.asarray(cells.cosr)
    for u in range(2):
        dots = xhat[u * 8:(u + 1) * 8] @ cent[u]
        assert cosr[u] <= dots.min() + 1e-12, (u, cosr[u], dots.min())
    assert cosr[0] <= 0.0


@pytest.mark.parametrize("f", [8, 24])
def test_device_cells_zero_row_anti_aligned_query(f):
    """The anti-aligned query's true top-1 is the zero row (cos 0 beats
    every negative cosine).  Scanning one unit, the screen must either
    find it or flag — never certify the other unit's row."""
    rows, xhat, lam, cells, d = _zero_row_cells(f)
    q = -d[None, :]
    s, i, fl = _run_pruned(cells, q, np.array([0.5]), 1.0, 1, m_cells=1)
    so, io = _oracle(q, np.array([0.5]), rows, lam, 1.0, 1)
    assert io[0, 0] == 7            # the zero row
    assert fl[0] or i[0, 0] == io[0, 0], (i, fl)
    if not fl[0]:
        np.testing.assert_allclose(s, so, atol=1e-12)
