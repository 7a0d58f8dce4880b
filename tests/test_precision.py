"""Precision budget: f32 device λτ must stay within the 1e-5 relative
error budget of BASELINE.json against the f64 oracle, for unit-scale
embedding-like data."""

import numpy as np
import jax
import jax.numpy as jnp

from arrowspace_tpu.taumode import TauMode, compute_taumode_lambdas
from helpers import oracle_adjacency, oracle_laplacian


def test_f32_lambda_within_budget():
    rng = np.random.default_rng(0)
    n_items, f = 5000, 96
    # unit-scale clustered embeddings (the regime the budget targets)
    centers = rng.uniform(0.2, 0.8, (8, f))
    rows = centers[rng.integers(0, 8, n_items)] \
        + rng.normal(0, 0.05, (n_items, f))

    graph_rows = rows[:64]
    adj = oracle_adjacency(graph_rows[:, :32], eps=1.0, topk=5, p=2.0,
                           sigma=None)
    lap = oracle_laplacian(adj)  # 64-node graph

    lam64 = np.asarray(compute_taumode_lambdas(
        jnp.asarray(rows, jnp.float64), jnp.asarray(lap, jnp.float64),
        TauMode.median()))
    lam32 = np.asarray(compute_taumode_lambdas(
        jnp.asarray(rows, jnp.float32), jnp.asarray(lap, jnp.float32),
        TauMode.median()))

    rel = np.abs(lam32.astype(np.float64) - lam64) / (np.abs(lam64) + 1e-12)
    assert np.median(rel) < 1e-6
    assert np.quantile(rel, 0.999) < 1e-5, float(np.quantile(rel, 0.999))
    assert rel.max() < 1e-4, float(rel.max())


def test_f32_search_ranking_stable():
    """Top-10 result sets must agree between f32 and f64 scoring away
    from exact ties."""
    from arrowspace_tpu.ops.search import batched_lambda_aware_topk
    rng = np.random.default_rng(1)
    n, f, b = 20000, 64, 16
    items = rng.uniform(0.1, 1.0, (n, f))
    lams = rng.uniform(0, 1, n)
    q = items[:b] * 1.01
    qlam = lams[:b]

    _, i64 = batched_lambda_aware_topk(
        jnp.asarray(q, jnp.float64), jnp.asarray(qlam, jnp.float64),
        jnp.asarray(items, jnp.float64), jnp.asarray(lams, jnp.float64),
        jnp.float64(0.9), k=10)
    _, i32 = batched_lambda_aware_topk(
        jnp.asarray(q, jnp.float32), jnp.asarray(qlam, jnp.float32),
        jnp.asarray(items, jnp.float32), jnp.asarray(lams, jnp.float32),
        jnp.float32(0.9), k=10)

    overlap = np.mean([
        len(set(np.asarray(i64)[r]) & set(np.asarray(i32)[r])) / 10.0
        for r in range(b)])
    assert overlap >= 0.95, overlap


def _near_tie_corpus(n_ties=15, n_fill=500, f=64, seed=4):
    """Corpus whose top scores differ by ~1e-9 in cosine — below f32
    resolution (eps ~1.2e-7 at 1.0), cleanly ordered in f64."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=f)
    base /= np.linalg.norm(base)
    orth = rng.normal(size=f)
    orth -= (orth @ base) * base
    orth /= np.linalg.norm(orth)

    ties = []
    for i in range(n_ties):
        c = 1e-4 * np.sqrt(i + 1.0)
        v = base + c * orth
        ties.append(v / np.linalg.norm(v))
    fillers = rng.normal(size=(n_fill, f))
    fillers /= np.linalg.norm(fillers, axis=1, keepdims=True)
    fillers = 0.2 * fillers + 0.1 * base  # low-cosine background
    return base, np.concatenate([np.asarray(ties), fillers])


def test_f64_rescore_recovers_exact_ties():
    """f32 scoring cannot order cosines 1e-9 apart; re-scoring the f32
    candidate pool against the original f64 rows must return exactly the
    f64 top-k (VERDICT r1 weak #5: 0.959 recall on clustered 384-d)."""
    from arrowspace_tpu.ops.search import (batched_lambda_aware_topk,
                                           rescore_topk_f64)
    q, items = _near_tie_corpus()
    lams = np.full(items.shape[0], 0.5)
    qlam = np.asarray([0.5])
    k, m = 10, 42

    _, i64 = batched_lambda_aware_topk(
        jnp.asarray(q[None, :], jnp.float64), jnp.asarray(qlam, jnp.float64),
        jnp.asarray(items, jnp.float64), jnp.asarray(lams, jnp.float64),
        jnp.float64(1.0), k=k)
    want = list(np.asarray(i64)[0])
    assert want == list(range(k))  # f64 orders the tie cluster exactly

    _, cand32 = batched_lambda_aware_topk(
        jnp.asarray(q[None, :], jnp.float32), jnp.asarray(qlam, jnp.float32),
        jnp.asarray(items, jnp.float32), jnp.asarray(lams, jnp.float32),
        jnp.float32(1.0), k=m)

    s_r, i_r = rescore_topk_f64(q[None, :], qlam, items, lams, 1.0,
                                np.asarray(cand32), k)
    assert list(i_r[0]) == want
    assert list(s_r[0]) == sorted(s_r[0], reverse=True)


def test_f64_rescore_matches_plain_topk_away_from_ties():
    """On generic data (no f32-resolution ties) rescoring is a no-op
    relative to the f64 ranking."""
    from arrowspace_tpu.ops.search import (batched_lambda_aware_topk,
                                           rescore_topk_f64)
    rng = np.random.default_rng(7)
    items = rng.uniform(0.1, 1.0, (5000, 32))
    lams = rng.uniform(0, 1, 5000)
    q = items[:4] * 1.02
    qlam = lams[:4]

    _, i64 = batched_lambda_aware_topk(
        jnp.asarray(q, jnp.float64), jnp.asarray(qlam, jnp.float64),
        jnp.asarray(items, jnp.float64), jnp.asarray(lams, jnp.float64),
        jnp.float64(0.9), k=40)
    s_r, i_r = rescore_topk_f64(q, qlam, items, lams, 0.9,
                                np.asarray(i64), 10)
    np.testing.assert_array_equal(i_r, np.asarray(i64)[:, :10])


def test_index_f64_rescore_api():
    """ArrowIndex.search(precision='f64_rescore') returns the f64 brute
    ranking end to end."""
    from arrowspace_tpu.index import ArrowIndex
    q, items = _near_tie_corpus(seed=9)
    idx = ArrowIndex.build(items.tolist(), eps=1.0, k=5, seed=3)
    s1, i1 = idx.search(q, k=10, alpha=1.0, precision="f64_rescore")
    cos = items @ q / np.linalg.norm(items, axis=1)
    np.testing.assert_array_equal(i1[0], np.argsort(-cos, kind="stable")[:10])


def test_single_query_duplicate_tie_order_cpu():
    """B=1 scoring must give bitwise-equal scores to bitwise-identical
    corpus rows so lax.top_k resolves the tie to the LOWEST index (the
    reference's order for duplicates, pinned by the quora golden).  On
    CPU this requires the unpadded B=1 dot (a matvec): the CPU blocked
    matmul rounds per-column NON-uniformly (an identical row in a SIMD
    remainder lane lands 1 ulp apart)."""
    from arrowspace_tpu.ops.search import _shifted_lambda_plane
    assert jax.default_backend() == "cpu"

    rng = np.random.default_rng(11)
    items = rng.normal(size=(40, 384))
    items[27] = items[3]  # exact duplicate pair, far apart in N
    lams = rng.uniform(0, 1, 40)
    lams[27] = lams[3]
    q = items[3:4] * 1.02
    s, _c1 = _shifted_lambda_plane(
        jnp.asarray(q), jnp.asarray(lams[3:4]), jnp.asarray(items),
        jnp.asarray(lams), jnp.float64(0.9))
    s = np.asarray(s)
    assert s.shape == (1, 40)
    assert s[0, 3] == s[0, 27]  # bitwise tie preserved
    top2 = np.asarray(jax.lax.top_k(jnp.asarray(s), 2)[1][0])
    np.testing.assert_array_equal(top2, [3, 27])

