"""The one XLA λ-aware step (ops.search.lambda_topk) and the energy step
(energymaps.energy_topk) against brute-force f64 NumPy oracles: bounded
score plane, chunked running top-k, lowest-index tie order across
chunks, capacity masking, the bf16 option, and the explicit matmul
precision of every pinned dot (read from the jaxpr)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arrowspace_tpu.energymaps import _energy_score_topk_chunked, energy_topk
from arrowspace_tpu.ops.search import (batched_lambda_aware_topk,
                                       lambda_topk, plane_chunk_rows)

HIGHEST = jax.lax.Precision.HIGHEST


def _unit(x):
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return np.where(n > 0, x / np.where(n > 0, n, 1.0), 0.0)


def oracle_lambda_topk(q, qlam, x, lam, alpha, k, n_live=None):
    """f64 reference score (core.rs:135-175) + stable (score desc,
    index asc) selection."""
    cos = _unit(np.asarray(q, np.float64)) @ _unit(
        np.asarray(x, np.float64)).T
    dl = np.abs(np.asarray(qlam)[:, None] - np.asarray(lam)[None, :])
    s = alpha * cos + (1.0 - alpha) * (1.0 - np.minimum(dl, 1.0))
    if n_live is not None:
        s[:, n_live:] = -np.inf
    idx = np.arange(s.shape[1])
    order = np.stack([np.lexsort((idx, -row))[:k] for row in s])
    return np.take_along_axis(s, order, axis=1), order


def oracle_energy_topk(zq, qlam, z, lam, wl, wd, k, n_live=None):
    """f64 energy score (energymaps.rs:368-407) without signals."""
    num = np.linalg.norm(zq[:, None, :] - z[None, :, :], axis=2)
    d_dir = np.minimum(num / (1.0 + num), 1.0)
    s = -(wl * np.abs(qlam[:, None] - lam[None, :]) + wd * d_dir)
    if n_live is not None:
        s[:, n_live:] = -np.inf
    idx = np.arange(s.shape[1])
    order = np.stack([np.lexsort((idx, -row))[:k] for row in s])
    return np.take_along_axis(s, order, axis=1), order


def _random_case(n, f=16, b=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    lam = rng.uniform(0, 1, n)
    q = rng.normal(size=(b, f))
    qlam = rng.uniform(0, 1, b)
    return q, qlam, x, lam


def _one_hot_case(n, f=8, b=3, n_lams=2, seed=0):
    """Scaled basis-vector rows: every x̂ is an exact basis vector, so
    q̂·x̂ = q̂_j is exact in any summation order and rows sharing (j, λ)
    tie BITWISE — the tie order is then fully determined."""
    rng = np.random.default_rng(seed)
    j = rng.integers(0, f, n)
    x = np.zeros((n, f))
    x[np.arange(n), j] = rng.uniform(0.5, 3.0, n)
    lam = rng.integers(0, n_lams, n) * 0.25
    q = rng.normal(size=(b, f))
    qlam = rng.integers(0, n_lams, b) * 0.25
    return q, qlam, x, lam


def _run(q, qlam, x, lam, alpha, k, **kw):
    s, i = batched_lambda_aware_topk(
        jnp.asarray(q), jnp.asarray(qlam), jnp.asarray(x),
        jnp.asarray(lam), jnp.asarray(alpha, jnp.float64), k=k, **kw)
    return np.asarray(s), np.asarray(i)


# --- plane vs chunked scan against the f64 oracle --------------------------

@pytest.mark.parametrize("n,k,chunk", [
    (1000, 8, 0), (2048, 10, 256), (777, 10, 256), (4096, 64, 512),
    (3000, 100, 1024), (1500, 128, 512), (2049, 10, 2048), (513, 16, 100),
    (5000, 10, 333), (100, 100, 0), (1000, 1, 64), (640, 48, 64)])
def test_lambda_topk_matches_f64_oracle(n, k, chunk):
    q, qlam, x, lam = _random_case(n, seed=n + k)
    s, i = _run(q, qlam, x, lam, 0.8, k, chunk=chunk)
    s_o, i_o = oracle_lambda_topk(q, qlam, x, lam, 0.8, k)
    np.testing.assert_array_equal(i, i_o)
    np.testing.assert_allclose(s, s_o, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("chunk", [0, 7, 64, 100, 999])
@pytest.mark.parametrize("b", [1, 3])
def test_ties_resolve_to_lowest_index_across_chunks(chunk, b):
    q, qlam, x, lam = _one_hot_case(1000, b=b, seed=chunk)
    s, i = _run(q, qlam, x, lam, 0.7, 40, chunk=chunk)
    s_o, i_o = oracle_lambda_topk(q, qlam, x, lam, 0.7, 40)
    np.testing.assert_array_equal(i, i_o)
    np.testing.assert_allclose(s, s_o, rtol=1e-12)


@pytest.mark.parametrize("chunk", [0, 5, 64])
def test_all_equal_rows_return_first_k_indices(chunk):
    """A corpus of identical rows: every score ties, so the step must
    return ids 0..k-1 in order, whatever the chunking."""
    x = np.tile([1.0, 2.0, 3.0], (300, 1))
    q = np.array([[0.5, -1.0, 2.0], [3.0, 1.0, 0.0]])
    s, i = _run(q, np.array([0.1, 0.9]), x, np.full(300, 0.3), 0.9, 12,
                chunk=chunk)
    np.testing.assert_array_equal(i, np.tile(np.arange(12), (2, 1)))


@pytest.mark.parametrize("chunk", [0, 64, 250])
@pytest.mark.parametrize("n_live", [300, 999])
def test_n_live_masks_capacity_padding(chunk, n_live):
    """Capacity padding past n_live (here NaN garbage) never surfaces."""
    q, qlam, x, lam = _random_case(1024, seed=n_live)
    x[n_live:] = np.nan
    lam[n_live:] = np.nan
    s, i = _run(q, qlam, x, lam, 0.9, 10, chunk=chunk,
                n_live=jnp.asarray(n_live, jnp.int32))
    s_o, i_o = oracle_lambda_topk(q[:, :], qlam, x[:n_live], lam[:n_live],
                                  0.9, 10)
    np.testing.assert_array_equal(i, i_o)
    np.testing.assert_allclose(s, s_o, rtol=1e-12)


@pytest.mark.parametrize("k", [16, 32, 50])
def test_k_larger_than_chunk(k):
    """A chunk smaller than k widens to k (each chunk must be able to
    supply k candidates)."""
    q, qlam, x, lam = _random_case(700, seed=k)
    s, i = _run(q, qlam, x, lam, 0.6, k, chunk=8)
    s_o, i_o = oracle_lambda_topk(q, qlam, x, lam, 0.6, k)
    np.testing.assert_array_equal(i, i_o)


@pytest.mark.parametrize("chunk", [0, 128])
def test_alpha_one_is_bitwise_cosine(chunk):
    """α=1: c1 = 0 and the score plane is exactly the cosine plane."""
    from arrowspace_tpu.ops.search import cosine_scores
    q, qlam, x, lam = _random_case(600, seed=3)
    s, i = _run(q, qlam, x, lam, 1.0, 10, chunk=chunk)
    cos = np.asarray(cosine_scores(jnp.asarray(q), jnp.asarray(x)))
    np.testing.assert_array_equal(s, np.take_along_axis(cos, i, axis=1))
    np.testing.assert_array_equal(
        i, np.argsort(-cos, axis=1, kind="stable")[:, :10])


@pytest.mark.parametrize("chunk", [0, 256])
def test_bf16_overlaps_f32(chunk):
    """bf16 operands with f32 accumulation: top-10 overlap with the f32
    step stays high on clustered data; scores agree to bf16 rounding."""
    rng = np.random.default_rng(9)
    centers = rng.normal(size=(20, 64))
    x = (centers[rng.integers(0, 20, 2000)]
         + rng.normal(0, 0.3, (2000, 64))).astype(np.float32)
    q = x[:32] * 1.01
    lam = rng.uniform(0, 1, 2000).astype(np.float32)
    args = (jnp.asarray(q), jnp.asarray(lam[:32]), jnp.asarray(x),
            jnp.asarray(lam), jnp.float32(0.9))
    s32, i32 = batched_lambda_aware_topk(*args, k=10, chunk=chunk)
    s16, i16 = batched_lambda_aware_topk(*args, k=10, chunk=chunk,
                                         use_bf16=True)
    assert s16.dtype == jnp.float32
    overlap = np.mean([len(set(a) & set(b)) / 10.0 for a, b in
                       zip(np.asarray(i32), np.asarray(i16))])
    assert overlap >= 0.9, overlap
    np.testing.assert_array_equal(np.asarray(i16)[:, 0], np.arange(32))
    np.testing.assert_allclose(np.asarray(s16), np.asarray(s32), atol=2e-2)


@pytest.mark.parametrize("b,n,k,expect", [
    (2048, 1_000_000, 10, 131072), (16, 1_000_000, 10, 1_000_000),
    (2048, 10_000_000, 10, 131072), (256, 1_000_000, 10, 1_000_000),
    (4096, 100, 10, 100), (1 << 20, 1 << 20, 300, 300)])
def test_plane_chunk_rows(b, n, k, expect):
    assert plane_chunk_rows(b, n, k, budget=1 << 30) == expect


def test_10m_plane_is_never_materialised():
    """B=2048 over 10M rows (an 84 GB f32 plane): the traced step scans
    row chunks and no intermediate is anywhere near the full plane."""
    S = jax.ShapeDtypeStruct
    f32 = jnp.float32
    jaxpr = jax.make_jaxpr(
        lambda q, ql, x, xl: lambda_topk(q, ql, x, xl, f32(0.9), k=10))(
            S((2048, 128), f32), S((2048,), f32),
            S((10_000_000, 128), f32), S((10_000_000,), f32))
    prims = _all_eqns(jaxpr.jaxpr)
    assert any(e.primitive.name == "scan" for e in prims)
    biggest = max(int(np.prod(v.aval.shape)) for e in prims
                  for v in e.outvars if hasattr(v.aval, "shape"))
    assert biggest * 4 <= (1 << 30), biggest


# --- the energy step --------------------------------------------------------

@pytest.mark.parametrize("n,k,chunk", [
    (700, 9, 0), (700, 9, 256), (1024, 32, 100), (333, 5, 64),
    (2000, 128, 512)])
def test_energy_topk_matches_f64_oracle(n, k, chunk):
    rng = np.random.default_rng(n)
    z = rng.normal(size=(n, 12))
    lam = rng.uniform(0, 1, n)
    zq = rng.normal(size=(5, 12))
    qlam = rng.uniform(0, 1, 5)
    s, i = _energy_score_topk_chunked(
        jnp.asarray(zq), jnp.asarray(qlam), jnp.asarray(z),
        jnp.asarray(lam), jnp.asarray(1.0), jnp.asarray(0.5), k=k,
        chunk=chunk)
    s_o, i_o = oracle_energy_topk(zq, qlam, z, lam, 1.0, 0.5, k)
    np.testing.assert_array_equal(np.asarray(i), i_o)
    np.testing.assert_allclose(np.asarray(s), s_o, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("chunk", [0, 50, 128])
def test_energy_duplicate_ties_lowest_index(chunk):
    """One-hot z rows: d² = |zq|² + 1 − 2·zq_j is exact, so rows sharing
    (j, λ) tie bitwise and must come back lowest index first."""
    q, qlam, x, lam = _one_hot_case(600, b=2, seed=chunk + 1)
    x = _unit(x)
    s, i = _energy_score_topk_chunked(
        jnp.asarray(q), jnp.asarray(qlam), jnp.asarray(x),
        jnp.asarray(lam), jnp.asarray(1.0), jnp.asarray(0.5), k=30,
        chunk=chunk)
    s_o, i_o = oracle_energy_topk(q, qlam, x, lam, 1.0, 0.5, 30)
    np.testing.assert_array_equal(np.asarray(i), i_o)


@pytest.mark.parametrize("chunk", [0, 64])
def test_energy_n_live_masks_padding(chunk):
    rng = np.random.default_rng(4)
    z = rng.normal(size=(512, 8))
    lam = rng.uniform(0, 1, 512)
    z[300:] = 0.0       # stale capacity rows that would otherwise win
    lam[300:] = 0.5
    zq = np.zeros((2, 8))
    qlam = np.array([0.5, 0.5])
    s, i = jax.jit(energy_topk, static_argnames=("k", "chunk"))(
        jnp.asarray(zq), jnp.asarray(qlam), jnp.asarray(z),
        jnp.asarray(lam), jnp.asarray(1.0), jnp.asarray(0.5), k=6,
        chunk=chunk, n_live=jnp.asarray(300, jnp.int32))
    s_o, i_o = oracle_energy_topk(zq, qlam, z[:300], lam[:300], 1.0, 0.5, 6)
    np.testing.assert_array_equal(np.asarray(i), i_o)


# --- explicit matmul precision, read from the jaxpr ------------------------

def _all_eqns(jaxpr):
    out = []
    for e in jaxpr.eqns:
        out.append(e)
        for p in e.params.values():
            subs = p if isinstance(p, (list, tuple)) else [p]
            for sub in subs:
                if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    out.extend(_all_eqns(sub.jaxpr))
                elif hasattr(sub, "eqns"):
                    out.extend(_all_eqns(sub))
    return out


def _dots(fn, *args, **kw):
    jaxpr = jax.make_jaxpr(lambda *a: fn(*a, **kw))(*args)
    return [e for e in _all_eqns(jaxpr.jaxpr)
            if e.primitive.name == "dot_general"]


def _assert_highest(dots):
    assert dots, "expected at least one dot"
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(p == HIGHEST for p in prec), prec


def _f32(*shape):
    return jnp.zeros(shape, jnp.float32)


def _lap(n):
    return jnp.eye(n, dtype=jnp.float32) * 2.0 - 0.1


def _pinned_cases():
    from arrowspace_tpu import pruned
    from arrowspace_tpu.energymaps import energy_query_z
    from arrowspace_tpu.index import _energy_step_jit, _session_step_jit
    from arrowspace_tpu.live import _live_step_jit
    from arrowspace_tpu.ops.search import cosine_scores
    from arrowspace_tpu.taumode import TauMode, synthetic_lambda_batch

    tm = TauMode.median()
    b, n, f, u, cap = 4, 64, 8, 8, 8
    return {
        "score_plane": (lambda_topk, (_f32(b, f), _f32(b), _f32(n, f),
                                      _f32(n), jnp.float32(0.9)),
                        dict(k=5)),
        "score_plane_chunked": (lambda_topk, (_f32(b, f), _f32(b),
                                              _f32(n, f), _f32(n),
                                              jnp.float32(0.9)),
                                dict(k=5, chunk=16)),
        "cosine_scores": (cosine_scores, (_f32(b, f), _f32(n, f)), {}),
        "lambda_chain": (synthetic_lambda_batch,
                         (_f32(n, f), _lap(f), _f32(n)), {}),
        "session_step": (_session_step_jit(),
                         (_f32(b, f), _f32(n, f), _f32(n), _lap(f),
                          _f32(f, f)),
                         dict(taumode=tm, alpha=0.9, k=5, has_proj=True,
                              pad_tall=False)),
        "live_step": (_live_step_jit(),
                      (_f32(b, f), _f32(n, f), _f32(n), _lap(f),
                       _f32(1, 1), jnp.int32(40)),
                      dict(taumode=tm, alpha=0.9, k=5, has_proj=False,
                           pad_tall=False, use_bf16=False)),
        "energy_step": (_energy_step_jit(),
                        (_f32(b, f), _f32(n, 6), _f32(n), _lap(f),
                         _f32(1, 1), _f32(6, f), jnp.float32(1.0),
                         jnp.float32(0.5)),
                        dict(taumode=tm, k=5, has_proj=False,
                             has_signals=True, pad_tall=False)),
        "energy_z": (energy_query_z, (_f32(b, f), _f32(6, f)),
                     dict(use_signals=True)),
        "pruned_bound_and_score": (
            pruned.pruned_topk,
            (_f32(b, f), _f32(b), _f32(u * cap, f), _f32(u * cap),
             jnp.zeros((u * cap,), jnp.int32), _f32(u, f), _f32(u),
             _f32(u), _f32(u), _f32(u), _f32(u), jnp.float32(0.9)),
            dict(k=3, m_cells=2, cap=cap, margin=1e-3)),
        "pruned_union": (
            pruned.pruned_topk_union,
            (_f32(32, f), _f32(32), _f32(u * cap, f), _f32(u * cap),
             jnp.zeros((u * cap,), jnp.int32), _f32(u, f), _f32(u),
             _f32(u), _f32(u), _f32(u), _f32(u), jnp.float32(0.9)),
            dict(k=3, m_vote=2, s_cells=4, cap=cap, margin=1e-3)),
        "pruned_lloyd": (pruned._lloyd_device, (_f32(n, f), _f32(u, f)),
                         dict(n_cells=u, chunk=16, iters=2)),
    }


@pytest.mark.parametrize("name", [
    "score_plane", "score_plane_chunked", "cosine_scores", "lambda_chain",
    "session_step", "live_step", "energy_step", "energy_z",
    "pruned_bound_and_score", "pruned_union", "pruned_lloyd"])
def test_pinned_dot_precision(name):
    fn, args, kw = _pinned_cases()[name]
    _assert_highest(_dots(fn, *args, **kw))


def test_bf16_option_is_the_only_low_precision_dot():
    """use_bf16: the score dot takes bf16 operands with f32 accumulation;
    every other dot of the step stays at HIGHEST."""
    from arrowspace_tpu.index import _session_step_jit
    from arrowspace_tpu.taumode import TauMode
    dots = _dots(_session_step_jit(), _f32(4, 8), _f32(64, 8), _f32(64),
                 _lap(8), _f32(1, 1), taumode=TauMode.median(), alpha=0.9,
                 k=5, has_proj=False, pad_tall=False, use_bf16=True)
    bf = [e for e in dots if e.invars[0].aval.dtype == jnp.bfloat16]
    assert len(bf) == 1
    assert bf[0].params["preferred_element_type"] == jnp.float32
    _assert_highest([e for e in dots if e not in bf])
