"""Tau selection and synthetic λ tests, mirroring tests/test_taumode.rs."""

import numpy as np
import jax.numpy as jnp
import pytest

from arrowspace_tpu.taumode import (TauMode, TAU_FLOOR, select_tau,
                                    select_tau_batch, synthetic_lambda_batch,
                                    compute_taumode_lambdas)
from helpers import (oracle_adjacency, oracle_laplacian,
                     oracle_select_tau_median, oracle_synthetic_lambda)


# --- select_tau policies (test_taumode.rs:14-160) --------------------------

def test_select_tau_fixed():
    assert select_tau([1.0, 2.0], TauMode.fixed(0.5)) == 0.5
    assert select_tau([], TauMode.fixed(-1.0)) == TAU_FLOOR
    assert select_tau([], TauMode.fixed(float("nan"))) == TAU_FLOOR
    assert select_tau([], TauMode.fixed(0.0)) == TAU_FLOOR


def test_select_tau_mean_filters_nonfinite():
    vals = [1.0, 2.0, float("nan"), 3.0, float("inf")]
    assert select_tau(vals, TauMode.mean()) == pytest.approx(2.0)
    assert select_tau([float("nan")], TauMode.mean()) == TAU_FLOOR


def test_select_tau_median_even_odd():
    assert select_tau([3.0, 1.0, 2.0], TauMode.median()) == 2.0
    assert select_tau([4.0, 1.0, 3.0, 2.0], TauMode.median()) == 2.5
    assert select_tau([], TauMode.median()) == TAU_FLOOR
    # floor applies to non-positive medians
    assert select_tau([-5.0, -1.0, -3.0], TauMode.median()) == TAU_FLOOR


def test_select_tau_percentile():
    vals = list(range(11))  # 0..10
    assert select_tau(vals, TauMode.percentile(0.0)) == TAU_FLOOR  # 0 floored
    assert select_tau(vals, TauMode.percentile(1.0)) == 10.0
    assert select_tau(vals, TauMode.percentile(0.5)) == 5.0
    # clamped outside [0,1]
    assert select_tau(vals, TauMode.percentile(2.0)) == 10.0


def test_select_tau_batch_matches_scalar():
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 1.0, (32, 17))
    x[3, 5] = np.nan
    x[7, 0] = np.inf
    for mode in [TauMode.median(), TauMode.mean(), TauMode.percentile(0.3),
                 TauMode.fixed(0.2)]:
        batch = np.asarray(select_tau_batch(jnp.asarray(x), mode))
        for i in range(x.shape[0]):
            assert batch[i] == pytest.approx(select_tau(x[i], mode),
                                             rel=1e-12), (mode, i)


def test_select_tau_median_matches_oracle():
    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 2.0, (10, 9))
    batch = np.asarray(select_tau_batch(jnp.asarray(x), TauMode.median()))
    for i in range(10):
        assert batch[i] == pytest.approx(oracle_select_tau_median(x[i]))


# --- synthetic λ (test_taumode.rs:270-530) ---------------------------------

def _small_graph(n=12, f=12, seed=3):
    rng = np.random.default_rng(seed)
    rows = rng.uniform(0.1, 1.0, (n, f))
    adj = oracle_adjacency(rows, eps=1.0, topk=3, p=2.0, sigma=None)
    return rows, oracle_laplacian(adj)


def test_synthetic_lambda_matches_oracle_both_methods():
    rows, lap = _small_graph()
    taus = np.array([oracle_select_tau_median(r) for r in rows])
    for method in ("matmul", "direct"):
        lam = np.asarray(synthetic_lambda_batch(
            jnp.asarray(rows), jnp.asarray(lap), jnp.asarray(taus),
            method=method))
        for i in range(rows.shape[0]):
            expect = oracle_synthetic_lambda(rows[i], lap, taus[i])
            assert lam[i] == pytest.approx(expect, rel=1e-9), (method, i)


def test_synthetic_lambda_partial_coordinate_quirk():
    """Graph smaller than the item dimension: graph terms read the first n
    coords while the denominator uses the full vector (taumode.rs:565-596)."""
    rng = np.random.default_rng(5)
    rows = rng.uniform(0.1, 1.0, (8, 20))
    sub = rows[:, :6]
    adj = oracle_adjacency(sub[:6], eps=1.0, topk=2, p=2.0, sigma=None)
    lap = oracle_laplacian(adj)  # 6x6 graph, items have 20 dims
    taus = np.array([oracle_select_tau_median(r) for r in rows])
    lam = np.asarray(synthetic_lambda_batch(
        jnp.asarray(rows), jnp.asarray(lap), jnp.asarray(taus)))
    for i in range(8):
        assert lam[i] == pytest.approx(
            oracle_synthetic_lambda(rows[i], lap, taus[i]), rel=1e-9)


def test_synthetic_lambda_graph_larger_than_items_errors():
    lap = np.eye(10)
    with pytest.raises(ValueError):
        synthetic_lambda_batch(jnp.ones((2, 4)), jnp.asarray(lap),
                               jnp.ones((2,)))


def test_lambda_nonnegative_and_bounded_for_laplacian():
    """Rayleigh of a true Laplacian is >= 0; with tau in (0,1] λ lands in a
    sane range (test_taumode.rs:270-430, 499-530)."""
    rows, lap = _small_graph(n=20, f=20, seed=11)
    lam = np.asarray(compute_taumode_lambdas(
        jnp.asarray(rows), jnp.asarray(lap), TauMode.median()))
    assert np.all(np.isfinite(lam))
    assert np.all(lam >= 0.0)
    assert np.all(lam <= 2.0)


def test_lambda_scale_invariance_of_rayleigh():
    """E(cx) = E(x). With Fixed tau, scaling changes only nothing in E or G
    (G is scale-invariant too since shares normalise) -> λ identical."""
    rows, lap = _small_graph(n=10, f=10, seed=13)
    tau = TauMode.fixed(0.5)
    lam1 = np.asarray(compute_taumode_lambdas(
        jnp.asarray(rows), jnp.asarray(lap), tau))
    lam2 = np.asarray(compute_taumode_lambdas(
        jnp.asarray(rows * 3.0), jnp.asarray(lap), tau))
    np.testing.assert_allclose(lam1, lam2, rtol=1e-9)


def test_lambda_recomputation_deterministic():
    rows, lap = _small_graph(n=16, f=16, seed=17)
    a = np.asarray(compute_taumode_lambdas(
        jnp.asarray(rows), jnp.asarray(lap), TauMode.median()))
    b = np.asarray(compute_taumode_lambdas(
        jnp.asarray(rows), jnp.asarray(lap), TauMode.median()))
    np.testing.assert_array_equal(a, b)


def test_zero_vector_gives_zero_lambda():
    rows, lap = _small_graph(n=6, f=6, seed=19)
    rows = rows.copy()
    rows[2] = 0.0
    taus = np.array([oracle_select_tau_median(r) for r in rows])
    lam = np.asarray(synthetic_lambda_batch(
        jnp.asarray(rows), jnp.asarray(lap), jnp.asarray(taus)))
    # E_raw = 0 (denom guard), G = 0 (no edge energy from a zero vector
    # against itself is not generally zero, but E term vanishes)
    assert np.isfinite(lam[2])


def test_tau_floor_constant():
    """TAU_FLOOR sanity (reference: test_taumode.rs:318-327)."""
    assert TAU_FLOOR > 0.0
    assert TAU_FLOOR < 1e-6
    assert np.isfinite(TAU_FLOOR)


def test_builder_lambdas_invariants():
    """λ invariants through the full builder regardless of clustering
    (reference: test_taumode.rs:270-316)."""
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from data import make_gaussian_blob
    items = make_gaussian_blob(500, dims=10, spread=0.9, seed=21)
    aspace, _ = (ArrowSpaceBuilder()
                 .with_lambda_graph(0.3, 6, 2, 2.0, 0.12)
                 .with_normalisation(False)
                 .with_spectral(True)
                 .with_synthesis(TauMode.median())
                 .with_seed(17).build(items.tolist()))
    lam = np.asarray(aspace.lambdas)
    assert np.all((lam >= 0.0) & (lam <= 1.0))
    assert lam.var() >= 0.0
    assert lam.max() >= lam.min()


def test_builder_lambdas_consistency_properties():
    """Repeated seeded builds produce identical λ; the statistical
    envelope is well-formed (reference: test_taumode.rs:329-430 tests a
    nondeterministic build statistically; seeded is strictly stronger)."""
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from data import make_moons_hd
    items = make_moons_hd(80, 0.15, 0.4, 11, 789)

    def build():
        return (ArrowSpaceBuilder()
                .with_lambda_graph(0.3, 5, 2, 2.0, None)
                .with_normalisation(False)
                .with_synthesis(TauMode.median())
                .with_seed(23).build(items.tolist()))

    a1, _ = build()
    a2, _ = build()
    l1, l2 = np.asarray(a1.lambdas), np.asarray(a2.lambdas)
    np.testing.assert_array_equal(l1, l2)
    assert l1.shape == (80,)
    assert np.all(np.isfinite(l1))
    assert 0.0 <= l1.min() <= l1.max() <= 1.0


def test_builder_lambdas_with_larger_dataset():
    """999-item build: λ bounded in [0,1], finite, one per item; tau-mode
    sweep produces valid spectra (reference: test_taumode.rs:531-660)."""
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from data import make_gaussian_blob
    items = make_gaussian_blob(999, dims=10, spread=0.75, seed=25)
    aspace, gl = (ArrowSpaceBuilder()
                  .with_lambda_graph(0.1, 6, 2, 2.0, 0.50)
                  .with_normalisation(False)
                  .with_synthesis(TauMode.fixed(0.8))
                  .with_sparsity_check(False)
                  .with_seed(19).build(items.tolist()))
    lam = np.asarray(aspace.lambdas)
    assert lam.shape[0] == aspace.nitems == 999
    assert gl.nnodes == 999
    assert np.all(np.isfinite(lam))
    assert np.all((lam >= 0.0) & (lam <= 1.0))

    for mode in (TauMode.fixed(0.45), TauMode.fixed(0.6), TauMode.mean(),
                 TauMode.median()):
        a, _ = (ArrowSpaceBuilder()
                .with_lambda_graph(0.1, 6, 2, 2.0, 0.50)
                .with_synthesis(mode)
                .with_sparsity_check(False)
                .with_seed(19).build(items.tolist()))
        lm = np.asarray(a.lambdas)
        assert np.all(np.isfinite(lm)) and np.all(lm >= 0.0), str(mode)


def test_taumode_windowed_matches_single_shot(monkeypatch):
    """Very large corpora compute λτ in row windows over the resident
    array (HBM cap at 10M x 128); windowed results must equal the
    single-shot path including the clamped tail window."""
    import arrowspace_tpu.taumode as tm

    rng = np.random.default_rng(3)
    n, f, g = 40_000, 24, 24  # > the 16k-row window floor -> 3 windows
    items = jnp.asarray(rng.normal(size=(n, f)))
    a = rng.uniform(0, 1, (g, g))
    a = np.maximum(a, a.T) * (a > 0.6)
    np.fill_diagonal(a, 0)
    lap = jnp.asarray(np.diag(a.sum(1)) - a)

    ref = np.asarray(compute_taumode_lambdas(items, lap, TauMode.median()))
    monkeypatch.setattr(tm, "TAUMODE_WINDOW_BYTES", 1)
    out = np.asarray(tm.compute_taumode_lambdas(items, lap,
                                                TauMode.median()))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-14)
    assert out.shape == (n,)



@pytest.mark.parametrize("mode", [TauMode.median(), TauMode.percentile(0.3),
                                  TauMode.percentile(1.0), TauMode.mean()])
def test_select_tau_batch_duplicates_and_signed_zero(mode):
    """Rows made of repeated values, ±0.0 and non-finite entries: the
    batched τ (one XLA row sort) equals the scalar reference policy."""
    x = np.array([
        [0.0, -0.0, 0.0, -0.0, 1.0, 1.0, 1.0, 2.0],
        [-0.0, -0.0, -0.0, -0.0, -0.0, -0.0, -0.0, -0.0],
        [3.0, 3.0, 3.0, 3.0, np.inf, -np.inf, np.nan, 3.0],
        [0.5, 0.25, 0.5, 0.25, 0.5, 0.25, 0.5, 0.25],
        [np.nan] * 8,
    ])
    batch = np.asarray(select_tau_batch(jnp.asarray(x), mode))
    for i in range(x.shape[0]):
        assert batch[i] == pytest.approx(select_tau(x[i], mode), rel=1e-12,
                                         abs=1e-15)


@pytest.mark.parametrize("mode", [TauMode.mean(), TauMode.fixed(0.2),
                                  TauMode.percentile(0.9)])
def test_taumode_windowed_matches_single_shot_every_mode(monkeypatch, mode):
    """The windowed λτ driver equals the single-shot path under every τ
    policy, clamped tail window included."""
    import arrowspace_tpu.taumode as tm

    rng = np.random.default_rng(5)
    n, f = 33_000, 16          # > the 16k-row window floor -> 3 windows
    items = jnp.asarray(rng.normal(size=(n, f)))
    a = rng.uniform(0, 1, (f, f))
    a = np.maximum(a, a.T) * (a > 0.5)
    np.fill_diagonal(a, 0)
    lap = jnp.asarray(np.diag(a.sum(1)) - a)
    ref = np.asarray(compute_taumode_lambdas(items, lap, mode))
    monkeypatch.setattr(tm, "TAUMODE_WINDOW_BYTES", 1)
    out = np.asarray(tm.compute_taumode_lambdas(items, lap, mode))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-14)
