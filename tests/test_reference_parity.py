"""Parity harness against the reference's REAL embedding fixtures.

The reference ships real 384-d quora-duplicates sentence embeddings and
protein embeddings as test data (reference: src/tests/test_data.rs:1-6
QUORA_EMBEDDS, :5801 PROTEINS_EMBEDS).  These tests rebuild the canonical
index over that data (extracted to tests/fixtures/reference_embeddings.npz
— data, not code) and assert <=1e-5 rel-err against frozen golden outputs
(tests/fixtures/reference_parity_golden.npz): per-item lambda-tau under
each tau policy, the graph Laplacian, query lambdas, and top-k results at
several alpha.  Any drift in the lambda-tau semantics (tau-from-
coordinates, rectified-cosine kernel, F'xF' orientation, dispersion term,
search blend) fails here on the same inputs the reference's tests use
(tests/test_eigenmaps.rs:34-116, test_querying_proj.rs).
"""

import pathlib

import numpy as np
import pytest

from arrowspace_tpu.builder import ArrowSpaceBuilder
from arrowspace_tpu.core import ArrowItem
from arrowspace_tpu.taumode import TauMode

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
RTOL = 1e-5  # BASELINE.json rel-err budget

DATA = np.load(FIXTURES / "reference_embeddings.npz")
GOLD = np.load(FIXTURES / "reference_parity_golden.npz")


def _build(rows, mode):
    b = (ArrowSpaceBuilder()
         .with_lambda_graph(1.0, 6, 3, 2.0, None)
         .with_synthesis(mode)
         .with_inline_sampling(None)
         .with_seed(42))
    return b.build(rows.tolist())


@pytest.fixture(scope="module", params=["quora", "proteins"])
def built(request):
    tag = request.param
    aspace, gl = _build(DATA[tag], TauMode.median())
    return tag, DATA[tag], aspace, gl


def test_fixture_integrity():
    """The extracted fixtures are the reference's: 15 unit-norm quora
    embeddings + 10 protein embeddings, 384-d (test_data.rs:1-6, :5801)."""
    assert DATA["quora"].shape == (15, 384)
    assert DATA["proteins"].shape == (10, 384)
    np.testing.assert_allclose(np.linalg.norm(DATA["quora"], axis=1), 1.0,
                               rtol=1e-6)


def test_lambda_parity(built):
    tag, _rows, aspace, _gl = built
    np.testing.assert_allclose(np.asarray(aspace.lambdas),
                               GOLD[f"{tag}_median_lambdas"], rtol=RTOL)


@pytest.mark.parametrize("mode_tag,mode", [
    ("mean", TauMode.mean()),
    ("p75", TauMode.percentile(0.75)),
])
def test_lambda_parity_other_tau_policies(mode_tag, mode):
    for tag in ("quora", "proteins"):
        aspace, _gl = _build(DATA[tag], mode)
        np.testing.assert_allclose(
            np.asarray(aspace.lambdas), GOLD[f"{tag}_{mode_tag}_lambdas"],
            rtol=RTOL)


def test_graph_parity(built):
    """Laplacian structure and values over the real embeddings: the graph
    is F'xF' (384 nodes, the transpose quirk of graph.rs:172) with frozen
    sparsity pattern and edge weights."""
    tag, _rows, _aspace, gl = built
    lap = np.asarray(gl.matrix, dtype=np.float64)
    assert tuple(GOLD[f"{tag}_lap_shape"]) == lap.shape == (384, 384)
    r, c = np.nonzero(lap)
    np.testing.assert_array_equal(r, GOLD[f"{tag}_lap_rows"])
    np.testing.assert_array_equal(c, GOLD[f"{tag}_lap_cols"])
    np.testing.assert_allclose(lap[r, c], GOLD[f"{tag}_lap_vals"],
                               rtol=RTOL)


def test_query_lambda_parity(built):
    tag, rows, aspace, gl = built
    got = np.asarray([aspace.prepare_query_item(rows[qi] * 1.02, gl)
                      for qi in range(4)])
    np.testing.assert_allclose(got, GOLD[f"{tag}_query_lambdas"], rtol=RTOL)


@pytest.mark.parametrize("alpha", [1.0, 0.9, 0.7])
def test_topk_parity(built, alpha):
    tag, rows, aspace, gl = built
    a_tag = str(alpha).replace(".", "_")
    want_ids = GOLD[f"{tag}_top5_a{a_tag}_ids"]
    want_scores = GOLD[f"{tag}_top5_a{a_tag}_scores"]
    for qi in range(4):
        q = rows[qi] * 1.02
        qlam = aspace.prepare_query_item(q, gl)
        res = aspace.search_lambda_aware(ArrowItem(q, qlam), 5, alpha)
        assert [i for i, _ in res] == list(want_ids[qi])
        np.testing.assert_allclose([s for _, s in res], want_scores[qi],
                                   rtol=RTOL)


def test_matmul_vs_direct_on_real_data(built):
    """The matmul-expanded lambda formulation must agree with the
    direct per-item oracle on the real embeddings (quartic moment
    expansion is exact, not approximate)."""
    from arrowspace_tpu.taumode import (select_tau_batch,
                                        synthetic_lambda_batch)
    import jax.numpy as jnp
    tag, rows, aspace, gl = built
    x = jnp.asarray(rows, dtype=jnp.float64)
    lap = jnp.asarray(gl.matrix, dtype=jnp.float64)
    taus = select_tau_batch(x, TauMode.median())
    lam_mm = synthetic_lambda_batch(x, lap, taus, method="matmul")
    lam_dir = synthetic_lambda_batch(x, lap, taus, method="direct")
    np.testing.assert_allclose(np.asarray(lam_mm), np.asarray(lam_dir),
                               rtol=1e-9, atol=1e-12)


def test_graph_invariants_on_real_data(built):
    """Spectral invariants hold on the real embeddings: symmetry, row sums
    ~0, non-negative diagonal (mirrors tests/test_laplacian.rs:51-153 on
    QUORA data)."""
    tag, _rows, _aspace, gl = built
    assert gl.is_symmetric(1e-9)
    v = gl.verify_properties(1e-6)
    assert v.is_valid, vars(v)
