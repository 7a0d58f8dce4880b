"""Hypergraph clique-expansion overlays and λτ-graph ensembles.

The reference *documents* these capabilities (README.md:112-113,
builder.rs:241-247 "Priority order ... hypergraph clique/normalized",
graph.rs:142 "Ensembles vary λτ-graph parameters (k, eps) and/or overlay
hypergraph operations") but ships no implementation (SURVEY.md §2
"Dead/doc-only items").  BASELINE.json's GloVe config nevertheless calls
for "hypergraph clique-expansion overlay + ensembles (k-adjust,
ε-expand)", so this module supplies the capability:

- clique expansion: each hyperedge S with weight w contributes
  w/(|S|-1) to every unordered pair in S (the standard clique-expansion
  weighting), accumulated into a dense adjacency overlay;
- Laplacian overlay: L' = L + mix·(D_h - A_h) — still a valid Laplacian
  (row sums 0, PSD as a sum of PSD matrices);
- ensembles: build several λτ graphs with perturbed (k, eps), score a
  query against each, and fuse rankings by mean score (k-adjust /
  ε-expand per graph.rs:142's description).

All device work is dense scatter + matmuls; overlays compose with every
downstream λτ/search kernel unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import HIGHEST
from .graph import GraphLaplacian, GraphParams
from .utils.log import get_logger

logger = get_logger("arrowspace.hypergraph")

__all__ = ["clique_expansion_adjacency", "overlay_laplacian",
           "ensemble_params", "ensemble_search",
           "build_ensemble", "ensemble_search_prebuilt",
           "ensemble_topk_batch"]


def clique_expansion_adjacency(
    hyperedges: Sequence[Sequence[int]],
    n_nodes: int,
    weights: Optional[Sequence[float]] = None,
    normalized: bool = False,
) -> np.ndarray:
    """Dense clique-expansion adjacency.

    Standard variant: hyperedge S adds w/(|S|-1) to every pair in S.
    Normalized variant (README.md:112 "normalized variant"): the full
    expanded adjacency is degree-normalized D^{-1/2} A D^{-1/2}, so large
    hyperedges cannot dominate the overlay.
    Hyperedges with fewer than 2 nodes are ignored."""
    adj = np.zeros((n_nodes, n_nodes))
    if weights is None:
        weights = [1.0] * len(hyperedges)
    for edge, w in zip(hyperedges, weights):
        edge = sorted(set(int(v) for v in edge))
        if len(edge) < 2:
            continue
        share = w / (len(edge) - 1)
        idx = np.asarray(edge)
        adj[np.ix_(idx, idx)] += share
    np.fill_diagonal(adj, 0.0)
    if normalized:
        deg = adj.sum(axis=1)
        inv_sqrt = np.where(deg > 0.0, 1.0 / np.sqrt(np.maximum(deg, 1e-30)),
                            0.0)
        adj = adj * inv_sqrt[:, None] * inv_sqrt[None, :]
    return adj


def overlay_laplacian(gl: GraphLaplacian, hyper_adj,
                      mix: float = 1.0) -> GraphLaplacian:
    """L' = L + mix·(D_h - A_h): overlay the clique-expanded hypergraph on
    an existing λτ-graph Laplacian."""
    a = jnp.asarray(hyper_adj, dtype=gl.matrix.dtype)
    assert a.shape == gl.matrix.shape, (
        f"overlay shape {a.shape} != laplacian shape {gl.matrix.shape}")
    l_h = jnp.diag(jnp.sum(a, axis=1)) - a
    new_matrix = gl.matrix + mix * l_h
    offdiag = new_matrix - jnp.diag(jnp.diagonal(new_matrix))
    nnz = int(new_matrix.shape[0]) + int(jnp.sum(offdiag != 0))
    out = dataclasses.replace(gl, matrix=new_matrix, structural_nnz=nnz)
    logger.info("Hypergraph overlay applied: mix=%.3f, nnz %d -> %d",
                mix, gl.nnz(), nnz)
    return out


def ensemble_params(base: GraphParams,
                    k_adjust: Sequence[int] = (-1, 0, 1),
                    eps_expand: Sequence[float] = (1.0, 1.5),
                    ) -> List[GraphParams]:
    """Parameter grid for λτ-graph ensembles (k-adjust, ε-expand).

    k_adjust shifts BOTH `k` and `topk`: the adjacency is built from
    top-(topk+1) cosine neighbours (laplacian.py, mirroring the
    reference's CosinePair at laplacian.rs:211) while `k` never touches
    it — adjusting `k` alone produced N bitwise-identical variant
    graphs whenever eps_expand was 1.0 (caught r5 by the λ-spread
    diagnostic in benchmarks/glove_bench.py: ensemble λ spread was
    exactly 0 and every fused-vs-single Jaccard was trivially 1.0)."""
    out = []
    for dk in k_adjust:
        for fe in eps_expand:
            k = max(base.k + dk, 1)
            out.append(dataclasses.replace(
                base, k=k, eps=base.eps * fe,
                topk=max(base.topk + dk, 1)))
    return out


def build_ensemble(aspace, centroids,
                   params_list: Sequence[GraphParams]):
    """Build the per-variant index state ONCE: one λτ graph and one λ
    vector per parameter set.  τ is data-only, so it is selected once and
    shared across variants.  Returns a list of (GraphLaplacian, lambdas)."""
    from .laplacian import build_laplacian_matrix
    from .taumode import select_tau_batch, synthetic_lambda_batch

    centroids = jnp.asarray(centroids)
    taus = select_tau_batch(aspace.data, aspace.taumode)
    out = []
    for params in params_list:
        gl = build_laplacian_matrix(centroids.T, params,
                                    n_items=aspace.nitems)
        lambdas = synthetic_lambda_batch(
            aspace.data, gl.matrix.astype(aspace.data.dtype), taus)
        out.append((gl, lambdas))
    return out


def ensemble_search_prebuilt(
    aspace,
    ensemble,               # list of (GraphLaplacian, lambdas)
    query,
    k: int,
    alpha: float,
) -> List[Tuple[int, float]]:
    """Score a query against prebuilt ensemble state and fuse by mean
    score.  Per-variant λ vectors are index state — build them once with
    build_ensemble and reuse across queries."""
    from .ops.search import lambda_aware_scores
    from .taumode import select_tau, synthetic_lambda_single

    query = np.asarray(query, dtype=np.float64)
    dt = aspace.data.dtype
    # The projected vector feeds tau/lambda preparation only (matching
    # ArrowIndex.search); cosine scoring runs raw-F query against the raw
    # (N, F) item matrix — a dims-reduced space would otherwise hit a
    # dot-shape mismatch.
    q_prep = aspace.project_query(query) if aspace.projection_matrix \
        else query
    tau = select_tau(q_prep, aspace.taumode)
    q_prep_dev = jnp.asarray(q_prep, dtype=dt)
    qdev = jnp.asarray(query, dtype=dt)

    total = jnp.zeros((aspace.nitems,), dtype=dt)
    for gl, lambdas in ensemble:
        qlam = synthetic_lambda_single(q_prep_dev, gl.matrix, tau)
        total = total + lambda_aware_scores(
            qdev[None, :], jnp.asarray([qlam], dtype=dt),
            aspace.data, lambdas, jnp.asarray(alpha, dtype=dt))[0]

    total = total / len(ensemble)
    k_eff = min(k, aspace.nitems)
    top_s, top_i = jax.lax.top_k(total, k_eff)
    return [(int(i), float(s)) for i, s in
            zip(np.asarray(top_i), np.asarray(top_s))]


def ensemble_query_lambdas(queries, ensemble, taumode) -> jax.Array:
    """Per-variant query-λ prep for ensemble_topk_batch: (B, F) raw
    queries -> (V, B) λ against each variant's Laplacian (the
    batched form of ensemble_search_prebuilt's per-variant prep;
    graph.rs:142 + core.rs:533-549), at Precision.HIGHEST like every
    other λ prep — index-state prep, shared across batches."""
    from .taumode import select_tau_batch, synthetic_lambda_batch
    dt = queries.dtype
    taus = select_tau_batch(queries, taumode)
    return jnp.stack([
        synthetic_lambda_batch(queries, g.matrix.astype(dt), taus)
        for g, _ in ensemble])


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def ensemble_topk_batch(queries, qlams, items, item_lambdas_v, alpha, *,
                        k: int, chunk: int = 65536):
    """Batched MEAN-SCORE ensemble fusion at corpus scale.

    queries (B, F) raw; qlams (V, B) per-variant query λ (use
    ensemble_query_lambdas — the standard query-λ prep against each
    variant's Laplacian, shared across batches); item_lambdas_v (V, N) the
    per-variant λ vectors from build_ensemble.  Fuses graph.rs:142's
    ensemble semantics exactly as ensemble_search_prebuilt does —
    mean over variants of α·cos + (1−α)·(1−min(|Δλ_v|, 1)) — but
    reassociated so the corpus streams ONCE for the whole ensemble:
    the cosine term is variant-independent, so the fused score is
    α·cos + (1−α)·(1 − mean_v min(|Δλ_v|, 1)) and each corpus chunk
    pays one matmul + V elementwise λ planes instead of V full scans.
    Returns (scores (B, k), ids (B, k)); ties resolve to the lowest
    global id (per-chunk lax.top_k is lowest-index; the running merge
    concatenates earlier chunks first).

    Big operands are ARGUMENTS, not closure captures (HLO-constant /
    remote-compile-413 rule, see index._session_step_jit)."""
    from .ops.search import _safe_unit

    b, f = queries.shape
    v = qlams.shape[0]
    n = items.shape[0]
    dt = queries.dtype
    a = jnp.asarray(alpha, dt)
    c1 = 1.0 - a
    neg_inf = jnp.asarray(-jnp.inf, dt)
    k_eff = min(k, n)

    qhat = _safe_unit(queries) * a
    n_pad = -n % chunk
    xp = jnp.pad(items, ((0, n_pad), (0, 0)))
    lp = jnp.pad(item_lambdas_v, ((0, 0), (0, n_pad)))
    blocks = xp.reshape(-1, chunk, f)
    lam_blocks = lp.reshape(v, -1, chunk).transpose(1, 0, 2)  # (T, V, C)

    def body(carry, inp):
        cs, ci = carry                       # (B, k), (B, k) running
        t, xb, lb = inp                      # (), (C, F), (V, C)
        xhat = _safe_unit(xb)
        cos = jnp.dot(qhat, xhat.T, preferred_element_type=dt,
                      precision=HIGHEST)                    # (B, C)
        dl = jnp.zeros((b, chunk), dt)
        for j in range(v):                   # V is tiny and static
            dl = dl + jnp.minimum(
                jnp.abs(qlams[j][:, None] - lb[j][None, :]), 1.0)
        sc = cos + c1 * (1.0 - dl / v)
        gid = t * chunk + jnp.arange(chunk, dtype=jnp.int32)[None, :]
        sc = jnp.where(gid < n, sc, neg_inf)
        ts, tidx = jax.lax.top_k(sc, k_eff)
        tid = jnp.take_along_axis(
            jnp.broadcast_to(gid, (b, chunk)), tidx, axis=1)
        ms = jnp.concatenate([cs, ts], axis=1)
        mi = jnp.concatenate([ci, tid], axis=1)
        ns, nidx = jax.lax.top_k(ms, k_eff)
        ni = jnp.take_along_axis(mi, nidx, axis=1)
        return (ns, ni), ()

    init = (jnp.full((b, k_eff), neg_inf, dt),
            jnp.zeros((b, k_eff), jnp.int32))
    t_idx = jnp.arange(blocks.shape[0], dtype=jnp.int32)
    (top_s, top_i), _ = jax.lax.scan(body, init, (t_idx, blocks,
                                                  lam_blocks))
    return top_s, top_i


def ensemble_search(
    aspace,
    centroids,
    query,
    params_list: Sequence[GraphParams],
    k: int,
    alpha: float,
) -> List[Tuple[int, float]]:
    """Convenience one-shot: build_ensemble + ensemble_search_prebuilt."""
    ensemble = build_ensemble(aspace, centroids, params_list)
    return ensemble_search_prebuilt(aspace, ensemble, query, k, alpha)
