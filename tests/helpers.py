"""Brute-force NumPy oracles (analogue of the reference's
tests/test_helpers.rs:11-169 O(n²) adjacency builder) used to validate the
JAX fast paths."""

from __future__ import annotations

import numpy as np


def oracle_adjacency(rows: np.ndarray, eps: float, topk: int, p: float,
                     sigma: float | None) -> np.ndarray:
    """O(n²) reference adjacency: rectified cosine distance, top-(topk+1)
    incl. self, eps filter, kernel weight, union symmetrisation.
    No sparsification (callers choose inputs with avg degree <= 10)."""
    n = rows.shape[0]
    sigma = 1.0 if sigma is None else sigma
    norms = np.linalg.norm(rows, axis=1)
    unit = np.divide(rows, np.where(norms > 0, norms, 1.0)[:, None])
    cos = unit @ unit.T
    both = (norms[:, None] > 0) & (norms[None, :] > 0)
    cos = np.where(both, cos, 0.0)
    dist = 1.0 - np.maximum(cos, 0.0)

    adj = np.zeros((n, n))
    for i in range(n):
        d = dist[i].copy()
        d[i] = -1.0  # self first, like CosinePair's self hit
        order = np.argsort(d, kind="stable")[: min(topk + 1, n)]
        for j in order:
            if j == i:
                continue
            dij = dist[i, j]
            if dij <= eps:
                w = 1.0 / (1.0 + (dij / sigma) ** p)
                if w > 1e-12:
                    adj[i, j] = w
                    adj[j, i] = w
    return adj


def oracle_laplacian(adj: np.ndarray) -> np.ndarray:
    return np.diag(adj.sum(axis=1)) - adj


def oracle_synthetic_lambda(x: np.ndarray, lap: np.ndarray,
                            tau: float) -> float:
    """Direct per-item λτ (reference: taumode.rs:552-660)."""
    n = lap.shape[0]
    xn = x[:n]
    numerator = float(xn @ lap @ xn)
    denom = float(np.dot(x, x))
    e_raw = numerator / denom if denom > 1e-12 else 0.0

    w = np.maximum(-lap, 0.0)
    np.fill_diagonal(w, 0.0)
    diff = xn[:, None] - xn[None, :]
    contrib = w * diff * diff
    s = float(contrib.sum())
    if s > 0.0:
        shares = contrib / s
        g = float((shares * shares).sum())
    else:
        g = 0.0
    g = min(max(g, 0.0), 1.0)
    e_bounded = e_raw / (e_raw + tau)
    return tau * e_bounded + (1.0 - tau) * g


def oracle_select_tau_median(values: np.ndarray) -> float:
    v = np.sort(values[np.isfinite(values)])
    if v.size == 0:
        return 1e-10
    if v.size % 2 == 1:
        m = v[v.size // 2]
    else:
        m = 0.5 * (v[v.size // 2 - 1] + v[v.size // 2])
    return max(float(m), 1e-10)


def cosine_topk(query: np.ndarray, items: np.ndarray, k: int):
    """Brute-force cosine top-k, returning (indices, scores) desc."""
    qn = np.linalg.norm(query)
    inorm = np.linalg.norm(items, axis=1)
    denom = qn * inorm
    cos = np.where(denom > 0, items @ query / np.where(denom > 0, denom, 1.0),
                   0.0)
    order = np.argsort(-cos, kind="stable")[:k]
    return order, cos[order]
