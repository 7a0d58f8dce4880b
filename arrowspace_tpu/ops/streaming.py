"""Out-of-core streaming: corpora larger than device HBM.

The λτ batch and the query scan are both single-pass over the item
matrix, so a corpus that exceeds HBM streams through in row chunks:

- streamed λτ: upload chunk → τ + λ chain → collect the (chunk,) λ;
- streamed query top-k: per-chunk (B, k) candidates merged on the host
  (indices offset per chunk) — the host-level analogue of the device
  step's own running top-k merge (ops.search.scan_topk).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..taumode import TauMode, compute_taumode_lambdas
from ..utils.log import get_logger

logger = get_logger("arrowspace.streaming")

__all__ = ["streamed_taumode_lambdas", "streamed_lambda_topk"]


def streamed_taumode_lambdas(
    host_items: np.ndarray,     # (N, F) on host (numpy / memmap)
    laplacian,                  # (n, n) device or host
    taumode: TauMode,
    chunk: int = 1 << 22,       # 4M rows/chunk at F=128 ≈ 2 GB f32
) -> np.ndarray:
    """λτ for an arbitrarily large host-resident corpus."""
    n = host_items.shape[0]
    lap = jnp.asarray(np.asarray(laplacian), dtype=jnp.float32)
    out = np.empty(n, dtype=np.float32)
    for c0 in range(0, n, chunk):
        tile = jnp.asarray(
            np.asarray(host_items[c0:c0 + chunk], dtype=np.float32))
        lam = compute_taumode_lambdas(tile, lap, taumode)
        out[c0:c0 + chunk] = np.asarray(lam, dtype=np.float32)
        logger.info("streamed λτ: %d / %d rows", min(c0 + chunk, n), n)
    return out


def streamed_lambda_topk(
    queries: np.ndarray,        # (B, F)
    query_lambdas: np.ndarray,  # (B,)
    host_items: np.ndarray,     # (N, F) on host
    host_lambdas: np.ndarray,   # (N,) on host
    alpha: float,
    k: int,
    chunk: int = 1 << 22,
) -> Tuple[np.ndarray, np.ndarray]:
    """λ-aware top-k over a host-resident corpus: per-chunk device top-k,
    host-side merge with global indices."""
    from .search import batched_lambda_aware_topk

    n = host_items.shape[0]
    b = queries.shape[0]
    q = jnp.asarray(np.asarray(queries, dtype=np.float32))
    qlam = jnp.asarray(np.asarray(query_lambdas, dtype=np.float32))

    best_s = np.full((b, k), -np.inf, dtype=np.float32)
    best_i = np.zeros((b, k), dtype=np.int64)

    for c0 in range(0, n, chunk):
        x = jnp.asarray(
            np.asarray(host_items[c0:c0 + chunk], dtype=np.float32))
        lam = jnp.asarray(
            np.asarray(host_lambdas[c0:c0 + chunk], dtype=np.float32))
        s, i = batched_lambda_aware_topk(
            q, qlam, x, lam, jnp.float32(alpha), k=min(k, x.shape[0]))
        s = np.asarray(s)
        i = np.asarray(i, dtype=np.int64) + c0

        # host merge of the running (B, k) with the chunk's (B, k_local)
        cat_s = np.concatenate([best_s, s], axis=1)
        cat_i = np.concatenate([best_i, i], axis=1)
        order = np.argsort(-cat_s, axis=1, kind="stable")[:, :k]
        best_s = np.take_along_axis(cat_s, order, axis=1)
        best_i = np.take_along_axis(cat_i, order, axis=1)
        logger.info("streamed top-k: %d / %d rows", min(c0 + chunk, n), n)

    return best_s, best_i
