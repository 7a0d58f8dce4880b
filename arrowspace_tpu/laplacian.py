"""λτ-graph Laplacian build from high-dimensional vectors.

Accelerator re-design of the reference's laplacian module (reference:
laplacian.rs:122-417).  The reference pipeline per node row:

1. optional "normalisation" — despite the docs this is a **StandardScaler**
   (column z-scoring), not unit-norm (laplacian.rs:146-155);
2. CosinePair top-(topk+1) neighbours by rectified cosine distance
   d = 1 - max(0, cos) (laplacian.rs:211, 72-75);
3. filter: j != i, d <= eps, kernel weight w = 1/(1+(d/σ)^p) with σ
   defaulting to **1.0** when None (laplacian.rs:253-254 — the docs claim
   σ := eps, the code says 1.0), w > 1e-12;
4. inline sparsification when avg degree > 10: keep the top 50% of a row's
   edges by w·√(deg_i·deg_j), at least 1, only for rows with >2 edges
   (laplacian.rs:229-280);
5. symmetrise by inserting both directions (laplacian.rs:314-320).  Because
   the rectified-cosine distance and the kernel are symmetric, w_ij == w_ji
   whenever both survive, so the reference's DashMap last-write-wins equals
   a max/union merge — which is what we use (deterministically);
6. L = D - A (laplacian.rs:349-417).

Device mapping: the node count n is small (F′ feature-signals for the
canonical path), so the whole build is one dense pairwise-cosine matmul
plus top-k and masked scatters — no trees, no hash maps.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import HIGHEST
from .graph import GraphLaplacian, GraphParams
from .utils.log import get_logger

logger = get_logger("arrowspace.laplacian")

__all__ = ["build_laplacian_matrix", "standard_scale_columns",
           "rectified_cosine_distances", "adjacency_from_knn"]


@jax.jit
def standard_scale_columns(m: jax.Array) -> jax.Array:
    """Column z-scoring, the reference's 'normalise' step
    (laplacian.rs:146-155, smartcore StandardScaler).  Constant columns are
    left centred (std guarded to 1) instead of producing NaNs."""
    mean = jnp.mean(m, axis=0, keepdims=True)
    std = jnp.std(m, axis=0, keepdims=True)
    std = jnp.where(std > 0.0, std, 1.0)
    return (m - mean) / std


def rectified_cosine_distances(rows: jax.Array) -> jax.Array:
    """Pairwise rectified cosine distance d = 1 - max(0, cos) over matrix
    rows (laplacian.rs:72-75).  Zero-norm rows get cos = 0 -> d = 1."""
    dt = rows.dtype
    norms = jnp.sqrt(jnp.sum(rows * rows, axis=1))
    safe = jnp.where(norms > 0.0, norms, 1.0)
    unit = rows / safe[:, None]
    cos = jnp.dot(unit, unit.T, preferred_element_type=dt, precision=HIGHEST)
    both = (norms[:, None] > 0.0) & (norms[None, :] > 0.0)
    cos = jnp.where(both, cos, 0.0)
    return 1.0 - jnp.maximum(cos, 0.0)


@functools.partial(jax.jit, static_argnames=("kq",))
def _knn_stage(rows: jax.Array, eps: jax.Array, *, kq: int):
    """Stage 1 (one XLA program): pairwise rectified-cosine distances,
    (topk+1)-NN and the distance-filter degrees used both for the
    sparsify decision and the sparsification score."""
    n = rows.shape[0]
    dist = rectified_cosine_distances(rows)
    # Self is always the closest entry so it is reliably included in the
    # query result then filtered, like CosinePair's self hit.
    dist = dist.at[jnp.arange(n), jnp.arange(n)].set(-1.0)
    neg_d, nbr = jax.lax.top_k(-dist, kq)   # (n, kq) smallest distances
    d = -neg_d
    row_ids = jnp.broadcast_to(jnp.arange(n)[:, None], (n, kq))
    deg_mask = (nbr != row_ids) & (d <= eps)
    # Degrees for sparsification scoring (laplacian.rs:217-227): count of
    # neighbours passing the distance filter only.
    degrees = jnp.sum(deg_mask, axis=1)
    return d, nbr, row_ids, deg_mask, degrees


@functools.partial(jax.jit, static_argnames=("sparsify",))
def _assemble_stage(d, nbr, row_ids, deg_mask, degrees, sigma, p,
                    *, sparsify: bool):
    """Stage 2 (one XLA program): kernel weights, optional inline
    sparsification, union symmetrisation, L = D - A."""
    n = d.shape[0]
    dt = d.dtype
    w = 1.0 / (1.0 + (jnp.maximum(d, 0.0) / sigma) ** p)
    valid = deg_mask & (w > 1e-12)

    if sparsify:
        # score = w * sqrt(deg_i * deg_j); keep top max(count//2, 1) edges
        # per row, but only for rows with more than 2 valid edges.
        deg_f = degrees.astype(dt)
        score = w * jnp.sqrt(deg_f[:, None] * deg_f[nbr])
        score = jnp.where(valid, score, -jnp.inf)
        order = jnp.argsort(-score, axis=1)
        # rank[i, slot] = position of slot in the row's descending order
        rank = jnp.argsort(order, axis=1)
        count = jnp.sum(valid, axis=1)
        keep_count = jnp.maximum(count // 2, 1)
        keep = rank < keep_count[:, None]
        valid = jnp.where((count > 2)[:, None], valid & keep, valid)

    # Scatter kept edges into a dense adjacency; duplicate-safe via max.
    w_masked = jnp.where(valid, w, 0.0)
    adj = jnp.zeros((n, n), dtype=dt)
    adj = adj.at[row_ids.reshape(-1), nbr.reshape(-1)].max(w_masked.reshape(-1))
    # Union symmetrisation: both directions carry the same weight
    # (laplacian.rs:317-320; see module docstring on last-write-wins).
    adj = jnp.maximum(adj, adj.T)
    adj = adj * (1.0 - jnp.eye(n, dtype=dt))
    lap = jnp.diag(jnp.sum(adj, axis=1)) - adj
    offdiag_nnz = jnp.sum(adj > 0)
    return adj, lap, offdiag_nnz


def adjacency_from_knn(rows: jax.Array, params: GraphParams) -> jax.Array:
    """Dense symmetric adjacency (laplacian.rs:203-346); see the staged
    jitted kernels above."""
    adj, _, _ = _build_dense(rows, params)
    return adj


def _build_dense_numpy(rows: np.ndarray, params: GraphParams, kq: int,
                       sigma: float):
    """Micro-path for tiny graphs: identical semantics to the jitted
    stages, in plain NumPy — a 64-node build is less arithmetic than one
    compiled-program dispatch, and the reference's CPU numbers for these
    sizes are single-digit ms."""
    n = rows.shape[0]
    norms = np.sqrt(np.sum(rows * rows, axis=1))
    safe = np.where(norms > 0.0, norms, 1.0)
    unit = rows / safe[:, None]
    cos = unit @ unit.T
    both = (norms[:, None] > 0.0) & (norms[None, :] > 0.0)
    dist = 1.0 - np.maximum(np.where(both, cos, 0.0), 0.0)
    np.fill_diagonal(dist, -1.0)   # self always included then filtered

    # stable argsort: ties resolve to the lowest index, matching
    # lax.top_k's ordering in the jitted path
    nbr = np.argsort(dist, axis=1, kind="stable")[:, :kq]
    d = np.take_along_axis(dist, nbr, axis=1)
    row_ids = np.broadcast_to(np.arange(n)[:, None], (n, kq))
    deg_mask = (nbr != row_ids) & (d <= params.eps)
    degrees = deg_mask.sum(axis=1)

    sparsify = float(degrees.mean()) > 10.0
    w = 1.0 / (1.0 + (np.maximum(d, 0.0) / sigma) ** params.p)
    valid = deg_mask & (w > 1e-12)

    if sparsify:
        deg_f = degrees.astype(rows.dtype)
        score = np.where(valid, w * np.sqrt(deg_f[:, None] * deg_f[nbr]),
                         -np.inf)
        order = np.argsort(-score, axis=1, kind="stable")
        rank = np.argsort(order, axis=1, kind="stable")
        count = valid.sum(axis=1)
        keep = rank < np.maximum(count // 2, 1)[:, None]
        valid = np.where((count > 2)[:, None], valid & keep, valid)

    adj = np.zeros((n, n), dtype=rows.dtype)
    np.maximum.at(adj, (row_ids[valid], nbr[valid]), w[valid])
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0.0)
    lap = np.diag(adj.sum(axis=1)) - adj
    return adj, lap, int((adj > 0).sum())


def _build_dense(rows, params: GraphParams):
    n = np.shape(rows)[0]
    kq = min(params.topk + 1, n)
    sigma = params.sigma if params.sigma is not None else 1.0

    if n <= 256:
        # host micro-path: the Laplacian stays a host-backed array and
        # only moves to a device when downstream compute first needs it
        adj, lap, offdiag = _build_dense_numpy(
            np.asarray(rows, dtype=np.float64), params, kq, sigma)
        # output dtype follows the session convention (f64 only under
        # x64) so host-built matrices mix cleanly with device arrays
        from .config import default_dtype
        dt = np.dtype(default_dtype())
        if hasattr(rows, "dtype") and np.dtype(rows.dtype) == np.float32:
            dt = np.dtype(np.float32)
        return adj.astype(dt), lap.astype(dt), offdiag

    rows = jnp.asarray(rows)

    adj, lap, offdiag_nnz = _build_dense_stages(rows, params, kq, sigma)
    return adj, lap, int(offdiag_nnz)


def _build_dense_stages(rows: jax.Array, params: GraphParams, kq: int,
                        sigma: float):
    dt = rows.dtype
    d, nbr, row_ids, deg_mask, degrees = _knn_stage(
        rows, jnp.asarray(params.eps, dtype=dt), kq=kq)
    avg_degree = float(jnp.mean(degrees.astype(jnp.float32)))
    sparsify = avg_degree > 10.0
    if sparsify:
        logger.info("Inline sparsification enabled (avg degree %.1f)",
                    avg_degree)
    adj, lap, offdiag_nnz = _assemble_stage(
        d, nbr, row_ids, deg_mask, degrees,
        jnp.asarray(sigma, dtype=dt), jnp.asarray(params.p, dtype=dt),
        sparsify=sparsify)
    return adj, lap, offdiag_nnz


def build_laplacian_matrix(
    transposed: jax.Array,
    params: GraphParams,
    n_items: Optional[int] = None,
) -> GraphLaplacian:
    """Build the graph Laplacian over the **rows** of ``transposed``
    (reference: laplacian.rs:122-178).

    For the canonical path the caller passes an already-transposed X×F
    centroid matrix, so the graph is over the F′ feature signals and the
    matrix is F′×F′ while ``nnodes`` records the original N.
    """
    # Device placement is deferred: tiny graphs take the host micro-path
    # and must not pay an accelerator round trip first.
    d, n_cols = np.shape(transposed)
    assert n_cols >= 2 and d >= 2, (
        f"items should be at least of shape (2,2): ({d},{n_cols})")

    logger.info("Building Laplacian matrix for %d items with %d features",
                n_cols, d)

    if d > 256 and not isinstance(transposed, jax.Array):
        transposed = jnp.asarray(transposed)

    if params.normalise:
        if isinstance(transposed, jax.Array):
            items = standard_scale_columns(transposed)
        else:
            m = np.asarray(transposed, dtype=np.float64)
            mean = m.mean(axis=0, keepdims=True)
            std = m.std(axis=0, keepdims=True)
            std = np.where(std > 0.0, std, 1.0)
            items = (m - mean) / std
    else:
        items = transposed

    _, lap, offdiag_nnz = _build_dense(items, params)

    n = items.shape[0]
    structural_nnz = n + offdiag_nnz  # diagonal always stored (laplacian.rs:370)

    gl = GraphLaplacian(
        init_data=items,
        matrix=lap,
        nnodes=n_items if n_items is not None else n_cols,
        graph_params=params,
        structural_nnz=structural_nnz,
    )
    logger.info("Successfully built Laplacian matrix (%dx%d) with %d non-zeros",
                n, n, structural_nnz)
    return gl
