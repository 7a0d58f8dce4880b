"""ArrowSpace and ArrowItem: core containers and λ-aware search.

Accelerator re-design of the reference's core module (reference:
core.rs:84-1006).  ArrowSpace keeps the N×F item matrix and the per-item λ
vector resident on device as JAX arrays; searches are batched matmul +
top-k programs (see ops/search.py) instead of per-item scans.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import default_dtype
from .ops.search import (batched_lambda_aware_topk,
                         hybrid_search_device_fused)
from .reduction import ImplicitProjection
from .taumode import TauMode, TAUDEFAULT, select_tau, synthetic_lambda_single
from .utils.log import get_logger

logger = get_logger("arrowspace.core")

__all__ = ["ArrowItem", "ArrowFeature", "ArrowSpace", "TAUDEFAULT"]


class ArrowItem:
    """A single owned row with an associated spectral score λ
    (reference: core.rs:84-317)."""

    __slots__ = ("item", "lambda_")

    def __init__(self, item, lambda_: float):
        # owned copy: sources may be read-only device-array views
        self.item = np.array(item, dtype=np.float64)
        self.lambda_ = float(lambda_)

    def __len__(self) -> int:
        return self.item.shape[0]

    def is_empty(self) -> bool:
        return self.item.size == 0

    def lambda_component_similarity(self, other: "ArrowItem") -> float:
        """1 - min(|Δλ|, 1) (reference: core.rs:135-138)."""
        return 1.0 - min(abs(self.lambda_ - other.lambda_), 1.0)

    def lambda_similarity(self, other: "ArrowItem", alpha: float) -> float:
        """α·cos + (1-α)·λ-proximity (reference: core.rs:156-175)."""
        assert len(self) == len(other), "items should be of the same length"
        return alpha * self.cosine_similarity(other.item) \
            + (1.0 - alpha) * self.lambda_component_similarity(other)

    def dot(self, other: "ArrowItem") -> float:
        assert len(self) == len(other), "Dimension mismatch"
        return float(np.dot(self.item, other.item))

    @staticmethod
    def norm(a) -> float:
        a = np.asarray(a, dtype=np.float64)
        return float(np.sqrt(np.sum(a * a)))

    def cosine_similarity(self, other) -> float:
        other = np.asarray(other, dtype=np.float64)
        denom = ArrowItem.norm(self.item) * ArrowItem.norm(other)
        if denom > 0.0:
            return float(np.dot(self.item, other)) / denom
        logger.warning("Zero vector encountered in cosine similarity computation")
        return 0.0

    def euclidean_distance(self, other: "ArrowItem") -> float:
        assert len(self) == len(other), "Dimension mismatch"
        d = self.item - other.item
        return float(np.sqrt(np.sum(d * d)))

    def add_inplace(self, other: "ArrowItem") -> None:
        assert len(self) == len(other), "Dimension mismatch"
        self.item += other.item

    def mul_inplace(self, other: "ArrowItem") -> None:
        assert len(self) == len(other), "Dimension mismatch"
        self.item *= other.item

    def scale(self, scalar: float) -> None:
        self.item *= scalar

    def __iter__(self):
        return iter(self.item)


class ArrowFeature:
    """A feature column (reference: core.rs:91-94)."""

    __slots__ = ("feature",)

    def __init__(self, feature):
        self.feature = np.asarray(feature, dtype=np.float64)


@dataclass
class ArrowSpace:
    """Dense N×F item matrix with per-item spectral scores
    (reference: core.rs:366-385)."""

    nfeatures: int = 0
    nitems: int = 0
    data: Optional[jax.Array] = None          # (N, F)
    signals: Optional[jax.Array] = None       # dense F'×F' or None
    lambdas: Optional[jax.Array] = None       # (N,)
    taumode: TauMode = TAUDEFAULT

    n_clusters: int = 0
    # -1 encodes the reference's None (outlier / unassigned)
    cluster_assignments: Optional[np.ndarray] = None
    cluster_sizes: Optional[np.ndarray] = None
    cluster_radius: float = 0.0

    projection_matrix: Optional[ImplicitProjection] = None
    reduced_dim: Optional[int] = None

    _signals_nnz: int = 0
    _projected_cache: Optional[jax.Array] = None
    # Host f64 view of the original rows (a reference to the constructor's
    # materialised array, NOT a copy): the exact-rescoring search path
    # re-ranks device f32 candidates against these to recover f64 tie
    # ordering.  None after in-place device mutations (set_item etc.).
    host_rows: Optional[np.ndarray] = None
    # True when the index was built with EnergyParams.allow_tall_graphs:
    # λ computations zero-pad items to graphs with n > F nodes instead of
    # raising the reference's hard error (taumode.rs:574 OOB).
    pad_tall_graphs: bool = False

    # ------------------------------------------------------------------
    @staticmethod
    def new(items: Sequence[Sequence[float]],
            taumode: TauMode = TAUDEFAULT,
            dtype=None) -> "ArrowSpace":
        """Construct from a list of equal-length rows
        (reference: core.rs:415-439)."""
        items = np.asarray(items, dtype=np.float64)
        assert items.size > 0, "items cannot be empty"
        assert items.shape[0] > 1, "cannot create a arrowspace of one arrow only"
        n_items, n_features = items.shape
        dt = dtype or default_dtype()
        return ArrowSpace(
            nfeatures=n_features,
            nitems=n_items,
            data=jnp.asarray(items, dtype=dt),
            signals=None,
            lambdas=jnp.zeros((n_items,), dtype=dt),
            taumode=taumode,
            cluster_assignments=np.full((0,), -1, dtype=np.int64),
            cluster_sizes=np.zeros((0,), dtype=np.int64),
            host_rows=items,
        )

    from_items = new  # test-path alias (core.rs:444-453)

    @staticmethod
    def from_items_default(items) -> "ArrowSpace":
        return ArrowSpace.new(items, TAUDEFAULT)

    # ------------------------------------------------------------------
    def project_query(self, query) -> np.ndarray:
        """Project an F-dim query into the index space if a projection was
        used at build time (reference: core.rs:509-529)."""
        query = np.asarray(query, dtype=np.float64)
        assert query.shape[0] == self.nfeatures, (
            f"Query dimension {query.shape[0]} doesn't match index original "
            f"dimension {self.nfeatures}")
        if self.projection_matrix is not None:
            return np.asarray(self.projection_matrix.project(query),
                              dtype=np.float64)
        return query

    def prepare_query_items_batch(self, items, gl) -> jax.Array:
        """Batched query-λ preparation: (B, F) -> (B,).  One fused device
        program instead of B scalar round-trips (the batched form of
        core.rs:533-549)."""
        from .taumode import select_tau_batch, synthetic_lambda_batch
        items = np.asarray(items, dtype=np.float64)
        assert items.shape[-1] == self.nfeatures, (
            f"Query dimension {items.shape[-1]} doesn't match index "
            f"original dimension {self.nfeatures}")
        assert np.all(np.isfinite(items)), (
            "Query item contains invalid values (NaN or infinity). "
            "All values must be finite.")
        if self.projection_matrix is not None:
            items = self.projection_matrix.project_batch_host(items)
        mat = gl.matrix
        dt = getattr(mat, "dtype", None) or self.data.dtype
        dev = jnp.asarray(items, dtype=dt)
        taus = select_tau_batch(dev, self.taumode)
        return synthetic_lambda_batch(dev, jnp.asarray(mat, dtype=dt), taus,
                                      pad_items=self.pad_tall_graphs)

    def prepare_query_item(self, item, gl) -> float:
        """Compute the query's synthetic λ (reference: core.rs:533-549):
        project if needed, select τ from the (projected) coordinates, then
        run the fused λ kernel against the graph matrix."""
        item = np.asarray(item, dtype=np.float64)
        assert item.shape[-1] == self.nfeatures, (
            f"Query dimension {item.shape[-1]} doesn't match index "
            f"original dimension {self.nfeatures}")
        assert np.all(np.isfinite(item)), (
            "Query item contains invalid values (NaN or infinity). "
            "All values must be finite.")
        if self.projection_matrix is not None:
            item = self.project_query(item)
        tau = select_tau(item, self.taumode)
        mat = gl.matrix
        return synthetic_lambda_single(
            jnp.asarray(item, dtype=mat.dtype), mat, tau,
            pad_items=self.pad_tall_graphs)

    # ------------------------------------------------------------------
    def lambdas_list(self) -> np.ndarray:
        return np.asarray(self.lambdas)

    def projected_items(self) -> jax.Array:
        """Device-resident projected item matrix (N, r), cached — used by
        the energy search path; identity when no projection is active."""
        if self.projection_matrix is None:
            return self.data
        if self._projected_cache is None or \
                self._projected_cache.shape[0] != self.nitems:
            self._projected_cache = \
                self.projection_matrix.project_device(self.data)
        return self._projected_cache

    def cluster_of(self, i: int) -> Optional[int]:
        if self.cluster_assignments is None or i >= len(self.cluster_assignments):
            return None
        v = int(self.cluster_assignments[i])
        return None if v < 0 else v

    def get_feature(self, i: int) -> ArrowFeature:
        assert i < self.nfeatures, "feature index out of bounds"
        return ArrowFeature(np.asarray(self.data[:, i]))

    def set_feature(self, f: int, values: ArrowFeature) -> None:
        assert f < self.nfeatures, "feature index out of bounds"
        self.data = self.data.at[:, f].set(
            jnp.asarray(values.feature, dtype=self.data.dtype))
        self._projected_cache = None
        self.host_rows = None  # device data diverged from the f64 original

    def get_item(self, i: int) -> ArrowItem:
        assert i < self.nitems, "item index out of bounds"
        return ArrowItem(np.asarray(self.data[i]), float(self.lambdas[i]))

    def set_item(self, i: int, values: ArrowItem) -> None:
        assert i < self.nitems, "item index out of bounds"
        self.data = self.data.at[i, :].set(
            jnp.asarray(values.item, dtype=self.data.dtype))
        self._projected_cache = None
        self.host_rows = None  # device data diverged from the f64 original

    # --- in-place algebra with λ maintenance (core.rs:614-727) ----------
    def _check_gl(self, gl) -> None:
        assert gl.nnodes == self.nitems, \
            "Laplacian nodes must match number of items"

    def _refresh_lambda_row(self, a: int, gl) -> None:
        """λ maintenance after mutating row `a`.  The reference re-runs the
        full O(N·nnz) batch (core.rs:644); since λ_j depends only on row j
        and the (unchanged) graph, recomputing the single edited row yields
        identical values at 1/N the cost — the optimization SURVEY.md §3.5
        calls out.  Equality with the full recompute is pinned by tests."""
        from .taumode import select_tau, synthetic_lambda_single
        graph = self.signals if (self.signals is not None
                                 and self.signals.shape[0] > 0) else gl.matrix
        row = np.asarray(self.data[a], dtype=np.float64)
        tau = select_tau(row, self.taumode)
        lam = synthetic_lambda_single(
            jnp.asarray(row, dtype=graph.dtype), graph, tau)
        self.lambdas = self.lambdas.at[a].set(lam)
        self._lambda_order = None

    def add_items(self, a: int, b: int, gl) -> None:
        assert a < self.nitems and b < self.nitems, (
            f"Item indices out of bounds: a={a}, b={b}, ncols={self.nitems}")
        self._check_gl(gl)
        item_a, item_b = self.get_item(a), self.get_item(b)
        item_a.add_inplace(item_b)
        self.set_item(a, item_a)
        self._refresh_lambda_row(a, gl)

    def mul_items(self, a: int, b: int, gl) -> None:
        assert a < self.nitems and b < self.nitems, (
            f"Item indices out of bounds: a={a}, b={b}, ncols={self.nitems}")
        self._check_gl(gl)
        item_a, item_b = self.get_item(a), self.get_item(b)
        item_a.mul_inplace(item_b)
        self.set_item(a, item_a)
        self._refresh_lambda_row(a, gl)

    def scale_item(self, a: int, scalar: float, gl) -> None:
        assert a < self.nitems, (
            f"Item index out of bounds: a={a}, ncols={self.nitems}")
        self._check_gl(gl)
        item_a = self.get_item(a)
        item_a.scale(scalar)
        self.set_item(a, item_a)
        self._refresh_lambda_row(a, gl)

    def recompute_lambdas(self, gl) -> None:
        """Full λτ batch recompute (reference: core.rs:711-727)."""
        from .taumode import compute_taumode_lambdas
        graph = self.signals if (self.signals is not None
                                 and self.signals.shape[0] > 0) else gl.matrix
        self.lambdas = compute_taumode_lambdas(self.data, graph, self.taumode)
        self._lambda_order = None  # invalidate the sorted λ-band index

    def update_lambdas(self, new_lambdas) -> None:
        new_lambdas = jnp.asarray(new_lambdas, dtype=self.lambdas.dtype)
        assert new_lambdas.shape == self.lambdas.shape, \
            "New lambdas length must match existing lambdas length"
        self.lambdas = new_lambdas
        self._lambda_order = None  # invalidate the sorted λ-band index

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------
    def search_lambda_aware(self, query: ArrowItem, k: int,
                            alpha: float) -> List[Tuple[int, float]]:
        """λ-aware top-k (reference: core.rs:760-798).  One matmul +
        lax.top_k instead of the reference's sequential scan.

        Delegates to the batched path with B=1, so search_one(q) is
        bitwise-equal to search(q)[..., 0] at every corpus size."""
        assert query.lambda_ != 0.0, (
            "Lambda of the item is 0.0, prepare the item before searching")
        k_eff = min(k, self.nitems)
        q = np.atleast_2d(np.asarray(query.item))
        scores, idx = self.search_lambda_aware_batch(
            q, np.asarray([query.lambda_]), k_eff, alpha)
        return [(int(i), float(s)) for i, s in
                zip(np.asarray(idx[0]), np.asarray(scores[0]))]

    def search_lambda_aware_batch(self, queries, query_lambdas, k: int,
                                  alpha: float, use_bf16: bool = False):
        """Batched variant: (B, F) queries -> (scores (B,k), indices (B,k))
        through the one XLA λ-aware step (ops.search.lambda_topk), which
        bounds the (B, N) score plane by scanning large corpora in row
        chunks.  use_bf16 scores with bf16 operands and f32 accumulation;
        the default is f32 at Precision.HIGHEST."""
        k_eff = min(k, self.nitems)
        dt = self.data.dtype
        return batched_lambda_aware_topk(
            jnp.asarray(queries, dtype=dt),
            jnp.asarray(query_lambdas, dtype=dt), self.data, self.lambdas,
            jnp.asarray(alpha, dtype=dt), k=k_eff, use_bf16=use_bf16)

    def search_lambda_aware_hybrid(self, query: ArrowItem, k: int,
                                   alpha: float) -> List[Tuple[int, float]]:
        """Hybrid search mixing cosine-only evidence
        (reference: core.rs:802-928): union of the λ-aware top-k, the
        high-cosine set (> 0.9999, scored by cosine), and the semantic
        top-1; sorted desc and truncated to k.  The union/precedence
        runs on device (ops/search.hybrid_search_device_fused) so the
        host fetches O(k) bytes, not the (N,) cosine array."""
        if k == 0:
            return []
        k_eff = min(k, self.nitems)
        dt = self.data.dtype
        scores, idx = hybrid_search_device_fused(
            jnp.asarray(query.item, dtype=dt),
            jnp.asarray(query.lambda_, dtype=dt),
            self.data, self.lambdas, jnp.asarray(alpha, dtype=dt), k=k_eff)
        return [(int(i), float(s))
                for i, s in zip(np.asarray(idx), np.asarray(scores))]

    def lambda_sorted_index(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted λ values, original indices) — the ZSET-style index of
        examples/02_proteins_lookup.rs, cached for O(log N + M) bands."""
        if getattr(self, "_lambda_order", None) is None or \
                len(self._lambda_order[0]) != self.nitems:
            lam = np.asarray(self.lambdas, dtype=np.float64)
            order = np.argsort(lam, kind="stable")
            self._lambda_order = (lam[order], order)
        return self._lambda_order

    def range_search_sorted(self, lo: float, hi: float,
                            limit: Optional[int] = None
                            ) -> List[Tuple[int, float]]:
        """Two-sided λ-band [lo, hi] via binary search on the sorted λ
        index: O(log N + M) (paper.md:147).  Returns (item index, λ)
        ascending by λ."""
        lam_sorted, order = self.lambda_sorted_index()
        i0 = int(np.searchsorted(lam_sorted, lo, side="left"))
        i1 = int(np.searchsorted(lam_sorted, hi, side="right"))
        hits = [(int(order[i]), float(lam_sorted[i])) for i in range(i0, i1)]
        return hits[:limit] if limit is not None else hits

    def range_search(self, query: ArrowItem, gl,
                     eps: float) -> List[Tuple[int, float]]:
        """λ-band range search with the reference's signed one-sided test
        query.λ - item.λ <= eps (reference: core.rs:944-976; quirk kept
        deliberately, see SURVEY.md §2)."""
        if math.isclose(query.lambda_, 0.0, rel_tol=1e-9, abs_tol=1e-9):
            qlam = self.prepare_query_item(query.item, gl)
        else:
            qlam = query.lambda_
        diff = qlam - np.asarray(self.lambdas, dtype=np.float64)
        hits = np.nonzero(diff <= eps)[0]
        return [(int(i), float(diff[i])) for i in hits]


def densematrix_to_vecvec(matrix) -> List[List[float]]:
    """Utility parity with core.rs:1042-1047."""
    return np.asarray(matrix, dtype=np.float64).tolist()
