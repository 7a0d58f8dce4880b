"""Graph Laplacian container, factory, and spectral utilities.

Accelerator re-design of the reference's graph module (reference:
graph.rs:94-743).  The canonical λτ-graph is built over the **rows of a
transposed centroid matrix** — i.e. the F′ feature signals — so the graph
is tiny (F′ ≤ a few hundred nodes).  We therefore store the Laplacian as a
small **dense** device matrix: SpMV becomes a matmul and the whole λτ
batch fuses into a few matmuls (see taumode.py).  ``nnz`` tracks the
structural non-zero count of the equivalent CSR so sparsity statistics and
checks match the reference (graph.rs:566-578).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import HIGHEST
from .utils.log import get_logger

logger = get_logger("arrowspace.graph")

__all__ = [
    "GraphParams", "GraphLaplacian", "GraphFactory",
    "LaplacianValidation", "LaplacianStats",
]


@dataclass
class GraphParams:
    """λτ-graph construction parameters (reference: graph.rs:94-102)."""

    eps: float            # maximum rectified cosine distance
    k: int                # max number of neighbours per node
    topk: int             # number of closest-neighbour results considered
    p: float              # kernel exponent
    sigma: Optional[float]  # kernel scale (None -> 1.0 inside the builder)
    normalise: bool       # standard-scale columns before the build
    sparsity_check: bool  # panic if the Laplacian is >95% sparse

    def __eq__(self, other) -> bool:
        # Approximate float equality, exact ints/bools (graph.rs:105-119).
        if not isinstance(other, GraphParams):
            return NotImplemented
        def releq(a, b):
            return math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0)
        sig_eq = (self.sigma is None and other.sigma is None) or (
            self.sigma is not None and other.sigma is not None
            and releq(self.sigma, other.sigma))
        return (self.k == other.k and releq(self.eps, other.eps)
                and releq(self.p, other.p) and sig_eq
                and self.normalise == other.normalise)


@dataclass
class LaplacianValidation:
    """Validation results (reference: graph.rs:659-680)."""
    is_valid: bool = False
    is_symmetric: bool = False
    max_asymmetry: float = 0.0
    max_row_sum_error: float = 0.0
    row_sum_violations: list = field(default_factory=list)
    negative_diagonal: list = field(default_factory=list)


@dataclass
class LaplacianStats:
    """Summary statistics (reference: graph.rs:682-692)."""
    nnodes: int
    nnz: int
    sparsity: float
    min_degree: float
    max_degree: float
    mean_degree: float
    graph_params: GraphParams

    def __str__(self) -> str:
        return (
            "Laplacian Statistics:\n"
            f"  Nodes: {self.nnodes}\n"
            f"  Non-zero entries: {self.nnz} "
            f"({(1.0 - self.sparsity) * 100.0:.2f}% dense)\n"
            f"  Sparsity: {self.sparsity:.4f}\n"
            f"  Degree range: [{self.min_degree:.4f}, {self.max_degree:.4f}]\n"
            f"  Mean degree: {self.mean_degree:.4f}\n"
            f"  Graph parameters: {self.graph_params!r}\n"
        )


@dataclass
class GraphLaplacian:
    """Dense device-resident graph Laplacian (reference: graph.rs:126-135).

    matrix      : (n, n) dense jnp array, L = D - A.
    init_data   : the (d, X) matrix the graph was built from (post-scaling),
                  kept for parity with GraphLaplacian::init_data.
    nnodes      : number of nodes of the *original raw data* (N), which is
                  generally NOT the matrix dimension (see the F′×F′ quirk in
                  SURVEY.md §3.1).
    structural_nnz : stored-entry count of the equivalent CSR (diagonal is
                  always stored, off-diagonals only where an edge exists).
    """

    init_data: jax.Array
    matrix: jax.Array
    nnodes: int
    graph_params: GraphParams
    structural_nnz: int = 0

    # --- shape / access ---------------------------------------------------
    def shape(self):
        return tuple(self.matrix.shape)

    def topk(self) -> int:
        return self.graph_params.topk

    def get(self, i: int, j: int) -> float:
        """Entry (i, j); indices are bounds-checked against nnodes and
        positions beyond the stored matrix read as 0.0 — sprs `get`
        returns None there and the reference unwraps it to 0.0
        (graph.rs:311-321)."""
        assert i < self.nnodes and j < self.nnodes, (
            f"Index out of bounds: ({i}, {j}) for {self.nnodes}x{self.nnodes} matrix")
        n = self.matrix.shape[0]
        if i >= n or j >= n:
            return 0.0
        return float(self.matrix[i, j])

    def set(self, i: int, j: int, value: float) -> None:
        assert i < self.nnodes and j < self.nnodes
        if isinstance(self.matrix, np.ndarray):
            self.matrix = self.matrix.copy()
            self.matrix[i, j] = value
        else:
            self.matrix = self.matrix.at[i, j].set(value)

    def get_row(self, i: int) -> np.ndarray:
        """Row i as an nnodes-length vector, zero-padded beyond the stored
        matrix (graph.rs:362-375 semantics)."""
        assert i < self.nnodes, f"Row index {i} out of bounds for {self.nnodes} nodes"
        n = self.matrix.shape[0]
        out = np.zeros(self.nnodes)
        if i < n:
            out[:n] = np.asarray(self.matrix[i])
        return out

    def get_column(self, j: int) -> np.ndarray:
        assert j < self.nnodes, f"Column index {j} out of bounds for {self.nnodes} nodes"
        n = self.matrix.shape[0]
        out = np.zeros(self.nnodes)
        if j < n:
            out[:n] = np.asarray(self.matrix[:, j])
        return out

    def degrees(self) -> np.ndarray:
        """Diagonal entries as an nnodes-length vector; when the original
        item count exceeds the matrix dimension (the F'×F' quirk) the tail
        reads as degree 0, matching sprs get(i,i).unwrap_or(0.0)
        (graph.rs:324-345)."""
        n = self.matrix.shape[0]
        out = np.zeros(self.nnodes if self.nnodes > n else n)
        out[:n] = np.asarray(jnp.diagonal(self.matrix))
        return out

    # --- numerics ----------------------------------------------------------
    def multiply_vector(self, x) -> np.ndarray:
        """y = L·x (reference: graph.rs:436-473). Matmul on device."""
        x = jnp.asarray(x, dtype=self.matrix.dtype)
        assert x.shape[0] == self.matrix.shape[0], (
            f"Vector length {x.shape[0]} must match matrix dim {self.matrix.shape[0]}")
        return np.asarray(jnp.dot(self.matrix, x,
                                  preferred_element_type=self.matrix.dtype,
                                  precision=HIGHEST))

    def rayleigh_quotient(self, x) -> float:
        """R(L, x) = xᵀLx / xᵀx (reference: graph.rs:394-433)."""
        x = jnp.asarray(x, dtype=self.matrix.dtype)
        lx = jnp.dot(self.matrix, x, preferred_element_type=self.matrix.dtype,
                     precision=HIGHEST)
        num = float(jnp.dot(x, lx, precision=HIGHEST))
        den = float(jnp.dot(x, x, precision=HIGHEST))
        if den <= 1e-12:
            logger.warning("Zero vector encountered in Rayleigh quotient computation")
            return 0.0
        return num / den

    def is_symmetric(self, tolerance: float) -> bool:
        diff = jnp.max(jnp.abs(self.matrix - self.matrix.T))
        return bool(diff <= tolerance)

    def verify_properties(self, tolerance: float) -> LaplacianValidation:
        """Row sums ≈ 0, non-negative diagonal, symmetry
        (reference: graph.rs:500-564)."""
        v = LaplacianValidation()
        m = np.asarray(self.matrix)
        n = m.shape[0]
        row_sums = m.sum(axis=1)
        v.max_row_sum_error = float(np.max(np.abs(row_sums))) if n else 0.0
        for i in np.nonzero(np.abs(row_sums) > tolerance)[0]:
            v.row_sum_violations.append((int(i), float(row_sums[i])))
        diag = np.diagonal(m)
        for i in np.nonzero(diag < 0.0)[0]:
            v.negative_diagonal.append((int(i), float(diag[i])))
        v.is_symmetric = self.is_symmetric(tolerance)
        if not v.is_symmetric:
            v.max_asymmetry = float(np.max(np.abs(m - m.T)))
        v.is_valid = (not v.row_sum_violations and not v.negative_diagonal
                      and v.is_symmetric)
        return v

    def nnz(self) -> int:
        return self.structural_nnz

    @staticmethod
    def sparsity(matrix, structural_nnz: Optional[int] = None) -> float:
        """1 - nnz/total (reference: graph.rs:572-578)."""
        rows, cols = matrix.shape
        total = rows * cols
        if structural_nnz is None:
            structural_nnz = int(jnp.sum(jnp.abs(matrix) > 0))
        return 1.0 - structural_nnz / total if total else 1.0

    def extract_adjacency(self) -> np.ndarray:
        """A_ij = -L_ij off-diagonal (reference: graph.rs:580-600)."""
        m = np.asarray(self.matrix).copy()
        np.fill_diagonal(m, 0.0)
        return -m

    def statistics(self) -> LaplacianStats:
        degrees = self.degrees()
        n = self.matrix.shape[0]
        return LaplacianStats(
            nnodes=self.nnodes,
            nnz=self.nnz(),
            sparsity=GraphLaplacian.sparsity(self.matrix, self.structural_nnz),
            min_degree=float(degrees.min()) if n else float("inf"),
            max_degree=float(degrees.max()) if n else float("-inf"),
            mean_degree=float(degrees.sum() / self.nnodes) if self.nnodes else 0.0,
            graph_params=self.graph_params,
        )

    def params(self) -> GraphParams:
        return self.graph_params

    # --- constructors -------------------------------------------------------
    @staticmethod
    def prepare_from_items(matrix, graph_params: GraphParams) -> "GraphLaplacian":
        """Graph from an N×F items matrix: transposed internally so the
        graph is over features (reference: graph.rs:290-299)."""
        from .laplacian import build_laplacian_matrix
        matrix = jnp.asarray(matrix)
        return build_laplacian_matrix(matrix.T, graph_params,
                                      n_items=matrix.shape[0])

    def __str__(self) -> str:
        out = [f"GraphLaplacian ({self.nnodes}×{self.nnodes}):",
               f"Parameters: {self.graph_params!r}"]
        if self.nnodes <= 10:
            out += ["Small matrix - showing structure only",
                    f"Non-zero entries: {self.nnz()}"]
        else:
            stats = self.statistics()
            out += [f"Matrix too large to display ({self.nnodes} nodes)",
                    f"Non-zero entries: {stats.nnz} "
                    f"({(1.0 - stats.sparsity) * 100.0:.2f}% dense)",
                    f"Degree range: [{stats.min_degree:.4f}, "
                    f"{stats.max_degree:.4f}], mean: {stats.mean_degree:.4f}"]
        return "\n".join(out) + "\n"


class GraphFactory:
    """All construction goes through the λτ-graph built from data
    (reference: graph.rs:143-271)."""

    @staticmethod
    def build_laplacian_matrix_from_k_cluster(
        clustered,            # X×F centroid matrix
        eps: float,
        k: int,
        topk: int,
        p: float,
        sigma_override: Optional[float],
        normalise: bool,
        sparsity_check: bool,
        n_items: int,
    ) -> GraphLaplacian:
        """Transpose the centroid matrix and build the λτ-graph over the F′
        feature rows (reference: graph.rs:149-204).  The result is an F′×F′
        matrix with nnodes == n_items (original N) for bookkeeping."""
        from .laplacian import build_laplacian_matrix

        if not isinstance(clustered, (np.ndarray, jax.Array)):
            clustered = np.asarray(clustered, dtype=np.float64)
        assert np.shape(clustered)[0] <= n_items
        params = GraphParams(eps=eps, k=k, topk=topk, p=p,
                             sigma=sigma_override, normalise=normalise,
                             sparsity_check=sparsity_check)
        result = build_laplacian_matrix(clustered.T, params, n_items=n_items)

        if sparsity_check:
            sp = GraphLaplacian.sparsity(result.matrix, result.structural_nnz)
            if sp > 0.95:
                raise ValueError(
                    f"Resulting laplacian matrix is too sparse {sp}")
        assert result.nnodes == n_items
        logger.info(
            "Laplacian matrix built: %dx%d with %d nodes, %d non-zeros",
            result.matrix.shape[0], result.matrix.shape[1],
            result.nnodes, result.nnz())
        return result

    @staticmethod
    def build_spectral_laplacian(aspace, graph_laplacian: GraphLaplacian):
        """F′×F′ Laplacian-of-Laplacian stored in aspace.signals
        (reference: graph.rs:212-270).  The dense L is transposed and a
        second Laplacian is computed over its rows."""
        from .laplacian import build_laplacian_matrix

        dense_l = graph_laplacian.matrix  # already dense on device
        gl2 = build_laplacian_matrix(dense_l.T, graph_laplacian.graph_params,
                                     n_items=aspace.nitems)
        aspace.signals = gl2.matrix
        aspace._signals_nnz = gl2.structural_nnz

        sparsity_output = GraphLaplacian.sparsity(aspace.signals,
                                                  gl2.structural_nnz)
        if sparsity_output > 0.95 and graph_laplacian.graph_params.sparsity_check:
            raise ValueError(
                f"Resulting spectral matrix is too sparse {sparsity_output}")

        if aspace.reduced_dim is not None:
            assert (aspace.signals.shape[0] == aspace.reduced_dim
                    and aspace.signals.shape[1] == aspace.reduced_dim), \
                "result should be a FxF matrix with reduced dimensions F"
        else:
            assert aspace.signals.shape[0] == aspace.signals.shape[1], \
                "result should be a FxF matrix"
        logger.info("Built FxF feature matrix: %dx%d",
                    aspace.signals.shape[0], aspace.signals.shape[1])
