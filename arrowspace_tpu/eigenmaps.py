"""EigenMaps: the staged build pipeline as explicit, composable stages.

Port of the reference's eigenmaps module (reference: eigenmaps.rs:93-456).
Each stage maps onto one XLA program on the device:

1. start_clustering — optimal-K heuristic + incremental clustering (host)
   + optional JL projection of the centroids (device matmul);
2. eigenmaps        — item-graph Laplacian from centroids (device);
3. compute_taumode  — batched λτ (device, fused matmuls);
4. search           — λ-aware ranking (device matmul + top-k).

Tests assert exact equivalence between this staged path and the monolithic
``ArrowSpaceBuilder.build`` (mirroring tests/test_eigenmaps.rs:34-116).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import clustering
from .core import ArrowItem, ArrowSpace
from .graph import GraphFactory, GraphLaplacian
from .reduction import ImplicitProjection, compute_jl_dimension, project_matrix
from .taumode import compute_taumode_lambdas
from .utils.log import get_logger

logger = get_logger("arrowspace.eigenmaps")

__all__ = ["ClusteredOutput", "start_clustering", "eigenmaps",
           "compute_taumode", "search"]


@dataclass
class ClusteredOutput:
    """Output of the clustering stage (reference: eigenmaps.rs:75-87)."""
    aspace: ArrowSpace
    centroids: jax.Array     # X × F′
    reduced_dim: int
    n_items: int
    n_features: int


def start_clustering(builder, rows) -> ClusteredOutput:
    """Stage 1 (reference: eigenmaps.rs:175-290)."""
    rows_arr = np.asarray(rows, dtype=np.float64)
    n_items, n_features = rows_arr.shape
    logger.info("EigenMaps::start_clustering: N=%d items, F=%d features",
                n_items, n_features)

    aspace = ArrowSpace.new(rows_arr, builder.synthesis)

    # Sampler matching the builder policy (eigenmaps.rs:192-205); seeded
    # builds thread the clustering seed for reproducibility (divergence
    # from the OS-seeded reference, recorded in sampling.py).
    from .sampling import SamplerType
    sampler_type = builder.sampling if builder.sampling is not None \
        else SamplerType.simple(1.0)
    sampler = sampler_type.make(seed=builder.clustering_seed)

    # Accelerated path: the corpus is already device-resident in
    # aspace.data, so the Two-NN estimate and the unseeded chunked scan
    # run their distance tiles on it (host bookkeeping, device matmuls).
    device_data = aspace.data if jax.default_backend() != "cpu" else None

    k_opt, radius, intrinsic_dim = clustering.compute_optimal_k(
        rows_arr, n_items, n_features, builder.clustering_seed,
        device_data=device_data)
    logger.debug("Optimal clustering: K=%d, radius=%.6f, intrinsic_dim=%d",
                 k_opt, radius, intrinsic_dim)
    builder.cluster_max_clusters = k_opt
    builder.cluster_radius = radius

    clustered_dm, assignments, sizes = \
        clustering.run_incremental_clustering_with_sampling(
            builder, rows_arr, n_features, k_opt, radius, sampler,
            device_data=device_data)

    n_clusters = clustered_dm.shape[0]
    # bulk path: chunked/native/sharded modes return Assignments (dense
    # -1-sentinel array) — avoid a 1M-element python list round trip
    assign_arr = getattr(assignments, "array", None)
    if assign_arr is None:
        assign_arr = np.asarray(
            [-1 if a is None else a for a in assignments], dtype=np.int64)
    logger.info("Clustering complete: %d centroids, %d items assigned",
                n_clusters, int((assign_arr >= 0).sum()))

    aspace.n_clusters = n_clusters
    aspace.cluster_assignments = assign_arr.copy()
    aspace.cluster_sizes = np.asarray(sizes, dtype=np.int64)
    aspace.cluster_radius = radius

    # Optional JL projection (eigenmaps.rs:248-280): enabled && F > 64,
    # target = min(jl_dim, F/2); skipped when target >= F.
    # Centroids stay host-resident (they are a host-clustering product and
    # small); the graph build decides the engine itself.
    centroids = clustered_dm
    reduced_dim = n_features
    if builder.use_dims_reduction and n_features > 64:
        jl_dim = compute_jl_dimension(n_clusters, builder.rp_eps)
        target_dim = min(jl_dim, n_features // 2)
        if target_dim < n_features:
            logger.info("Applying JL projection: %d features -> %d dims (eps=%.2f)",
                        n_features, target_dim, builder.rp_eps)
            proj = ImplicitProjection(n_features, target_dim,
                                      **({"seed": builder.clustering_seed}
                                         if builder.clustering_seed is not None
                                         else {}))
            centroids = np.asarray(project_matrix(
                jnp.asarray(centroids, dtype=aspace.data.dtype), proj))
            aspace.projection_matrix = proj
            aspace.reduced_dim = target_dim
            reduced_dim = target_dim

    return ClusteredOutput(aspace=aspace, centroids=centroids,
                           reduced_dim=reduced_dim, n_items=n_items,
                           n_features=n_features)


def eigenmaps(aspace: ArrowSpace, builder, centroids,
              n_items: int) -> GraphLaplacian:
    """Stage 2: item-graph Laplacian from clustered centroids
    (reference: eigenmaps.rs:292-356)."""
    n_centroids, n_features = np.shape(centroids)
    logger.info("EigenMaps::eigenmaps: %d centroids x %d features",
                n_centroids, n_features)

    gl = GraphFactory.build_laplacian_matrix_from_k_cluster(
        centroids,
        builder.lambda_eps,
        builder.lambda_k,
        builder.lambda_topk,
        builder.lambda_p,
        builder.lambda_sigma,
        builder.normalise,
        builder.sparsity_check,
        n_items,
    )
    if builder.prebuilt_spectral:
        GraphFactory.build_spectral_laplacian(aspace, gl)
    return gl


_LAMBDA_STATS = None


def _lambda_stats_jit():
    """Module-level cached jit for the 3-scalar λ stats reduction (a
    fresh jax.jit(lambda) per call would retrace every build)."""
    global _LAMBDA_STATS
    if _LAMBDA_STATS is None:
        _LAMBDA_STATS = jax.jit(lambda v: jnp.stack(
            [jnp.min(v), jnp.max(v), jnp.mean(v)]))
    return _LAMBDA_STATS


def compute_taumode(aspace: ArrowSpace, gl: GraphLaplacian) -> None:
    """Stage 3: batched λτ (reference: eigenmaps.rs:358-383).  Uses the
    precomputed signals matrix when present (taumode.rs:195-200)."""
    graph = aspace.signals if (aspace.signals is not None
                               and aspace.signals.shape[0] > 0) else gl.matrix
    aspace.lambdas = compute_taumode_lambdas(
        aspace.data, graph, aspace.taumode,
        pad_items=aspace.pad_tall_graphs)
    aspace._lambda_order = None  # invalidate the sorted λ-band index
    if logger.isEnabledFor(logging.INFO):
        # stats reduce on device, ONE 3-scalar fetch instead of pulling
        # the full λ vector to host for a log line
        mn, mx, mean = np.asarray(_lambda_stats_jit()(aspace.lambdas))
        logger.info("λ computation complete: min=%.6f, max=%.6f, "
                    "mean=%.6f", mn, mx, mean)


def search(aspace: ArrowSpace, item, gl: GraphLaplacian, k: int,
           alpha: float) -> List[Tuple[int, float]]:
    """Stage 5: λ-aware search with query preparation
    (reference: eigenmaps.rs:410-455).  Note: like the reference, the
    projected query is handed to search_lambda_aware, which requires the
    projected dimension to match the stored item dimension."""
    q_lambda = aspace.prepare_query_item(item, gl)
    projected_query = aspace.project_query(item)
    q = ArrowItem(projected_query, q_lambda)
    return aspace.search_lambda_aware(q, k, alpha)


# Attach the staged API to ArrowSpace, mirroring the Rust trait impl.
ArrowSpace.start_clustering = staticmethod(start_clustering)
ArrowSpace.eigenmaps = eigenmaps
ArrowSpace.compute_taumode = compute_taumode
ArrowSpace.search = search
