"""Johnson-Lindenstrauss random projection with implicit (seed-only) storage.

Accelerator port of the reference's reduction module (reference:
reduction.rs:126-203).  The projection matrix is never stored: only
(original_dim, reduced_dim, seed) — 8 bytes of seed — and the Gaussian
matrix is regenerated deterministically on demand.  The reference uses a
ChaCha8 stream; here the same property is provided by ``jax.random``
(threefry) keyed on the seed, with scale 1/√r.  Determinism, linearity and
scale behaviour match; the exact random matrix differs (documented
divergence — the reference's matrix is itself seed-random).
"""

from __future__ import annotations

import math
import secrets
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .config import HIGHEST, default_dtype
from .utils.log import get_logger

logger = get_logger("arrowspace.reduction")

__all__ = ["compute_jl_dimension", "ImplicitProjection", "project_matrix"]


def compute_jl_dimension(n_points: int, epsilon: float) -> int:
    """r = max(32, ceil(8·ln(n)/ε²)) (reference: reduction.rs:126-139)."""
    log_n = math.log(n_points)
    jl_dim = math.ceil(8.0 * log_n / (epsilon ** 2))
    return max(jl_dim, 32)


@dataclass
class ImplicitProjection:
    """Seed-deterministic Gaussian projection (reference: reduction.rs:168-203).

    Stores only (original_dim, reduced_dim, seed); the F×r matrix is
    regenerated from the seed on every use.
    """

    original_dim: int
    reduced_dim: int
    seed: int = field(default_factory=lambda: secrets.randbits(64))

    def matrix(self, dtype=None) -> jax.Array:
        """Regenerate the F×r Gaussian matrix, scaled by 1/√r."""
        dtype = dtype or default_dtype()
        key = jax.random.key(self.seed % (2 ** 63))
        scale = 1.0 / math.sqrt(self.reduced_dim)
        gauss = jax.random.normal(
            key, (self.original_dim, self.reduced_dim), dtype=jnp.float32)
        return (gauss * scale).astype(dtype)

    def _host_matrix(self) -> np.ndarray:
        """Host copy of the regenerated matrix, cached: the matrix is a
        pure function of the 8-byte seed (the reference regenerates it on
        every projection; caching is observationally identical and avoids
        a device round trip per query)."""
        cached = getattr(self, "_host_matrix_cache", None)
        if cached is None:
            cached = np.asarray(self.matrix(dtype=jnp.float32),
                                dtype=np.float64)
            self._host_matrix_cache = cached
        return cached

    def project(self, query) -> np.ndarray:
        """Project a single F-vector to r dims (reference: reduction.rs:185-202).
        Runs on the host — a single-vector matmul is dispatch-bound on an
        accelerator."""
        q = np.asarray(query, dtype=np.float64)
        return q[: self.original_dim] @ self._host_matrix()

    def project_batch_host(self, rows: np.ndarray) -> np.ndarray:
        """Batched host projection: one matmul for all rows."""
        rows = np.asarray(rows, dtype=np.float64)
        return rows[:, : self.original_dim] @ self._host_matrix()

    def project_device(self, rows: jax.Array) -> jax.Array:
        """Batched device-side projection: (N, F) @ (F, r), at
        Precision.HIGHEST."""
        p = self.matrix(dtype=rows.dtype)
        return jnp.dot(rows, p, preferred_element_type=rows.dtype,
                       precision=HIGHEST)


def project_matrix(data, projection: ImplicitProjection) -> jax.Array:
    """Project every row of an (N, F) matrix (reference: reduction.rs:141-166)."""
    rows = jnp.asarray(data)
    return projection.project_device(rows)
