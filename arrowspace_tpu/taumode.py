"""TauMode: tau-selection policies and the synthetic λτ index transform.

Accelerator re-design of the reference's taumode module
(reference: taumode.rs:75-660).  The reference computes, per item x against
a sparse graph matrix L (CSR):

    tau       = select_tau(x, mode)                       (taumode.rs:234)
    E_raw     = x[:n]ᵀ L x[:n] / xᵀx   (0 if xᵀx <= 1e-12)  (taumode.rs:565-609)
    S         = Σ_{i≠j} w_ij (x_i - x_j)²,  w_ij = max(-L_ij, 0)
    G         = clamp(Σ_{i≠j} (w_ij (x_i - x_j)² / S)², 0, 1)
    λ         = tau · E_raw/(E_raw + tau) + (1 - tau) · G  (taumode.rs:505)

Quirks preserved deliberately (see SURVEY.md §2/§3):
- tau is selected from the item's own coordinate values (full vector),
  NOT from a cross-row energy distribution (taumode.rs:234, core.rs:547).
- When the graph has n < F nodes (JL-projected graph over raw items), the
  graph terms read only the FIRST n coordinates of the item while the
  Rayleigh denominator uses the FULL vector (taumode.rs:565-596).
- n > F is a hard error (the reference would panic on out-of-bounds).

Device mapping: the graph is a small dense n×n device matrix, so the
whole batch collapses into a handful of (N×n)·(n×n) matmuls:

    E numerator: rowsum((Xn @ L) * Xn)
    S          : Xn² @ d_r + Xn² @ d_c - 2·rowsum((Xn @ W) * Xn)
    G numerator: Σ_ij W²_ij (x_i - x_j)⁴ expanded into moments of Xn
                 (powers 1..4 against W² — still pure matmuls)

A ``direct`` method (chunked N×n×n broadcast) is kept as the
high-precision oracle; both methods are tested against each other.
Every dot of the λ chain runs at ``lax.Precision.HIGHEST`` (see
synthetic_lambda_batch), for items and queries alike.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .config import DENOM_EPS, HIGHEST, TAUMODE_WINDOW_BYTES, TAU_FLOOR
from .utils.log import get_logger

logger = get_logger("arrowspace.taumode")

__all__ = ["TauMode", "TAU_FLOOR", "select_tau", "select_tau_batch",
           "synthetic_lambda_batch", "compute_taumode_lambdas",
           "prepare_lambdas"]


@dataclass(frozen=True)
class TauMode:
    """Tau-selection policy (reference: taumode.rs:75-82).

    kind: one of "fixed" | "median" | "mean" | "percentile".
    value: the fixed tau or the percentile in [0, 1].
    """

    kind: str = "median"
    value: float = 0.0

    # --- constructors mirroring the Rust enum variants -------------------
    @staticmethod
    def fixed(v: float) -> "TauMode":
        return TauMode("fixed", float(v))

    @staticmethod
    def median() -> "TauMode":
        return TauMode("median")

    @staticmethod
    def mean() -> "TauMode":
        return TauMode("mean")

    @staticmethod
    def percentile(p: float) -> "TauMode":
        return TauMode("percentile", float(p))

    def __str__(self) -> str:  # Display parity (taumode.rs:663-672)
        if self.kind == "fixed":
            return f"Fixed({_fmt_float(self.value)})"
        if self.kind == "percentile":
            return f"Percentile({_fmt_float(self.value)})"
        return self.kind.capitalize()

    def to_config(self):
        """Serializable form for metadata (storage parity)."""
        if self.kind in ("fixed", "percentile"):
            return {self.kind.capitalize(): self.value}
        return self.kind.capitalize()

    @staticmethod
    def from_config(cfg) -> "TauMode":
        if isinstance(cfg, str):
            return TauMode(cfg.lower())
        if isinstance(cfg, dict):
            (k, v), = cfg.items()
            return TauMode(k.lower(), float(v))
        raise ValueError(f"bad TauMode config: {cfg!r}")


def _fmt_float(v: float) -> str:
    # Rust Display for f64 prints "0.5" not "0.50000"; repr of Python float
    # is close enough for the cookie-string format.
    out = repr(float(v))
    return out[:-2] if out.endswith(".0") else out


TAUDEFAULT = TauMode.median()


# ---------------------------------------------------------------------------
# select_tau — host scalar version (reference: taumode.rs:87-127)
# ---------------------------------------------------------------------------

def select_tau(energies: Sequence[float], mode: TauMode) -> float:
    """Strictly-positive tau from a value set; filters non-finite values and
    floors at TAU_FLOOR (reference: taumode.rs:87-127)."""
    if mode.kind == "fixed":
        t = mode.value
        return t if np.isfinite(t) and t > 0.0 else TAU_FLOOR

    arr = np.asarray(energies, dtype=np.float64)
    finite = arr[np.isfinite(arr)]

    if mode.kind == "mean":
        m = float(finite.mean()) if finite.size else 0.0
        return max(m, TAU_FLOOR)

    if finite.size == 0:
        return TAU_FLOOR
    v = np.sort(finite)
    if mode.kind == "percentile":
        pp = min(max(mode.value, 0.0), 1.0)
        # round-half-away-from-zero like Rust f64::round
        idx = int(np.floor((v.size - 1) * pp + 0.5))
        return max(float(v[idx]), TAU_FLOOR)
    # median: even length averages the two mid elements (taumode.rs:119-124)
    if v.size % 2 == 1:
        return max(float(v[v.size // 2]), TAU_FLOOR)
    mid = 0.5 * (float(v[v.size // 2 - 1]) + float(v[v.size // 2]))
    return max(mid, TAU_FLOOR)


# ---------------------------------------------------------------------------
# select_tau_batch — vectorised per-row tau on device
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("mode",))
def select_tau_batch(x: jax.Array, mode: TauMode) -> jax.Array:
    """Per-row tau for a batch of item vectors (N, F) -> (N,).

    Matches select_tau exactly, including non-finite filtering: each row is
    sorted with non-finite values pushed to the end, and the order statistic
    is taken over the finite prefix only.
    """
    n_rows, f = x.shape
    dt = x.dtype

    if mode.kind == "fixed":
        t = mode.value
        t = t if np.isfinite(t) and t > 0.0 else TAU_FLOOR
        return jnp.full((n_rows,), t, dtype=dt)

    finite = jnp.isfinite(x)
    m = jnp.sum(finite, axis=1)  # finite count per row

    if mode.kind == "mean":
        s = jnp.sum(jnp.where(finite, x, 0.0), axis=1)
        mean = jnp.where(m > 0, s / jnp.maximum(m, 1), 0.0)
        return jnp.maximum(mean, TAU_FLOOR).astype(dt)

    # median / percentile: sort with non-finite mapped to +inf (sorts last)
    big = jnp.asarray(jnp.inf, dtype=dt)
    xs = jnp.sort(jnp.where(finite, x, big), axis=1)

    if mode.kind == "percentile":
        pp = min(max(mode.value, 0.0), 1.0)
        idx = jnp.floor((m - 1).astype(jnp.float32) * pp + 0.5).astype(jnp.int32)
        idx = jnp.clip(idx, 0, f - 1)
        val = jnp.take_along_axis(xs, idx[:, None], axis=1)[:, 0]
        out = jnp.where(m > 0, val, TAU_FLOOR)
        return jnp.maximum(out, TAU_FLOOR).astype(dt)

    # median
    lo = jnp.clip((jnp.maximum(m, 1) - 1) // 2, 0, f - 1)
    hi = jnp.clip(jnp.maximum(m, 1) // 2, 0, f - 1)
    vlo = jnp.take_along_axis(xs, lo[:, None], axis=1)[:, 0]
    vhi = jnp.take_along_axis(xs, hi[:, None], axis=1)[:, 0]
    med = 0.5 * (vlo + vhi)
    out = jnp.where(m > 0, med, TAU_FLOOR)
    return jnp.maximum(out, TAU_FLOOR).astype(dt)


# ---------------------------------------------------------------------------
# synthetic lambda — batched, dense graph
# ---------------------------------------------------------------------------

def _graph_weights(laplacian: jax.Array) -> jax.Array:
    """Edge weights w_ij = max(-L_ij, 0) off-diagonal, 0 on the diagonal
    (reference: taumode.rs:574-584 treats only i≠j entries)."""
    n = laplacian.shape[0]
    w = jnp.maximum(-laplacian, 0.0)
    return w * (1.0 - jnp.eye(n, dtype=laplacian.dtype))


@functools.partial(jax.jit, static_argnames=("method", "pad_items"))
def synthetic_lambda_batch(
    items: jax.Array,      # (N, F) item vectors (full, possibly F > n)
    laplacian: jax.Array,  # (n, n) dense graph matrix (Laplacian or signals)
    taus: jax.Array,       # (N,) per-item tau
    *,
    method: str = "matmul",
    pad_items: bool = False,
) -> jax.Array:
    """Batched synthetic λ (reference: taumode.rs:552-660, vectorised).

    λ_i = τ_i · E_i/(E_i + τ_i) + (1 - τ_i) · clamp(G_i, 0, 1)

    pad_items=True lifts the reference's n <= F ceiling: items are
    zero-extended to the n graph coordinates (missing coordinates read as
    0 — the natural extension: padded coordinates contribute nothing to
    the graph terms and the Rayleigh denominator keeps the full original
    vector).  Default False preserves the reference's hard error
    (taumode.rs:574 index OOB), see EnergyParams.allow_tall_graphs.

    Precision: every graph dot runs at lax.Precision.HIGHEST — item λ
    (the build, live ingestion) and query λ (every search API) share one
    rounding, and an f32 dot never falls to TF32 (~1e-3 λ error, against
    the 1e-5 target).
    """
    n = laplacian.shape[0]
    big_f = items.shape[1]
    if n > big_f and not pad_items:
        raise ValueError(
            f"graph has {n} nodes but items have only {big_f} coordinates; "
            "the reference panics on this (taumode.rs:574 index OOB)"
        )
    if n > big_f:
        xn = jnp.pad(items, ((0, 0), (0, n - big_f)))
    else:
        xn = items[:, :n]  # graph terms read only the first n coords
    dt = items.dtype

    # Rayleigh numerator over the FULL L (diagonal included).
    xl = jnp.dot(xn, laplacian.T, preferred_element_type=dt,
                 precision=HIGHEST)
    numerator = jnp.sum(xl * xn, axis=1)

    # Denominator over the FULL item vector (taumode.rs:596).
    denom = jnp.sum(items * items, axis=1)
    e_raw = jnp.where(denom > DENOM_EPS, numerator / jnp.maximum(denom, DENOM_EPS), 0.0)

    w = _graph_weights(laplacian)

    if method == "matmul":
        # S = Σ_ij W_ij (x_i - x_j)² = x²·d_r + x²·d_c - 2 xᵀWx
        d_r = jnp.sum(w, axis=1)
        d_c = jnp.sum(w, axis=0)
        x2 = xn * xn
        xwx = jnp.sum(jnp.dot(xn, w.T, preferred_element_type=dt,
                              precision=HIGHEST) * xn, axis=1)
        s = jnp.dot(x2, d_r, preferred_element_type=dt,
                    precision=HIGHEST) \
            + jnp.dot(x2, d_c, preferred_element_type=dt,
                      precision=HIGHEST) - 2.0 * xwx

        # G numerator = Σ_ij W²_ij (x_i - x_j)⁴ expanded in moments:
        # (x_i - x_j)⁴ = x_i⁴ + x_j⁴ + 6 x_i²x_j² - 4 x_i³x_j - 4 x_i x_j³
        w2 = w * w
        d2_r = jnp.sum(w2, axis=1)
        d2_c = jnp.sum(w2, axis=0)
        x3 = x2 * xn
        x4 = x2 * x2
        t_a = jnp.dot(x4, d2_r, preferred_element_type=dt,
                      precision=HIGHEST) \
            + jnp.dot(x4, d2_c, preferred_element_type=dt,
                      precision=HIGHEST)
        t_b = 6.0 * jnp.sum(jnp.dot(x2, w2.T, preferred_element_type=dt,
                                    precision=HIGHEST) * x2, axis=1)
        t_c = -4.0 * jnp.sum(jnp.dot(x3, w2.T, preferred_element_type=dt,
                                     precision=HIGHEST) * xn, axis=1)
        t_d = -4.0 * jnp.sum(jnp.dot(xn, w2.T, preferred_element_type=dt,
                                     precision=HIGHEST) * x3, axis=1)
        g_num = t_a + t_b + t_c + t_d
    elif method == "direct":
        # Chunk-free direct evaluation via vmap; oracle path for parity.
        def per_item(x):
            diff = x[:, None] - x[None, :]
            e = w * diff * diff
            s_i = jnp.sum(e)
            g_i = jnp.sum(e * e)
            return s_i, g_i

        s, g_num = jax.vmap(per_item)(xn)
    else:
        raise ValueError(f"unknown method {method!r}")

    s_pos = s > 0.0
    g_raw = jnp.where(s_pos, g_num / jnp.maximum(s * s, DENOM_EPS), 0.0)
    g = jnp.clip(g_raw, 0.0, 1.0)

    e_bounded = e_raw / (e_raw + taus)
    return taus * e_bounded + (1.0 - taus) * g


def prepare_lambdas(rows, laplacian, proj, taumode: TauMode, *,
                    has_proj: bool, pad_tall: bool):
    """Fused query/item λ preparation for a jitted step (the batched
    form of core.rs:533-549): projection (Precision.HIGHEST) when the
    index was built with one, τ from the projected coordinates, then
    synthetic λ against the graph.  Returns (projected rows, λ)."""
    prep = rows if not has_proj else jnp.dot(
        rows, proj, preferred_element_type=rows.dtype, precision=HIGHEST)
    taus = select_tau_batch(prep, taumode)
    return prep, synthetic_lambda_batch(prep, laplacian, taus,
                                        pad_items=pad_tall)


def synthetic_lambda_single(
    item: Union[np.ndarray, jax.Array],
    laplacian: jax.Array,
    tau: float,
    *,
    method: str = "direct",
    pad_items: bool = False,
) -> float:
    """Single-item synthetic λ (reference: compute_synthetic_lambda_csr):
    synthetic_lambda_batch on a one-row batch."""
    item = jnp.asarray(item)
    lam = synthetic_lambda_batch(
        item[None, :], laplacian, jnp.asarray([tau], dtype=item.dtype),
        method=method, pad_items=pad_items)
    return float(lam[0])


def compute_taumode_lambdas(
    items: jax.Array,
    laplacian: jax.Array,
    taumode: TauMode,
    *,
    method: str = "matmul",
    pad_items: bool = False,
) -> jax.Array:
    """Batch driver (reference: compute_taumode_lambdas_parallel,
    taumode.rs:174-312).  tau is selected per item from its own coordinates
    (a row sort) before the λ matmul chain.

    The reference's rayon fan-out plus adaptive sequential/parallel switch
    (taumode.rs:240-246) is replaced by one XLA program: a fixed set of
    matmuls batched over all items.
    """
    n_items, n_features = items.shape
    logger.info(
        "Parallel TauMode lambda computation: items=%d features=%d graph=%dx%d mode=%s",
        n_items, n_features, laplacian.shape[0], laplacian.shape[1], taumode,
    )
    # Very large corpora: process in fixed row windows over the resident
    # array (one compiled program per window shape; transient peak =
    # corpus + one window's working set — see TAUMODE_WINDOW_BYTES).
    items = jnp.asarray(items)
    n_bytes = n_items * n_features * items.dtype.itemsize
    if n_bytes > TAUMODE_WINDOW_BYTES:
        win = TAUMODE_WINDOW_BYTES // (n_features * items.dtype.itemsize)
        win = max(1 << 14, (win >> 14) << 14)  # 16k-row granularity
        if win < n_items:  # recursion guard: windows are single-shot
            outs = []
            for c0 in range(0, n_items, win):
                w = min(win, n_items - c0)
                tile = jax.lax.dynamic_slice(
                    items, (c0, 0), (win, n_features))
                lam_w = compute_taumode_lambdas(tile, laplacian, taumode,
                                                method=method,
                                                pad_items=pad_items)
                # tail windows clamp to the last `win` rows of the
                # corpus (dynamic_slice semantics); keep the last w
                outs.append(lam_w[-w:])
            return jnp.concatenate(outs)
    taus = select_tau_batch(items, taumode)
    return synthetic_lambda_batch(items, laplacian, taus, method=method,
                                  pad_items=pad_items)
