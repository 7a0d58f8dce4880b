"""Energy-first (cosine-free) pipeline: optical compression, diffusion,
sub-centroid splitting, energy-distance kNN graph, and energy search.

Accelerator re-design of the reference's energymaps module (reference:
energymaps.rs:28-896).  Stage mapping:

- optical compression  -> seeded 2D projection (matmul) + host grid binning
  (energymaps.rs:151-245);
- bootstrap L₀         -> the standard dense graph build over centroid ROWS
  (X×X, un-transposed — the deliberate orientation difference from the
  canonical F′×F′ path, energymaps.rs:247-280);
- heat diffusion       -> X ← X - η·(L@X) as a lax.scan of matmuls
  (energymaps.rs:283-311);
- splitting            -> dispersion quantile + gather/concat
  (energymaps.rs:313-366);
- energy-distance kNN  -> pairwise matmuls + top-k + max-symmetrise
  (energymaps.rs:706-817);
- search_energy        -> batched λ-proximity + projected-Dirichlet scores
  (energymaps.rs:368-407).

Documented divergence: the reference's ``node_energy_and_dispersion``
computes edge weights as ``-(L_ij.max(0))`` (energymaps.rs:576), which is
identically zero for any true Laplacian (off-diagonals are ≤ 0), so its
dispersion G is always 0 and every node is split.  That contradicts both
the module's own docs and taumode.rs:580 (which uses ``(-L_ij).max(0)``).
We implement the intended semantics w = max(-L_ij, 0); the reference
behaviour can be recovered with ``EnergyParams.reference_dispersion_bug=True``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import HIGHEST
from .ops.search import plane_chunk_rows, scan_topk, score_dot

from .core import ArrowSpace
from .graph import GraphLaplacian, GraphParams
from .laplacian import build_laplacian_matrix
from .reduction import ImplicitProjection
from .utils.log import get_logger

logger = get_logger("arrowspace.energymaps")

__all__ = ["EnergyParams", "optical_compress_centroids",
           "bootstrap_centroid_laplacian", "diffuse_and_split_subcentroids",
           "node_energy_and_dispersion", "build_energy_laplacian",
           "search_energy", "search_energy_batch", "build_energy", "robust_scale",
           "bounded_l2_energy", "ProjectedEnergyParams"]


@dataclass
class EnergyParams:
    """Energy-pipeline parameters (reference: energymaps.rs:28-71)."""

    optical_tokens: Optional[int] = None
    trim_quantile: float = 0.1
    eta: float = 0.1
    steps: int = 4
    split_quantile: float = 0.9
    neighbor_k: int = 8
    split_tau: float = 0.15
    w_lambda: float = 1.0
    w_disp: float = 0.5
    w_dirichlet: float = 0.25
    candidate_m: int = 32
    # opt-in reproduction of the reference's zero-dispersion behaviour
    reference_dispersion_bug: bool = False
    # Lift the reference's n <= F λ ceiling (taumode.rs:574 OOB panic):
    # with True, λ computations zero-pad items to graphs with more
    # sub-centroids than item coordinates, so splitting can grow the
    # energy graph beyond F nodes.  Default False = reference parity.
    allow_tall_graphs: bool = False


@dataclass
class ProjectedEnergyParams:
    """Projection-aware scoring weights (reference: energymaps.rs:825-836)."""
    w_lambda: float = 1.0
    w_dirichlet: float = 0.5
    eps_norm: float = 1e-9


def robust_scale(x) -> float:
    """1.4826·MAD robust scale, floored at 1e-9
    (reference: energymaps.rs:525-539)."""
    x = np.asarray(x, dtype=np.float64)
    if x.size == 0:
        return 1.0
    v = np.sort(x)
    median = v[v.size // 2]
    devs = np.sort(np.abs(v - median))
    mad = devs[devs.size // 2]
    return max(1.4826 * mad, 1e-9)


def bounded_l2_energy(diff) -> float:
    """‖d‖/(1+‖d‖), capped at 1 (reference: energymaps.rs:844-847)."""
    num = float(np.linalg.norm(np.asarray(diff, dtype=np.float64)))
    return min(num / (1.0 + num), 1.0)


# ---------------------------------------------------------------------------
# Optical compression (energymaps.rs:151-245)
# ---------------------------------------------------------------------------

def optical_compress_centroids(centroids, token_budget: int,
                               trim_quantile: float,
                               seed: Optional[int] = None) -> jnp.ndarray:
    """2D spatial binning with low-activation pooling.  The 2D projection is
    seed-deterministic when a seed is supplied (the reference always draws a
    fresh OS seed — recorded divergence for reproducibility)."""
    cent = np.asarray(centroids, dtype=np.float64)
    x, f = cent.shape
    if token_budget == 0 or token_budget >= x:
        logger.info("Optical compression skipped: budget %d >= centroids %d",
                    token_budget, x)
        return jnp.asarray(centroids)

    proj = ImplicitProjection(f, 2, **({"seed": seed} if seed is not None else {}))
    xy = np.asarray(proj.project_device(jnp.asarray(cent)))  # (x, 2)

    g = math.ceil(math.sqrt(token_budget))
    minx, maxx = xy[:, 0].min(), xy[:, 0].max()
    miny, maxy = xy[:, 1].min(), xy[:, 1].max()
    bx = np.clip(np.floor((xy[:, 0] - minx) / (maxx - minx + 1e-9) * g),
                 0, g - 1).astype(int)
    by = np.clip(np.floor((xy[:, 1] - miny) / (maxy - miny + 1e-9) * g),
                 0, g - 1).astype(int)
    bin_ids = by * g + bx

    norms = np.linalg.norm(cent, axis=1)
    out_rows = []
    for b in range(g * g):
        members = np.nonzero(bin_ids == b)[0]
        if members.size == 0:
            continue
        if members.size > 4:
            # trim the top trim_quantile by norm (energymaps.rs:431-448);
            # floor(x+0.5) = Rust f64::round (half away from zero), NOT
            # Python's banker's rounding
            order = members[np.argsort(norms[members], kind="stable")]
            cut = int(np.clip(
                np.floor(members.size * (1.0 - trim_quantile) + 0.5),
                1, members.size))
            members = order[:cut]
        out_rows.append(cent[members].mean(axis=0))
        if len(out_rows) >= token_budget:
            break

    if len(out_rows) < token_budget:
        # top-up with lowest-norm original centroids (energymaps.rs:217-240)
        order = np.argsort(norms, kind="stable")
        for i in order:
            if len(out_rows) >= token_budget:
                break
            out_rows.append(cent[i])

    out = np.stack(out_rows, axis=0)
    logger.info("Optical compression complete: %d -> %d centroids", x,
                out.shape[0])
    return jnp.asarray(out)


# ---------------------------------------------------------------------------
# Bootstrap Laplacian (energymaps.rs:247-280)
# ---------------------------------------------------------------------------

def bootstrap_centroid_laplacian(centroids, k: int, normalise: bool,
                                 sparsity_check: bool) -> GraphLaplacian:
    """L₀ over centroid ROWS (X×X, un-transposed — energymaps.rs:270)."""
    centroids = jnp.asarray(centroids)
    x = centroids.shape[0]
    params = GraphParams(
        eps=1e-3,
        k=min(k, x - 1),
        topk=min(k, 4, x - 1),
        p=2.0,
        sigma=None,
        normalise=normalise,
        sparsity_check=False,  # disabled for small matrices
    )
    gl = build_laplacian_matrix(centroids, params, n_items=x)
    assert gl.nnodes == x, f"L0 must be in centroid space ({x}x{x})"
    return gl


# ---------------------------------------------------------------------------
# Diffusion + splitting (energymaps.rs:283-366)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("steps",))
def _diffuse(work: jax.Array, lap: jax.Array, eta: jax.Array, *, steps: int):
    """x ← x - η·Lx for `steps` iterations, as a lax.scan of matmuls."""
    def body(carry, _):
        out = carry - eta * jnp.dot(lap, carry,
                                    preferred_element_type=carry.dtype,
                                    precision=HIGHEST)
        return out, None
    out, _ = jax.lax.scan(body, work, None, length=steps)
    return out


@functools.partial(jax.jit, static_argnames=("k", "bug_compat"))
def _energy_dispersion_jit(x: jax.Array, lap: jax.Array, *, k: int,
                           bug_compat: bool):
    """Vectorised node energy (Rayleigh per node row) and dispersion over the
    k-NN by L2 (energymaps.rs:550-596)."""
    n = x.shape[0]
    dt = x.dtype
    lx = jnp.dot(lap, x, preferred_element_type=dt,
                 precision=HIGHEST)                          # (n, f)
    denom = jnp.maximum(jnp.sum(x * x, axis=1), 1e-9)
    lam = jnp.sum(x * lx, axis=1) / denom

    # pairwise L2² for neighbour selection
    sq = jnp.sum(x * x, axis=1)
    d2 = sq[:, None] - 2.0 * jnp.dot(x, x.T, preferred_element_type=dt,
                                     precision=HIGHEST) \
        + sq[None, :]
    d2 = d2.at[jnp.arange(n), jnp.arange(n)].set(jnp.inf)
    kk = min(k, n - 1)
    neg, nbr = jax.lax.top_k(-d2, kk)                        # (n, kk)
    nd2 = jnp.maximum(-neg, 0.0)

    if bug_compat:
        # reference: w = -(L_ij.max(0)) -> 0 for true Laplacians
        w = -jnp.maximum(lap[jnp.arange(n)[:, None], nbr], 0.0)
    else:
        w = jnp.maximum(-lap[jnp.arange(n)[:, None], nbr], 0.0)
    parts = jnp.maximum(w * nd2, 0.0)
    s = jnp.sum(parts, axis=1)
    shares = jnp.where(s[:, None] > 0.0, parts / jnp.maximum(s[:, None], 1e-30),
                       0.0)
    gini = jnp.where(s > 0.0, jnp.sum(shares * shares, axis=1), 0.0)
    return lam, gini


def node_energy_and_dispersion(x, gl: GraphLaplacian, k: int,
                               bug_compat: bool = False):
    """(lambda, gini) per node (reference: energymaps.rs:550-596)."""
    xa = jnp.asarray(x)
    lam, gini = _energy_dispersion_jit(xa, gl.matrix.astype(xa.dtype),
                                       k=k, bug_compat=bug_compat)
    return np.asarray(lam), np.asarray(gini)


def diffuse_and_split_subcentroids(centroids, l0: GraphLaplacian,
                                   p: EnergyParams) -> jnp.ndarray:
    """Diffusion smoothing + split of high-dispersion nodes
    (reference: energymaps.rs:283-366)."""
    cent = jnp.asarray(centroids)
    x, f = cent.shape
    work = _diffuse(cent, l0.matrix.astype(cent.dtype),
                    jnp.asarray(p.eta, dtype=cent.dtype), steps=p.steps)

    lam, gini = node_energy_and_dispersion(
        work, l0, p.neighbor_k, bug_compat=p.reference_dispersion_bug)

    g_sorted = np.sort(gini)
    q_idx = int(np.floor((g_sorted.size - 1) * p.split_quantile + 0.5))
    thresh = g_sorted[q_idx]

    work_np = np.asarray(work, dtype=np.float64)
    rows = [work_np]
    split_idx = np.nonzero(gini >= thresh)[0]
    # neighbour stats for every split node, fully vectorised
    if split_idx.size:
        sq = np.sum(work_np * work_np, axis=1)
        d2 = sq[split_idx][:, None] - 2.0 * work_np[split_idx] @ work_np.T \
            + sq[None, :]
        d2[np.arange(split_idx.size), split_idx] = np.inf
        kk = min(p.neighbor_k, x - 1)
        nbrs = np.argpartition(d2, kk - 1, axis=1)[:, :kk]   # (S, kk)
        means = work_np[nbrs].mean(axis=1)                   # (S, F)
        diffs = work_np[split_idx] - means
        nrms = np.maximum(np.linalg.norm(diffs, axis=1, keepdims=True), 1e-9)
        directions = diffs / nrms
        d_means = diffs.mean(axis=1, keepdims=True)
        std_locs = np.sqrt(np.mean((diffs - d_means) ** 2, axis=1))
        taus_s = (p.split_tau * np.maximum(std_locs, 1e-6))[:, None]
        rows.append(work_np[split_idx] + taus_s * directions)
        rows.append(work_np[split_idx] - taus_s * directions)

    out = np.concatenate(rows, axis=0)
    logger.info("Sub-centroid generation: %d -> %d centroids (%d splits)",
                x, out.shape[0], split_idx.size)
    return jnp.asarray(out, dtype=cent.dtype)


# ---------------------------------------------------------------------------
# Energy Laplacian (energymaps.rs:706-817)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("m", "keep_k"))
def _energy_knn_jit(xs: jax.Array, lam: jax.Array, gini: jax.Array,
                    s_l: jax.Array, s_g: jax.Array, w_lambda: jax.Array,
                    w_disp: jax.Array, w_dirichlet: jax.Array,
                    *, m: int, keep_k: int):
    """Energy-distance kNN with candidate-M pruning, w = exp(-d),
    max-symmetrisation, L = D - A. One XLA program."""
    n = xs.shape[0]
    dt = xs.dtype
    sq = jnp.sum(xs * xs, axis=1)
    d2 = sq[:, None] - 2.0 * jnp.dot(xs, xs.T, preferred_element_type=dt,
                                     precision=HIGHEST) \
        + sq[None, :]
    d2 = d2.at[jnp.arange(n), jnp.arange(n)].set(jnp.inf)
    mm = min(m, n - 1)
    _, cand = jax.lax.top_k(-d2, mm)                         # (n, mm)

    d_lambda = jnp.abs(lam[:, None] - lam[cand]) / s_l
    d_gini = jnp.abs(gini[:, None] - gini[cand]) / s_g
    # bounded L2 over the candidate pairs
    l2 = jnp.sqrt(jnp.maximum(
        d2[jnp.arange(n)[:, None], cand], 0.0))
    r_pair = jnp.minimum(l2 / (1.0 + l2), 1.0)
    dist = w_lambda * d_lambda + w_disp * d_gini + w_dirichlet * r_pair

    kk = min(keep_k, mm)
    neg, sel = jax.lax.top_k(-dist, kk)                      # keep k smallest
    sel_j = cand[jnp.arange(n)[:, None], sel]
    w = jnp.exp(neg)                                         # exp(-dist)

    adj = jnp.zeros((n, n), dtype=dt)
    adj = adj.at[jnp.arange(n)[:, None].repeat(kk, 1).reshape(-1),
                 sel_j.reshape(-1)].max(w.reshape(-1))
    adj = jnp.maximum(adj, adj.T)                            # max-symmetrise
    adj = adj * (1.0 - jnp.eye(n, dtype=dt))
    lap = jnp.diag(jnp.sum(adj, axis=1)) - adj
    return adj, lap, jnp.sum(adj > 0)


def build_energy_laplacian(builder, sub_centroids, energy_params: EnergyParams
                           ) -> Tuple[GraphLaplacian, np.ndarray, np.ndarray]:
    """Energy-distance kNN Laplacian (reference: energymaps.rs:706-817)."""
    xs = jnp.asarray(sub_centroids)
    x = xs.shape[0]
    logger.info("build_energy_laplacian: %d sub-centroids, k=%d", x,
                builder.lambda_k)

    l_boot = bootstrap_centroid_laplacian(
        xs, max(energy_params.neighbor_k, builder.lambda_k),
        builder.normalise, builder.sparsity_check)
    lam, gini = node_energy_and_dispersion(
        xs, l_boot, max(energy_params.neighbor_k, builder.lambda_k),
        bug_compat=energy_params.reference_dispersion_bug)
    s_l = max(robust_scale(lam), 1e-9)
    s_g = max(robust_scale(gini), 1e-9)

    dt = xs.dtype
    m = max(energy_params.candidate_m, builder.lambda_k)
    _, lap, nnz_off = _energy_knn_jit(
        xs, jnp.asarray(lam, dtype=dt), jnp.asarray(gini, dtype=dt),
        jnp.asarray(s_l, dtype=dt), jnp.asarray(s_g, dtype=dt),
        jnp.asarray(energy_params.w_lambda, dtype=dt),
        jnp.asarray(energy_params.w_disp, dtype=dt),
        jnp.asarray(energy_params.w_dirichlet, dtype=dt),
        m=m, keep_k=builder.lambda_k)

    gl = GraphLaplacian(
        init_data=xs,
        matrix=lap,
        nnodes=x,
        graph_params=GraphParams(
            eps=builder.lambda_eps, k=builder.lambda_k,
            topk=builder.lambda_topk, p=2.0, sigma=None,
            normalise=builder.normalise,
            sparsity_check=builder.sparsity_check),
        structural_nnz=x + int(nnz_off),
    )
    logger.info("Energy Laplacian built: %dx%d, %d nnz", x, x, gl.nnz())
    return gl, lam, gini


# ---------------------------------------------------------------------------
# Energy search (energymaps.rs:368-407, 849-896)
# ---------------------------------------------------------------------------

def _projected_dirichlet_batch(aspace: ArrowSpace, diffs: jax.Array
                               ) -> jax.Array:
    """Batched projected Dirichlet: signals SpMV if shapes line up, else
    bounded L2 (reference: energymaps.rs:865-881)."""
    if (aspace.signals is not None and aspace.signals.shape[0] > 0
            and aspace.signals.shape[1] == diffs.shape[1]):
        y = jnp.dot(diffs, aspace.signals.T,
                    preferred_element_type=diffs.dtype, precision=HIGHEST)
        num = jnp.sqrt(jnp.sum(y * y, axis=1))
    else:
        num = jnp.sqrt(jnp.sum(diffs * diffs, axis=1))
    return jnp.minimum(num / (1.0 + num), 1.0)


@functools.partial(jax.jit, static_argnames=("k", "use_signals"))
def _energy_score_topk(q_proj, lambda_q, items_proj, item_lambdas, signals,
                       w_lambda, w_dirichlet, *, k: int, use_signals: bool):
    """One fused program: λ proximity + projected Dirichlet + top-k.
    This is the in-memory path for corpora up to ENERGY_CHUNK items;
    larger corpora go through energy_topk in z-space, which never
    materialises the (B, N, F') diffs tensor."""
    diffs = q_proj[:, None, :] - items_proj[None, :, :]      # (B, N, F')
    if use_signals:
        y = jnp.einsum("bnf,gf->bng", diffs, signals,
                       preferred_element_type=diffs.dtype,
                       precision=HIGHEST)
        num = jnp.sqrt(jnp.sum(y * y, axis=2))
    else:
        num = jnp.sqrt(jnp.sum(diffs * diffs, axis=2))
    d_dir = jnp.minimum(num / (1.0 + num), 1.0)
    d_lambda = jnp.abs(lambda_q[:, None] - item_lambdas[None, :])
    scores = -(w_lambda * d_lambda + w_dirichlet * d_dir)
    return jax.lax.top_k(scores, k)


# In-memory ceiling for search_energy_batch: above this many items the
# batched search runs in z-space (energy_topk), whose working set is the
# bounded (B, chunk) plane instead of the (B, N, F') diffs tensor (~65 GB
# at 1M x 64 x 256).
ENERGY_CHUNK = 65536


def energy_topk(z_q, lambda_q, z_items, item_lambdas, w_lambda,
                w_dirichlet, *, k: int, n_live=None, chunk: int = 0):
    """Energy top-k in z-space (unjitted: the sessions, the live
    sessions and every mesh shard trace this same code).

    The projected Dirichlet distributes through the linear map:
    ||S(q - x)|| = ||Sq - Sx||, so with z := x Sᵀ precomputed once per
    corpus (and z := x_proj when no signals are present) the score needs
    only pairwise z-distances, via the ||a-b||² = ||a||² - 2a·b + ||b||²
    expansion (the dot at Precision.HIGHEST).  The (B, N) plane is
    bounded like the cosine step's: ops.search.scan_topk walks the
    corpus in row chunks (chunk=0 derives them from SCORE_PLANE_BYTES)
    with a running top-k, and ties resolve to the lowest global index.

    n_live (optional traced int32) masks rows >= n_live, for
    live.LiveEnergySearchSession's capacity-padded corpus.

    Reference anchor: energymaps.rs:368-407 (search_energy scoring).
    """
    b = z_q.shape[0]
    n, g = z_items.shape
    dt = z_q.dtype
    qn = jnp.sum(z_q * z_q, axis=1)                        # (B,)
    tiny, big = jnp.finfo(dt).tiny, jnp.finfo(dt).max * 0.5

    def score_rows(start, rows):
        if rows == n:
            z_c, lam_c = z_items, item_lambdas
        else:
            z_c = jax.lax.dynamic_slice(z_items, (start, 0 * start),
                                       (rows, g))
            lam_c = jax.lax.dynamic_slice(item_lambdas, (start,), (rows,))
        # scores stay SHIFTED by +wd (sc' = wd/(1+s) - wl·|Δλ|; true =
        # sc' - wd) through the scan; the restore happens once at the
        # end.  The reference's min(num/(1+num), 1) clamp is dead for
        # finite num, and this form gives the correct limit (0) at
        # num=inf where num/(1+num) would be NaN.
        d2 = ((qn[:, None] + jnp.sum(z_c * z_c, axis=1)[None, :])
              - 2.0 * score_dot(z_q, z_c))
        # u = wd*rsqrt((1+s)^2) with s = d2*rsqrt(d2); the clamp keeps
        # duplicates exact (u=wd) and the d2=inf overflow finite (~0)
        d2c = jnp.clip(d2, tiny, big)
        s_dir = d2c * jax.lax.rsqrt(d2c)
        u = w_dirichlet * jax.lax.rsqrt(1.0 + 2.0 * s_dir + d2c)
        return u - w_lambda * jnp.abs(lambda_q[:, None] - lam_c[None, :])

    chunk = chunk or plane_chunk_rows(b, n, k)
    s, i = scan_topk(score_rows, n, b, k, min(max(chunk, k), n), dt,
                     n_live=n_live)
    # restore the +wd shift; -inf masked slots stay -inf
    return s - w_dirichlet, i


_energy_score_topk_chunked = jax.jit(energy_topk,
                                     static_argnames=("k", "chunk"))


def energy_signals(aspace: ArrowSpace, width: int, dt):
    """(signals, use_signals) for the z-space transform: the signals
    graph when its columns match the projected width, else a (1, 1)
    placeholder with use_signals False (z = x_proj)."""
    use = (aspace.signals is not None and np.shape(aspace.signals)[0] > 0
           and np.shape(aspace.signals)[1] == width)
    sig = jnp.asarray(aspace.signals, dtype=dt) if use \
        else jnp.zeros((1, 1), dtype=dt)
    return sig, use


def energy_query_z(q_proj, signals, use_signals: bool):
    """Query z = q_proj Sᵀ (identity without signals), Precision.HIGHEST."""
    if not use_signals:
        return q_proj
    return jnp.dot(q_proj, signals.T, preferred_element_type=q_proj.dtype,
                   precision=HIGHEST)


def _energy_z_items(aspace: ArrowSpace, items_proj, signals, use_signals):
    """Per-corpus z = x_proj Sᵀ for the z-space energy search, cached on
    the ArrowSpace (one (N, F')x(F', G) matmul, reused across batches);
    identity when no signals graph is present."""
    if not use_signals:
        return items_proj
    cache = getattr(aspace, "_energy_z_cache", None)
    if cache is not None and cache[0] == signals.shape \
            and cache[1].shape[0] == items_proj.shape[0]:
        return cache[1]
    z = energy_query_z(items_proj, signals, True)
    aspace._energy_z_cache = (signals.shape, z)
    return z


def search_energy_batch(aspace: ArrowSpace, queries, gl_energy: GraphLaplacian,
                        k: int, w_lambda: float, w_dirichlet: float):
    """Batched energy-only ranking: (B, F) queries -> (scores, ids), one
    fused device program (the serving-path variant of search_energy)."""
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float64))
    lambda_q = aspace.prepare_query_items_batch(queries, gl_energy)

    dt = aspace.data.dtype
    if aspace.projection_matrix is not None:
        q_proj = jnp.asarray(
            aspace.projection_matrix.project_batch_host(queries), dtype=dt)
    else:
        q_proj = jnp.asarray(queries, dtype=dt)
    items_proj = aspace.projected_items()
    signals, use_signals = energy_signals(aspace, items_proj.shape[1], dt)
    k_eff = min(k, aspace.nitems)
    if aspace.nitems > ENERGY_CHUNK:
        z_items = _energy_z_items(aspace, items_proj, signals, use_signals)
        top_scores, top_idx = _energy_score_topk_chunked(
            energy_query_z(q_proj, signals, use_signals),
            jnp.asarray(lambda_q, dtype=dt), z_items,
            jnp.asarray(aspace.lambdas, dtype=dt),
            jnp.asarray(w_lambda, dtype=dt),
            jnp.asarray(w_dirichlet, dtype=dt), k=k_eff)
        return np.asarray(top_scores), np.asarray(top_idx)
    top_scores, top_idx = _energy_score_topk(
        q_proj, jnp.asarray(lambda_q, dtype=dt), items_proj,
        jnp.asarray(aspace.lambdas, dtype=dt), signals,
        jnp.asarray(w_lambda, dtype=dt), jnp.asarray(w_dirichlet, dtype=dt),
        k=k_eff, use_signals=use_signals)
    return np.asarray(top_scores), np.asarray(top_idx)


def search_energy(aspace: ArrowSpace, query, gl_energy: GraphLaplacian,
                  k: int, w_lambda: float, w_dirichlet: float):
    """Energy-only ranking: score = -(wλ·|Δλ| + wD·Dirichlet)
    (reference: energymaps.rs:368-407).  The reference recomputes the query
    λ per item (energymaps.rs:884); we compute it once — same value, N×
    cheaper."""
    lambda_q = aspace.prepare_query_item(query, gl_energy)

    q_proj = aspace.project_query(np.asarray(query, dtype=np.float64)) \
        if aspace.projection_matrix is not None else np.asarray(query)
    dt = aspace.data.dtype
    items_proj = aspace.projected_items()
    diffs = jnp.asarray(q_proj, dtype=dt)[None, :] - items_proj
    d_dir = _projected_dirichlet_batch(aspace, diffs)
    d_lambda = jnp.abs(lambda_q - aspace.lambdas)
    scores = -(w_lambda * d_lambda + w_dirichlet * d_dir)
    k_eff = min(k, aspace.nitems)
    top_scores, top_idx = jax.lax.top_k(scores, k_eff)
    return [(int(i), float(s)) for i, s in
            zip(np.asarray(top_idx), np.asarray(top_scores))]


# ---------------------------------------------------------------------------
# Builder entry point (energymaps.rs:677-704)
# ---------------------------------------------------------------------------

def build_energy(builder, rows, energy_params: EnergyParams
                 ) -> Tuple[ArrowSpace, GraphLaplacian]:
    """Energy-only build (reference: energymaps.rs:677-704).  2-3× slower
    than the canonical build, as in the reference."""
    from . import eigenmaps as em

    assert builder.use_dims_reduction, \
        "When using build energy, dim reduction is needed"
    clustered = em.start_clustering(builder, rows)
    aspace, centroids = clustered.aspace, clustered.centroids

    if energy_params.optical_tokens is not None:
        centroids = optical_compress_centroids(
            centroids, energy_params.optical_tokens,
            energy_params.trim_quantile, seed=builder.clustering_seed)

    l0 = bootstrap_centroid_laplacian(
        centroids, max(energy_params.neighbor_k, builder.lambda_k),
        builder.normalise, builder.sparsity_check)

    sub_centroids = diffuse_and_split_subcentroids(centroids, l0,
                                                   energy_params)
    if energy_params.optical_tokens is not None:
        sub_centroids = optical_compress_centroids(
            sub_centroids, energy_params.optical_tokens,
            energy_params.trim_quantile, seed=builder.clustering_seed)

    gl_energy, _, _ = build_energy_laplacian(builder, sub_centroids,
                                             energy_params)
    aspace.pad_tall_graphs = energy_params.allow_tall_graphs
    em.compute_taumode(aspace, gl_energy)
    return aspace, gl_energy


# Attach trait-like methods, mirroring the Rust impls.
ArrowSpace.optical_compress_centroids = staticmethod(optical_compress_centroids)
ArrowSpace.bootstrap_centroid_laplacian = staticmethod(bootstrap_centroid_laplacian)
ArrowSpace.diffuse_and_split_subcentroids = staticmethod(diffuse_and_split_subcentroids)
ArrowSpace.search_energy = search_energy

from .builder import ArrowSpaceBuilder  # noqa: E402
ArrowSpaceBuilder.build_energy = build_energy
ArrowSpaceBuilder.build_energy_laplacian = build_energy_laplacian
