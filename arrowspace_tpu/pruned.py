"""Exact cell-screened low-latency search (the "fewer pairs" path).

The full-scan serving step scores every corpus row per query — the right
shape for large batches, but a single query still pays the whole corpus
read.  This module prunes that work EXACTLY for small-to-mid batches:
the corpus is grouped into balanced cells with precomputed score upper
bounds, a query exact-scores only the cells whose bound can reach its
top-k, and a conservative margin + full-scan fallback preserves the
library's exactness contract.  Two kernels share the bound plane:
pruned_topk (B ≤ 16, per-query cell gather) and pruned_topk_union
(B in (16, 512], per-query cell VOTES + one shared union gather + one
flat batch matmul — see its docstring).

Reference anchor: core.rs:760-798 (search_lambda_aware) — the reference
has no pruned path; this is a latency feature on top of the same scoring
semantics.

How the bound works (on the shifted canonical plane of
ops/search._shifted_lambda_plane, s' = α·(q̂·x̂) − c1·min(|Δλ|, 1)):

  every member x̂ of a cell lies in the spherical cap of angular radius
  θr = max_x angle(x̂, ĉ) around the unit centroid ĉ; with
  θq = angle(q̂, ĉ), the exact supremum of q̂·x̂ over that cap is

    q̂·x̂ ≤ cos(max(0, θq − θr))
         = 1                            if  c ≥ cos θr   (query inside)
         = c·cos θr + √(1−c²)·sin θr    otherwise,  c := q̂·ĉ

  (the additive Cauchy-Schwarz form q̂·ĉ + max‖x̂−ĉ‖ is strictly weaker
  and goes VACUOUS on crowded data, e.g. positive-orthant corpora where
  all pairwise cosines are ~0.9).  cos θr is the smallest member dot
  x̂·ĉ, taken directly — a zero-norm member (x̂ = 0, dot 0) widens the
  cap as it must.  With the λ-range [λlo, λhi]:

    min over cell |λq − λx| ≥ dmin := max(0, λlo − λq, λq − λhi)

    s'(q, x) ≤ α·cos(max(0, θq − θr)) − c1·min(dmin, 1) =: U'(q, cell)

A query exact-scores its top-M cells by U'; if the (M+1)-th bound plus
a margin stays below its k-th candidate score, no pruned row can enter
the top-k — including ties, since the comparison is strict after the
margin — and the result equals the full scan.  Otherwise the query is
FLAGGED and the caller re-runs it through the oracle path (rare on
clustered data; universal on adversarially uniform data, where
high-dimensional cosine bounds are vacuous — the session degrades to
the full scan's cost, never to wrong results).

Provisioning: certification REQUIRES an oversampled cluster count (see
build_cells's provisioning rule).

The margin absorbs floating-point slop between the bound arithmetic and
the score arithmetic (both ~1e-5 at f32 on unit-scale data; the default
1e-3 is generous).  Every dot here — the bound plane, the metadata and
the candidate scores — runs at Precision.HIGHEST, so no TF32 rounding
(~1e-3) can eat the margin.  Candidate scores come from one 2-D matmul
with the queries as the LHS (_block_diag_dot), the shape of the full-scan
plane; duplicate corpus rows are RHS columns sharing the query's K-loop,
so they stay bitwise-tied.  Tie order among candidates is restored to
the oracle's (lowest GLOBAL id) by masked extraction or a two-key sort.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import HIGHEST
from .utils.log import get_logger

logger = get_logger(__name__)

__all__ = ["PrunedCells", "build_cells", "build_cells_device",
           "save_cells", "load_cells",
           "pruned_topk", "pruned_topk_union", "PrunedSearchSession"]


class PrunedCells(NamedTuple):
    """Cell-grouped corpus layout (device arrays).

    grouped rows are the UNIT-NORMALISED corpus in unit order, each unit
    padded to `cap` slots; `ids` is -1 in padded slots.  `radius` is -2.0
    in bucket-padding dummy units (the sentinel the kernel masks dummy
    bounds on, and the dummy marker build tests rely on)."""
    x: jax.Array        # (U*cap, F) unit-normalised rows, grouped
    lam: jax.Array      # (U*cap,) item λ, grouped (0 in padded slots)
    ids: jax.Array      # (U*cap,) int32 global row ids, -1 in padding
    cent: jax.Array     # (U, F) unit centroids (unit-normalised)
    radius: jax.Array   # (U,) max ||x̂ - ĉ|| per unit (+slack); -2 dummy
    cosr: jax.Array     # (U,) cos of the cap's angular radius (−slack)
    sinr: jax.Array     # (U,) sin of the cap's angular radius (+slack)
    lam_lo: jax.Array   # (U,) min λ per unit (+inf in dummies)
    lam_hi: jax.Array   # (U,) max λ per unit (-inf in dummies)
    cap: int
    n_units: int        # real (non-dummy) units


def _assign_chunked(xhat, cent, chunk: int):
    """argmax_c x̂·ĉ per row, scanned in fixed-size row chunks so the
    (chunk, C) score block — not an (N, C) matrix — is the working set."""
    n, f = xhat.shape
    n_pad = -n % chunk
    xp = jnp.pad(xhat, ((0, n_pad), (0, 0)))
    blocks = xp.reshape(-1, chunk, f)

    def body(_, xb):
        s = jnp.dot(xb, cent.T, preferred_element_type=xb.dtype,
                    precision=HIGHEST)
        return None, jnp.argmax(s, axis=1).astype(jnp.int32)

    _, assign = jax.lax.scan(body, None, blocks)
    return assign.reshape(-1)[:n]


_assign_chunked_jit = jax.jit(_assign_chunked, static_argnames=("chunk",))


@functools.partial(jax.jit, static_argnames=("n_cells", "chunk", "iters"))
def _lloyd_device(xhat, cent0, *, n_cells: int, chunk: int, iters: int):
    """Cosine-space Lloyd iterations (assign to max-dot centroid, update
    to the normalised member mean).  Empty clusters keep their previous
    centroid.  One jitted program; the (chunk, C) assign block keeps the
    working set bounded at any N.

    Centroid sums ride ONE-HOT MATMULS, not segment_sum: a scatter over
    N rows serialises on conflicting indices, while the (C, sub)x(sub, F)
    accumulation is a plain matmul.  The one-hot block is built in
    sub-chunks of 8192 rows so the (sub, C) indicator plane stays
    ~128 MB at C ≈ 4k.  Dots at Precision.HIGHEST."""
    n, f = xhat.shape
    sub = min(chunk, 8192)
    n_pad = -n % sub
    xp = jnp.pad(xhat, ((0, n_pad), (0, 0)))
    blocks = xp.reshape(-1, sub, f)
    base = jnp.arange(blocks.shape[0]) * sub
    cells_iota = jnp.arange(n_cells, dtype=jnp.int32)

    def iteration(cent, _):
        def acc_block(carry, inp):
            sums, counts = carry
            b0, xb = inp
            s = jnp.dot(xb, cent.T, preferred_element_type=xb.dtype,
                        precision=HIGHEST)
            a = jnp.argmax(s, axis=1).astype(jnp.int32)
            valid = (b0 + jnp.arange(sub)) < n          # mask padding
            onehot = ((a[:, None] == cells_iota[None, :])
                      & valid[:, None]).astype(xb.dtype)  # (sub, C)
            sums = sums + jax.lax.dot_general(
                onehot, xb, dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=xb.dtype,
                precision=HIGHEST)                        # (C, F)
            counts = counts + jnp.sum(onehot, axis=0)
            return (sums, counts), ()

        (sums, counts), _ = jax.lax.scan(
            acc_block,
            (jnp.zeros((n_cells, f), xhat.dtype),
             jnp.zeros((n_cells,), xhat.dtype)),
            (base, blocks))
        norms = jnp.sqrt(jnp.sum(sums * sums, axis=1, keepdims=True))
        new = jnp.where((counts[:, None] > 0) & (norms > 0),
                        sums / jnp.where(norms > 0, norms, 1.0), cent)
        return new, None

    cent, _ = jax.lax.scan(iteration, cent0, None, length=iters)
    return cent, _assign_chunked(xhat, cent, chunk)


def _unit_norm_np(rows: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(rows, axis=1, keepdims=True)
    return np.where(norms > 0, rows / np.where(norms > 0, norms, 1.0), 0.0)


def _unit_pad(u_real: int) -> int:
    """Compile-bucket padding for the unit axis: powers of two up to
    4096 (one compile serves a wide range of small corpora), then
    multiples of 1024 — a pow-2 bucket at 40k units would waste ~60% of
    the grouped corpus copy in HBM for compile reuse that large one-off
    index builds don't need."""
    p2 = max(8, 1 << int(np.ceil(np.log2(max(2, u_real)))))
    if p2 <= 4096:
        return p2
    return max(4096, -(-u_real // 1024) * 1024)


def build_cells(data, lambdas, cap: int = 256, seed: int = 0,
                iters: int = 8, dtype=None,
                n_clusters: Optional[int] = None,
                lloyd_sample: Optional[int] = None) -> PrunedCells:
    """Group the corpus into ≤cap-row units with bound metadata.

    Clusters with a device Lloyd pass (C ≈ N/cap centroids seeded from
    a random row sample), then splits each cluster into units of at most
    `cap` rows.  Unit centroids/radii/λ-ranges are computed from the
    unit's OWN rows in f64 on the host (tighter than the parent
    cluster's, and the radius gets a 1e-6 slack so the f32 bound
    arithmetic stays conservative).  The grouped layout duplicates the
    corpus — the price of contiguous cell gathers.

    Large-N knobs (the defaults reproduce the original behaviour):
    `n_clusters` caps the Lloyd centroid count below N/cap — clusters
    larger than `cap` are λ-sorted and split into several units sharing
    the cluster's angular spread, so the assign pass costs N·C·F
    instead of N·(N/cap)·F (at 10M x 128 / cap 256 that is the
    difference between ~2e16 and ~1e17 FLOPs).  `lloyd_sample` fits the
    centroids on a uniform row subsample and pays only ONE full-corpus
    assign pass.  For corpora that would round-trip the host (multi-GB),
    see build_cells_device — the fully device-resident build.

    PROVISIONING RULE (identical for both builds): set
    `n_clusters` to 2-4x the corpus's expected cluster count, never to
    the count itself.  Random-row seeding leaves ~1/e of the true
    clusters seedless (Poisson), Lloyd merges them, and a merged cell's
    cap bound is near-vacuous — at C=true the screen flagged 9-16/16
    hot queries at m_cells=8 where C=2x certified all 16 (and a 10M
    corpus at C=true flagged EVERYTHING at every m).  Oversampled C
    costs only assign FLOPs; spare centroids end up empty and are
    masked as dummies.
    """
    import time as _time
    t_start = _time.perf_counter()
    rows = np.asarray(data, dtype=np.float64)
    lam64 = np.asarray(lambdas, dtype=np.float64)
    n, f = rows.shape
    dt = dtype or (jnp.asarray(data).dtype if hasattr(data, "dtype")
                   else jnp.float32)
    cap = int(cap)
    assert cap > 0 and n > 0

    xhat64 = _unit_norm_np(rows)
    n_cells = max(1, min(n, n_clusters if n_clusters is not None
                         else -(-n // cap)))
    rng = np.random.default_rng(seed)
    seed_rows = rng.choice(n, size=n_cells, replace=False)
    t_host = _time.perf_counter()
    xhat_dev = jnp.asarray(xhat64, dtype=dt)
    xhat_dev.block_until_ready()
    t_up = _time.perf_counter()
    if n_cells == 1:
        assign = np.zeros((n,), dtype=np.int32)
    else:
        chunk = min(65536, max(1024, 1 << int(np.ceil(np.log2(max(2, n))))))
        chunk = min(chunk, 65536)
        cent0 = jnp.asarray(xhat64[seed_rows], dtype=dt)
        if lloyd_sample is not None and lloyd_sample < n:
            fit_idx = rng.choice(n, size=int(lloyd_sample), replace=False)
            cent, _ = _lloyd_device(
                jnp.asarray(xhat64[fit_idx], dtype=dt), cent0,
                n_cells=n_cells, chunk=min(chunk, int(lloyd_sample)),
                iters=iters)
            assign = np.asarray(_assign_chunked_jit(
                xhat_dev, cent, chunk=chunk))
        else:
            _, assign = _lloyd_device(xhat_dev, cent0, n_cells=n_cells,
                                      chunk=chunk, iters=iters)
            assign = np.asarray(assign)
    t_lloyd = _time.perf_counter()
    logger.info("build_cells phases: host-norm %.1fs, upload %.1fs, "
                "lloyd(compile+run) %.1fs", t_host - t_start,
                t_up - t_host, t_lloyd - t_up)

    # host pass: split clusters into ≤cap units, compute metadata in f64
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(n_cells))
    ends = np.searchsorted(sorted_assign, np.arange(n_cells), side="right")

    unit_rows = []
    for c in range(n_cells):
        members = order[starts[c]:ends[c]]
        # λ-sort within the cluster before chunking: units cut from a
        # cluster that spans multiple units get tight λ-ranges for free
        # (the cosine radius is unaffected — members share a cluster),
        # which keeps the dmin term of the bound useful at low α
        members = members[np.argsort(lam64[members], kind="stable")]
        for lo in range(0, len(members), cap):
            unit_rows.append(members[lo:lo + cap])
    u_real = len(unit_rows)
    u_pad = _unit_pad(u_real)

    # grouped rows/λ assemble directly in the KERNEL dtype (the bound
    # metadata below stays f64): an f64 staging copy doubled host RSS
    # and upload prep at multi-GB corpus sizes for values the device
    # casts anyway
    np_dt = np.dtype(jnp.dtype(dt).name)
    gx = np.zeros((u_pad * cap, f), dtype=np_dt)
    glam = np.zeros((u_pad * cap,), dtype=np_dt)
    gids = np.full((u_pad * cap,), -1, dtype=np.int32)
    cent = np.zeros((u_pad, f), dtype=np.float64)
    radius = np.full((u_pad,), -2.0, dtype=np.float64)
    cosr = np.ones((u_pad,), dtype=np.float64)
    sinr = np.zeros((u_pad,), dtype=np.float64)
    lam_lo = np.full((u_pad,), np.inf, dtype=np.float64)
    lam_hi = np.full((u_pad,), -np.inf, dtype=np.float64)
    for u, members in enumerate(unit_rows):
        m = len(members)
        xs = xhat64[members]
        gx[u * cap:u * cap + m] = xs
        glam[u * cap:u * cap + m] = lam64[members]
        gids[u * cap:u * cap + m] = members
        c_raw = xs.mean(axis=0)
        c_norm = np.linalg.norm(c_raw)
        c_hat = c_raw / c_norm if c_norm > 0 else np.zeros((f,))
        cent[u] = c_hat
        # metadata in f64 + slack: covers the f32 cast of cent and the
        # f32 bound arithmetic (unit-scale values, error ~F*eps_f32 ≪
        # 1e-6; the session margin adds another 1e-3 on top).  A
        # zero-norm centroid (cancelled rows) keeps the full-sphere cap
        # (cosr −1): every bound is 1, the unit is never pruned wrongly.
        radius[u] = float(np.sqrt(((xs - c_hat) ** 2).sum(axis=1).max())) \
            + 1e-6
        if c_norm > 0:
            cr = float(np.clip((xs @ c_hat).min(), -1.0, 1.0)) - 1e-6
        else:
            cr = -1.0
        cosr[u] = max(-1.0, cr)
        sinr[u] = min(1.0, float(np.sqrt(max(0.0, 1.0 - cosr[u] ** 2)))
                      + 1e-6)
        lam_lo[u] = lam64[members].min()
        lam_hi[u] = lam64[members].max()

    logger.info("pruned cells: %d rows -> %d units (cap %d, %d clusters, "
                "padded to %d); lloyd %.1fs, metadata %.1fs", n, u_real,
                cap, n_cells, u_pad, t_lloyd - t_start,
                _time.perf_counter() - t_lloyd)
    return PrunedCells(
        x=jnp.asarray(gx, dtype=dt), lam=jnp.asarray(glam, dtype=dt),
        ids=jnp.asarray(gids), cent=jnp.asarray(cent, dtype=dt),
        radius=jnp.asarray(radius, dtype=dt),
        cosr=jnp.asarray(cosr, dtype=dt),
        sinr=jnp.asarray(sinr, dtype=dt),
        lam_lo=jnp.asarray(lam_lo, dtype=dt),
        lam_hi=jnp.asarray(lam_hi, dtype=dt), cap=cap, n_units=u_real)


_CELLS_FORMAT = 1


def save_cells(cells: PrunedCells, path: str) -> None:
    """Persist a cell layout to one .npz (uncompressed — the grouped
    corpus is multi-GB at scale and dominates; float compression buys
    little).  A 10M x 128 layout costs minutes to BUILD (the Lloyd
    assign pass) but seconds to load, so production processes should
    load, not rebuild.  Bound metadata round-trips bitwise: the bounds
    are certificates, so the loaded layout certifies exactly the same
    queries.

    No reference analogue (serving-runtime addition): the layout is an
    acceleration structure for core.rs:760-798's exactness contract;
    the reference's nearest persistence concept is the builder's
    observational Parquet hooks (storage/parquet.rs:528-619)."""
    arrays = {f: np.asarray(getattr(cells, f))
              for f in ("x", "lam", "ids", "cent", "radius", "cosr",
                        "sinr", "lam_lo", "lam_hi")}
    np.savez(path, format=np.int64(_CELLS_FORMAT),
             cap=np.int64(cells.cap), n_units=np.int64(cells.n_units),
             **arrays)
    logger.info("pruned cells saved to %s (%.2f GB grouped rows)",
                path, arrays["x"].nbytes / 2**30)


def load_cells(path: str, dtype=None) -> PrunedCells:
    """Load a layout written by save_cells; arrays land on the default
    device.  `dtype` overrides the stored float dtype (metadata slack
    already covers an f64→f32 narrowing; widening is always safe).
    No reference analogue — see save_cells."""
    if not str(path).endswith(".npz"):
        path = str(path) + ".npz"
    with np.load(path) as z:
        fmt = int(z["format"])
        if fmt != _CELLS_FORMAT:
            raise ValueError(f"unsupported cells format {fmt} "
                             f"(this build reads {_CELLS_FORMAT})")
        dt = dtype or z["x"].dtype
        return PrunedCells(
            x=jnp.asarray(z["x"], dtype=dt),
            lam=jnp.asarray(z["lam"], dtype=dt),
            ids=jnp.asarray(z["ids"]),
            cent=jnp.asarray(z["cent"], dtype=dt),
            radius=jnp.asarray(z["radius"], dtype=dt),
            cosr=jnp.asarray(z["cosr"], dtype=dt),
            sinr=jnp.asarray(z["sinr"], dtype=dt),
            lam_lo=jnp.asarray(z["lam_lo"], dtype=dt),
            lam_hi=jnp.asarray(z["lam_hi"], dtype=dt),
            cap=int(z["cap"]), n_units=int(z["n_units"]))


# --------------------------------------------------------------------
# Device-resident cells build (the large-N path)
# --------------------------------------------------------------------

# f32 slack for DEVICE-computed bound metadata.  The host build computes
# centroids/radii in f64 and adds 1e-6; on device everything is f32 —
# the d² reduce over F=128..768 unit-scale elements carries ~1e-5
# relative error, so the conservative pad is 1e-4 (still 10x below the
# session's default 1e-3 certification margin; flag-rate cost is nil).
_DEV_META_SLACK = 1e-4


@functools.partial(jax.jit, static_argnames=("cap",))
def _group_device(xhat, lam, perm, rank, *, cap: int):
    """Grouped layout from the sorted permutation: `rank` maps each
    (unit, slot) to a rank in the sorted order, -1 for padding."""
    valid = rank >= 0
    ids = jnp.where(valid, perm[jnp.clip(rank, 0)], -1)
    take = jnp.clip(ids, 0)
    gx = jnp.where(valid[:, None], xhat[take], 0.0)
    glam = jnp.where(valid, lam[take], 0.0)
    return gx, glam, ids


@functools.partial(jax.jit, static_argnames=("cap",))
def _meta_block_device(gx_b, glam_b, ids_b, *, cap: int):
    """Per-unit bound metadata from a grouped block ((ub·cap, F) rows),
    all-f32 on device, with _DEV_META_SLACK keeping every bound
    conservative.  cosr is the smallest member dot x̂·ĉ, taken directly
    (an elementwise product and sum, exact f32 — no TF32) as the host
    build does: the identity cos = 1 − d²/2 holds only for unit
    members, and a zero-norm member (dot 0, d² = 1) would otherwise get
    cos 0.5 — a cap too narrow, and a certified wrong answer for a
    query anti-aligned with the centroid."""
    ub = gx_b.shape[0] // cap
    x = gx_b.reshape(ub, cap, -1)
    mask = (ids_b.reshape(ub, cap) >= 0)
    cnt = jnp.sum(mask, axis=1)
    fmask = mask.astype(x.dtype)[:, :, None]
    craw = jnp.sum(x * fmask, axis=1) / jnp.maximum(
        cnt[:, None], 1).astype(x.dtype)
    cnorm = jnp.sqrt(jnp.sum(craw * craw, axis=1))
    chat = jnp.where(cnorm[:, None] > 0, craw
                     / jnp.where(cnorm > 0, cnorm, 1.0)[:, None], 0.0)
    d2 = jnp.sum((x - chat[:, None, :]) ** 2, axis=2)    # (ub, cap)
    d2 = jnp.where(mask, d2, -jnp.inf)
    d2max = jnp.max(d2, axis=1)
    radius = jnp.sqrt(jnp.maximum(d2max, 0.0)) + _DEV_META_SLACK
    dots = jnp.sum(x * chat[:, None, :], axis=2)        # (ub, cap)
    dmin = jnp.min(jnp.where(mask, dots, jnp.inf), axis=1)
    cosr = jnp.clip(dmin, -1.0, 1.0) - _DEV_META_SLACK
    cosr = jnp.maximum(cosr, -1.0)
    # zero-norm centroid (cancelled rows): full-sphere cap — cosr −1
    # makes every query's c >= cosr, so the bound saturates at α·1
    cosr = jnp.where(cnorm > 0, cosr, -1.0)
    sinr = jnp.minimum(
        1.0, jnp.sqrt(jnp.maximum(0.0, 1.0 - cosr * cosr))
        + _DEV_META_SLACK)
    lam_g = glam_b.reshape(ub, cap)
    lam_lo = jnp.min(jnp.where(mask, lam_g, jnp.inf), axis=1)
    lam_hi = jnp.max(jnp.where(mask, lam_g, -jnp.inf), axis=1)
    empty = cnt == 0
    radius = jnp.where(empty, -2.0, radius)
    cosr = jnp.where(empty, 1.0, cosr)
    sinr = jnp.where(empty, 0.0, sinr)
    return chat, radius, cosr, sinr, lam_lo, lam_hi


def build_cells_device(data, lambdas, cap: int = 256, seed: int = 0,
                       iters: int = 8, dtype=None,
                       n_clusters: Optional[int] = None,
                       lloyd_sample: Optional[int] = None,
                       meta_chunk_units: int = 4096,
                       assume_normalised: bool = False) -> PrunedCells:
    """Fully device-resident build_cells — no corpus round trip through
    the host (build_cells stages the corpus as host f64, which at
    10M x 128 is a 10 GB host copy plus a multi-GB re-upload; this path
    touches the host only for O(C) cluster counts and O(U·cap) int32
    gather plans).  Pipeline, one device program per stage:

      1. unit-normalise via ops.search._safe_unit — the SAME op the
         full-scan oracle applies, so grouped rows are bitwise the
         oracle's normalised corpus (the host path's f64-normalise-
         then-cast can differ in the last ulp);
      2. Lloyd fit (optionally on a `lloyd_sample` row subsample) +
         one full assign pass;
      3. two-key device sort (cluster, λ) carrying the row permutation —
         λ-sorted unit splits, as the host build;
      4. host plans the unit layout from the C cluster counts alone,
         uploads a (U·cap) rank map, and the grouped gx/glam/ids come
         from one device gather;
      5. bound metadata in f32 on device, chunked over units (the
         (ub, cap, F) diff plane stays ~0.5 GB), with _DEV_META_SLACK
         replacing the host build's f64+1e-6 — conservative in the same
         direction, so certification stays sound.

    Reference anchor: core.rs:760-798 (the exactness contract served by
    the cells these bounds screen)."""
    import time as _time
    from .ops.search import _safe_unit

    t_start = _time.perf_counter()
    x = jnp.asarray(data)
    dt = dtype or x.dtype
    if x.dtype != dt:
        x = x.astype(dt)
    lam = jnp.asarray(lambdas, dtype=dt)
    n, f = x.shape
    cap = int(cap)
    assert cap > 0 and n > 0
    if assume_normalised:
        # caller guarantees unit rows (e.g. a corpus generated
        # normalised on device): skip the _safe_unit pass AND its
        # full-size HBM copy — at 10M x 128 that copy is 5 GB of the
        # peak footprint
        xhat = x
    else:
        xhat = jax.jit(_safe_unit)(x)
    del x

    n_cells = max(1, min(n, n_clusters if n_clusters is not None
                         else -(-n // cap)))
    rng = np.random.default_rng(seed)
    chunk = min(65536, max(1024, 1 << int(np.ceil(np.log2(max(2, n))))))
    if n_cells == 1:
        assign = jnp.zeros((n,), dtype=jnp.int32)
    else:
        seed_rows = np.sort(rng.choice(n, size=n_cells, replace=False))
        cent0 = xhat[jnp.asarray(seed_rows)]
        if lloyd_sample is not None and lloyd_sample < n:
            fit_idx = np.sort(rng.choice(n, size=int(lloyd_sample),
                                         replace=False))
            xfit = xhat[jnp.asarray(fit_idx)]
            cent, _ = _lloyd_device(xfit, cent0, n_cells=n_cells,
                                    chunk=min(chunk, int(lloyd_sample)),
                                    iters=iters)
            del xfit
            assign = _assign_chunked_jit(xhat, cent, chunk=chunk)
        else:
            cent, assign = _lloyd_device(xhat, cent0, n_cells=n_cells,
                                         chunk=chunk, iters=iters)
    t_lloyd = _time.perf_counter()

    # two-key sort: (cluster, λ) with the row id as payload
    iota = jnp.arange(n, dtype=jnp.int32)
    _, _, perm = jax.lax.sort((assign, lam, iota), num_keys=2)
    sorted_assign = jnp.take(assign, perm)
    cluster_iota = jnp.arange(n_cells, dtype=sorted_assign.dtype)
    starts, ends = jax.device_get(
        (jnp.searchsorted(sorted_assign, cluster_iota, side="left"),
         jnp.searchsorted(sorted_assign, cluster_iota, side="right")))
    del sorted_assign, assign
    t_sort = _time.perf_counter()

    # host: plan units from the C counts (no row data touches the host)
    counts = ends - starts
    n_units_per = -(-counts // cap)          # 0 for empty clusters
    u_real = int(n_units_per.sum())
    u_pad = _unit_pad(u_real)
    base_unit = np.concatenate(([0], np.cumsum(n_units_per)))[:-1]
    c_ids = np.repeat(np.arange(n_cells), n_units_per)
    within = np.arange(u_real) - base_unit[c_ids]
    rank_start = starts[c_ids] + within * cap
    rank_end = np.minimum(rank_start + cap, ends[c_ids])
    rank = np.full((u_pad, cap), -1, dtype=np.int32)
    rk = rank_start[:, None] + np.arange(cap)[None, :]
    rank[:u_real] = np.where(rk < rank_end[:, None], rk, -1)
    rank_dev = jnp.asarray(rank.reshape(-1))

    gx, glam, gids = _group_device(xhat, lam, perm, rank_dev, cap=cap)
    gx.block_until_ready()
    del xhat, lam, perm, rank_dev
    t_group = _time.perf_counter()

    # chunked metadata (the (ub, cap, F) diff plane is the working set)
    ub = max(1, min(meta_chunk_units, u_pad))
    while u_pad % ub:
        ub //= 2
    metas = []
    for lo in range(0, u_pad, ub):
        metas.append(_meta_block_device(
            gx[lo * cap:(lo + ub) * cap],
            glam[lo * cap:(lo + ub) * cap],
            gids[lo * cap:(lo + ub) * cap], cap=cap))
    cent_u, radius, cosr, sinr, lam_lo, lam_hi = (
        jnp.concatenate(parts) for parts in zip(*metas))
    cent_u.block_until_ready()
    logger.info(
        "pruned cells (device build): %d rows -> %d units (cap %d, %d "
        "clusters, padded to %d); lloyd %.1fs, sort %.1fs, group %.1fs, "
        "metadata %.1fs", n, u_real, cap, n_cells, u_pad,
        t_lloyd - t_start, t_sort - t_lloyd, t_group - t_sort,
        _time.perf_counter() - t_group)
    return PrunedCells(x=gx, lam=glam, ids=gids, cent=cent_u,
                       radius=radius, cosr=cosr, sinr=sinr,
                       lam_lo=lam_lo, lam_hi=lam_hi, cap=cap,
                       n_units=u_real)


@functools.partial(jax.jit,
                   static_argnames=("k", "m_cells", "cap", "margin",
                                    "return_next_bound"))
def pruned_topk(queries, query_lambdas, cells_x, cells_lam, cells_ids,
                cent, radius, cosr, sinr, lam_lo, lam_hi, alpha, *,
                k: int, m_cells: int, cap: int, margin: float,
                return_next_bound: bool = False):
    """Cell-screened exact top-k.  Returns (scores (B, k), ids (B, k),
    flags (B,) bool) — flags=True means exactness is NOT certified for
    that query (the (M+1)-th cell bound + margin reached its k-th score,
    or fewer than k real rows were gathered) and the caller must re-run
    it through the full scan.  Unflagged rows match the full-scan oracle:
    same ids (lowest-global-id tie order via the two-key sort), scores
    from the canonical shifted plane in the matmul rounding family.

    All shapes static: (B, U) bounds matmul, top-(M+1) cell select,
    (B·M, cap, F) unit-granularity block gather (contiguous cells), one
    (B, B·M·cap) scoring matmul via _block_diag_dot — queries as the
    LHS, the shape of the full-scan plane (duplicate candidate rows are
    RHS columns sharing the query's K-loop, so they stay bitwise-tied).
    Every dot at Precision.HIGHEST."""
    from .ops.search import _safe_unit

    b, f = queries.shape
    u = cent.shape[0]
    m = min(m_cells, u)
    dt = queries.dtype
    a = jnp.asarray(alpha, dt)
    c1 = 1.0 - a

    qhat = _safe_unit(queries)
    qa = qhat * a                                     # α·q̂ (B, F)
    # --- cell bounds on the shifted plane (spherical-cap sup) ---
    c = jnp.dot(qhat, cent.T, preferred_element_type=dt,
                precision=HIGHEST)                          # q̂·ĉ (B, U)
    s = jnp.sqrt(jnp.maximum(0.0, 1.0 - c * c))
    cap_sup = jnp.where(c >= cosr[None, :], 1.0,
                        c * cosr[None, :] + s * sinr[None, :])
    dmin = jnp.maximum(
        0.0, jnp.maximum(lam_lo[None, :] - query_lambdas[:, None],
                         query_lambdas[:, None] - lam_hi[None, :]))
    bounds = a * cap_sup - c1 * jnp.minimum(dmin, 1.0)
    # dummy bucket-padding units sort below every real unit's bound
    # (a real bound is >= -α - c1 >= -1)
    bounds = jnp.where(radius[None, :] < 0.0, -3.0, bounds)

    if m < u:
        bb, bi = jax.lax.top_k(bounds, m + 1)
        sel, next_bound = bi[:, :m], bb[:, m]
    else:
        bb, bi = jax.lax.top_k(bounds, m)
        sel = bi
        next_bound = jnp.full((b,), -jnp.inf, dtype=dt)

    # --- gather the selected units' rows, UNIT granularity ---
    # cells are contiguous cap-row blocks (the build's two-key sort), so
    # gather whole (cap, F) units instead of B·M·cap scattered rows: the
    # unit-granularity gather tells XLA each element is one contiguous
    # 128-KB slice (cap=256, F=128 f32).
    g = cells_x.reshape(-1, cap, f)[sel.reshape(-1)]  # (B·M, cap, F)
    glam = cells_lam.reshape(-1, cap)[sel.reshape(-1)].reshape(b, m * cap)
    gids = cells_ids.reshape(-1, cap)[sel.reshape(-1)].reshape(b, m * cap)

    # --- exact canonical-plane scores: queries on the LHS, candidates
    # flattened on the RHS, block diagonal extracted ---
    acos = _block_diag_dot(qa, g.reshape(b, m * cap, f), dt)  # (B, Mcap)
    dl = jnp.abs(query_lambdas[:, None] - glam)
    shifted = acos - c1 * jnp.minimum(dl, 1.0)
    neg_inf = jnp.asarray(-jnp.inf, dtype=dt)
    shifted = jnp.where(gids >= 0, shifted, neg_inf)

    # --- oracle tie order: (score desc, global id asc).  k <= 32 rides
    # the masked-extraction passes instead of a (B, m·cap) two-key sort;
    # rows with < k real candidates surface as non-finite kth and flag
    # either way ---
    top_s, top_i = _extract_topk_lowest_id(shifted, gids, k)

    if return_next_bound:
        # mesh callers certify against the GLOBAL k-th after their
        # merge (a shard-local k-th is too weak on shards that don't
        # hold the query's hot region — every cell bound would reach
        # it); the bound stays on the SHIFTED plane
        return top_s + c1, top_i, next_bound
    kth = top_s[:, k - 1]
    flags = (next_bound + jnp.asarray(margin, dt) >= kth) | ~jnp.isfinite(kth)
    return top_s + c1, top_i, flags


def _extract_topk_lowest_id(shifted, gids, k: int):
    """Exact (top-k scores, global ids) from a (B, W) shifted-score
    plane — ties resolve to the LOWEST global id, matching lax.top_k
    over the full corpus (global ids are corpus positions, so
    lowest-id == lowest-index).  `gids` is (W,) shared per-column (the
    union kernel) or (B, W) per-row (pruned_topk's per-query gathers).

    k <= 32 uses k masked max-extraction passes (~4 reduces over (B, W)
    each) instead of a two-key sort over wide rows.  Wider k falls back
    to the two-key sort."""
    b, w = shifted.shape
    neg_inf = jnp.asarray(-jnp.inf, dtype=shifted.dtype)
    gid2 = gids if gids.ndim == 2 else jnp.broadcast_to(gids[None, :],
                                                        (b, w))
    if k > 32:
        sneg, sid = jax.lax.sort((-shifted, gid2), num_keys=2,
                                 dimension=1)
        return -sneg[:, :k], sid[:, :k]
    int_max = jnp.iinfo(jnp.int32).max
    out_s, out_i = [], []
    cur = shifted
    for _ in range(k):
        mx = jnp.max(cur, axis=1)
        is_max = cur == mx[:, None]
        pick = jnp.min(jnp.where(is_max, gid2, int_max), axis=1)
        out_s.append(mx)
        out_i.append(pick)
        cur = jnp.where(gid2 == pick[:, None], neg_inf, cur)
    return jnp.stack(out_s, axis=1), \
        jnp.stack(out_i, axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=(
    "k", "m_vote", "s_cells", "cap", "margin"))
def pruned_topk_union(queries, query_lambdas, cells_x, cells_lam,
                      cells_ids, cent, radius, cosr, sinr, lam_lo,
                      lam_hi, alpha, *, k: int, m_vote: int,
                      s_cells: int, cap: int, margin: float):
    """Two-level cell-screened exact top-k for LARGE batches (the
    B ∈ (16, 512] band pruned_topk's per-query gather cannot serve —
    its matmul-family pad makes per-pair work grow past B = 16).

    Level 1: every query votes for its top-`m_vote` cells by the same
    spherical-cap bound pruned_topk screens with.  Level 2: the batch
    shares ONE union of `s_cells` cells (most-voted first, vote ties
    broken by the cell's best bound over the batch), gathered once and
    scored against ALL queries with a single (B, F)x(F, S·cap) matmul
    (Precision.HIGHEST) — no block diagonal, so per-pair cost is flat
    in B.

    Certification is per query and SOUND BY CONSTRUCTION against the
    union: flags[b] is clear iff the k-th exact score strictly beats
    (margin included) the best bound among cells OUTSIDE the union —
    including any cell the query voted for that lost the union cut, so
    budget overflow degrades to flags (exact fallback), never to wrong
    results.  Scoring extra union cells a query did not vote for only
    ADDS exact candidates.  Unflagged rows equal the full-scan oracle:
    same ids (lowest-global-id ties via _extract_topk_lowest_id), same
    matmul-family scores.

    Returns (scores (B, k), ids (B, k), flags (B,) bool)."""
    from .ops.search import _safe_unit

    b, f = queries.shape
    u = cent.shape[0]
    m = min(m_vote, u)
    s_c = min(s_cells, u)
    assert k <= s_c * cap, (k, s_c, cap)
    dt = queries.dtype
    a = jnp.asarray(alpha, dt)
    c1 = 1.0 - a
    neg_inf = jnp.asarray(-jnp.inf, dtype=dt)

    qhat = _safe_unit(queries)
    qa = qhat * a
    # --- level 1: cell bounds (identical plane to pruned_topk) ---
    c = jnp.dot(qhat, cent.T, preferred_element_type=dt,
                precision=HIGHEST)                          # (B, U)
    s = jnp.sqrt(jnp.maximum(0.0, 1.0 - c * c))
    cap_sup = jnp.where(c >= cosr[None, :], 1.0,
                        c * cosr[None, :] + s * sinr[None, :])
    dmin = jnp.maximum(
        0.0, jnp.maximum(lam_lo[None, :] - query_lambdas[:, None],
                         query_lambdas[:, None] - lam_hi[None, :]))
    bounds = a * cap_sup - c1 * jnp.minimum(dmin, 1.0)
    bounds = jnp.where(radius[None, :] < 0.0, -3.0, bounds)

    # m masked-argmax vote passes (tie order is immaterial: votes only
    # steer the union; certification never depends on them)
    iota_u = jnp.arange(u, dtype=jnp.int32)
    bcur = bounds
    voted = jnp.zeros((b, u), dtype=jnp.bool_)
    for _ in range(m):
        idx = jnp.argmax(bcur, axis=1)
        onehot = iota_u[None, :] == idx[:, None]
        voted = voted | onehot
        bcur = jnp.where(onehot, neg_inf, bcur)
    votes = jnp.sum(voted.astype(dt), axis=0)                # (U,)
    # votes stratify the key; a real bound is in [-1, 1] so (maxb+1)
    # in [0, 2] < 4 breaks vote ties without crossing strata
    key = votes * 4.0 + (jnp.max(bounds, axis=0) + 1.0)
    key = jnp.where(radius < 0.0, neg_inf, key)
    _, sel = jax.lax.top_k(key, s_c)                         # (S,)
    in_union = jnp.zeros((u,), jnp.bool_).at[sel].set(True)

    # best bound OUTSIDE the union, per query — the certification term
    next_bound = jnp.max(
        jnp.where(in_union[None, :], neg_inf, bounds), axis=1)

    # --- level 2: one shared gather + one batch matmul ---
    # unit-granularity gather (contiguous (cap, F) blocks — see
    # pruned_topk's gather comment)
    f_dim = cells_x.shape[1]
    gx = cells_x.reshape(-1, cap, f_dim)[sel].reshape(-1, f_dim)
    glam = cells_lam.reshape(-1, cap)[sel].reshape(-1)       # (S·cap,)
    gids = cells_ids.reshape(-1, cap)[sel].reshape(-1)

    acos = jax.lax.dot_general(
        qa, gx, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=dt, precision=HIGHEST)        # (B, S·cap)
    dl = jnp.abs(query_lambdas[:, None] - glam[None, :])
    shifted = acos - c1 * jnp.minimum(dl, 1.0)
    shifted = jnp.where(gids[None, :] >= 0, shifted, neg_inf)

    top_s, top_i = _extract_topk_lowest_id(shifted, gids, k)
    kth = top_s[:, k - 1]
    flags = (next_bound + jnp.asarray(margin, dt) >= kth) \
        | ~jnp.isfinite(kth)
    return top_s + c1, top_i, flags


def _block_diag_dot(qmat, rows3, dt):
    """Per-query candidate dots (R, C) from ONE 2-D (R, R·C) matmul with
    the queries as the LHS — the shape of the full-scan score plane, so
    duplicate candidate rows stay bitwise-tied as they do there — and
    the (i, i·C:(i+1)·C) block diagonal taken.  R x the minimum FLOPs,
    trivial at R <= 16.  Precision.HIGHEST."""
    r, c, f = rows3.shape
    all_ = jax.lax.dot_general(
        qmat, rows3.reshape(r * c, f),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=dt, precision=HIGHEST)   # (R, R*C)
    idx = jnp.arange(r)
    return all_.reshape(r, r, c)[idx, idx]              # (R, C)


@functools.partial(jax.jit, static_argnames=(
    "taumode", "alpha", "k", "m_vote", "s_cells", "cap", "margin",
    "has_proj", "pad_tall"))
def _pruned_union_step(q_raw, cells_x, cells_lam, cells_ids, cent,
                       radius, cosr, sinr, lam_lo, lam_hi, lap, proj, *,
                       taumode, alpha, k, m_vote, s_cells, cap, margin,
                       has_proj, pad_tall):
    """_pruned_step's large-batch sibling: fused query-λ prep + the
    two-level union screen.  Cell arrays are arguments (not closure
    captures), as in _pruned_step."""
    from .taumode import prepare_lambdas
    _, qlam = prepare_lambdas(q_raw, lap, proj, taumode, has_proj=has_proj,
                              pad_tall=pad_tall)
    s, i, fl = pruned_topk_union(
        q_raw, qlam, cells_x, cells_lam, cells_ids, cent, radius,
        cosr, sinr, lam_lo, lam_hi, alpha, k=k, m_vote=m_vote,
        s_cells=s_cells, cap=cap, margin=margin)
    return s, i, fl, qlam


@functools.partial(jax.jit, static_argnames=(
    "taumode", "alpha", "k", "m_cells", "cap", "margin", "has_proj",
    "pad_tall"))
def _pruned_step(q_raw, cells_x, cells_lam, cells_ids, cent, radius,
                 cosr, sinr, lam_lo, lam_hi, lap, proj, *, taumode,
                 alpha, k, m_cells, cap, margin, has_proj, pad_tall):
    """Module-level jitted serving step: fused query-λ prep + cell
    screening + exact candidate scoring.  The cell arrays are ARGUMENTS,
    not closure captures — a captured corpus would embed as HLO
    constants in the executable; statics carry the session config so same-config sessions share one
    executable."""
    from .taumode import prepare_lambdas
    _, qlam = prepare_lambdas(q_raw, lap, proj, taumode, has_proj=has_proj,
                              pad_tall=pad_tall)
    s, i, fl = pruned_topk(
        q_raw, qlam, cells_x, cells_lam, cells_ids, cent, radius,
        cosr, sinr, lam_lo, lam_hi, alpha, k=k, m_cells=m_cells,
        cap=cap, margin=margin)
    return s, i, fl, qlam


class PrunedSearchSession:
    """Small-batch exact serving with cell screening.

    Build once per index (the cell layout duplicates the corpus on
    device), then `search(queries)` any number of (≤batch_size)-row
    blocks: unflagged queries cost one centroid matmul + an M·cap-row
    gather+score instead of the full corpus stream; flagged queries
    (bounds couldn't certify exactness) transparently re-run through the
    oracle full scan with the SAME query λ the step computed, so every
    returned row is exactly what the full scan returns.

    Two regimes share this class (and the fallback/accounting logic):
    batch_size ≤ 16 runs pruned_topk (per-query top-M cell gather; the
    block-diagonal scoring matmul carries B x the minimum work, so
    per-pair work grows with B); batch_size in (16, 512] runs
    pruned_topk_union (the two-level screen: per-query cell VOTES, one
    shared union gather, one flat (B, F)x(F, S·cap) batch matmul).  Past
    512 the union's score plane + masked extraction (~k passes over a
    (B, S·cap) plane, with S·cap near the hot region's rows at
    certifying budgets) approaches a full scan; use SearchSession there.

    `auto_budget=True` adds the adaptive sizing policy: when the flag
    rate over the last `auto_window` served queries exceeds
    `auto_flag_target`, the screening budget doubles (union_cells in the
    union regime, m_cells at B ≤ 16) up to the point where gathered rows
    reach ~N/4 per batch — past that, screening approaches the full
    scan's own cost.
    Budgets only grow; results stay exact at every size (flags degrade
    to the oracle fallback, never to wrong answers), so the policy is a
    pure latency trade under distribution drift.
    """

    def __init__(self, index, batch_size: int = 16, k: int = 10,
                 alpha: float = 0.9, cap: int = 256,
                 m_cells: Optional[int] = None, margin: float = 1e-3,
                 seed: int = 0, iters: int = 8,
                 cells: Optional[PrunedCells] = None,
                 m_vote: int = 8, union_cells: Optional[int] = None,
                 auto_budget: bool = False,
                 auto_flag_target: float = 0.05,
                 auto_window: int = 256,
                 engine: str = "host",
                 n_clusters: Optional[int] = None,
                 lloyd_sample: Optional[int] = None):
        aspace, gl = index.aspace, index.gl
        if not (1 <= batch_size <= 512):
            raise ValueError("pruned sessions serve batch_size in "
                             "[1, 512]; use SearchSession for "
                             "larger batches")
        self.batch_size = int(batch_size)
        self.k = min(int(k), index.nitems)
        self.alpha = float(alpha)
        self.margin = float(margin)
        self._index = index
        dt = aspace.data.dtype
        self._dt = dt
        self._dim = aspace.nfeatures

        if cells is not None:
            self.cells = cells
        elif engine == "device":
            self.cells = build_cells_device(
                aspace.data, aspace.lambdas, cap=cap, seed=seed,
                iters=iters, dtype=dt, n_clusters=n_clusters,
                lloyd_sample=lloyd_sample)
        else:
            self.cells = build_cells(
                aspace.data, aspace.lambdas, cap=cap, seed=seed,
                iters=iters, dtype=dt, n_clusters=n_clusters,
                lloyd_sample=lloyd_sample)
        u = self.cells.cent.shape[0]
        if m_cells is None:
            # ~8192 gathered candidates per query (the unit-granularity
            # gather keeps that cheap).  Floor k cells so k real rows
            # are certain.
            m_cells = max(self.k, min(u, -(-8192 // self.cells.cap)))
        self.m_cells = min(int(m_cells), u)

        self._lap = jnp.asarray(gl.matrix, dtype=dt)
        proj = None
        if aspace.projection_matrix is not None:
            proj = aspace.projection_matrix.matrix(dtype=dt)
        self._has_proj = proj is not None
        self._proj = proj if self._has_proj \
            else jnp.zeros((1, 1), dtype=dt)
        self._taumode = aspace.taumode
        self._pad_tall = aspace.pad_tall_graphs
        c = self.cells
        if union_cells is None:
            # cover ~32k candidate rows by default — a few clusters'
            # worth per query-cluster, flat in B
            union_cells = max(self.m_cells, -(-32768 // c.cap))
        self.union_cells = min(int(union_cells), u)
        self.m_vote = min(int(m_vote), u)
        # ---- adaptive budget policy (grow-on-flags) -------------------
        # When auto_budget is on, the session widens its screening budget
        # (union_cells past B=16, m_cells at B<=16) whenever the flag
        # rate over the last `auto_window` queries exceeds
        # `auto_flag_target` — each flagged BATCH pays a full-scan
        # fallback (~N rows), so budget that removes flags pays for
        # itself until the gathered rows approach the corpus stream.
        # That bound is the growth cap: total gathered rows per batch
        # stay under N/4 (union: S·cap; per-query: B·m·cap), beyond
        # which screening approaches the full scan's own cost.  Budgets
        # only grow (the
        # query distribution shrinking back costs nothing extra —
        # unneeded union cells just add certified candidates) and each
        # growth step doubles, so at most ~log2(N/cap) recompiles.
        self.auto_budget = bool(auto_budget)
        self.auto_flag_target = float(auto_flag_target)
        self.auto_window = int(auto_window)
        self.budget_growths = 0
        self._win: list = []          # (queries, flags) per batch
        n_items = index.nitems
        if batch_size <= 16:
            self._budget_max = min(
                u, max(self.k, n_items // (4 * c.cap * self.batch_size)))
        else:
            self._budget_max = min(u, max(1, n_items // (4 * c.cap)))
        self._make_step()
        self.flagged_total = 0
        self.queries_total = 0

    def _make_step(self) -> None:
        """(Re)bind the jitted step to the CURRENT budgets.  Called once
        at init and again after each auto-budget growth; the underlying
        module-level jits are cached per (shape, static-config) so only
        genuinely new budgets compile."""
        c = self.cells
        lap, proj = self._lap, self._proj
        if self.batch_size <= 16:
            self._step = lambda q_raw: _pruned_step(
                q_raw, c.x, c.lam, c.ids, c.cent, c.radius, c.cosr,
                c.sinr, c.lam_lo, c.lam_hi, lap, proj,
                taumode=self._taumode, alpha=self.alpha, k=self.k,
                m_cells=self.m_cells, cap=c.cap, margin=self.margin,
                has_proj=self._has_proj, pad_tall=self._pad_tall)
        else:
            self._step = lambda q_raw: _pruned_union_step(
                q_raw, c.x, c.lam, c.ids, c.cent, c.radius, c.cosr,
                c.sinr, c.lam_lo, c.lam_hi, lap, proj,
                taumode=self._taumode, alpha=self.alpha, k=self.k,
                m_vote=self.m_vote, s_cells=self.union_cells, cap=c.cap,
                margin=self.margin, has_proj=self._has_proj,
                pad_tall=self._pad_tall)

    def _auto_budget_update(self, b: int, n_flagged: int) -> None:
        """Grow the screening budget when the recent flag rate exceeds
        the target.  The window resets on growth so one spread burst is
        judged once, not re-counted against the new budget."""
        self._win.append((b, n_flagged))
        wq = sum(q for q, _ in self._win)
        while wq - self._win[0][0] >= self.auto_window:
            wq -= self._win.pop(0)[0]
        wf = sum(f for _, f in self._win)
        if wq == 0 or wf / wq <= self.auto_flag_target:
            return
        cur = self.union_cells if self.batch_size > 16 else self.m_cells
        if cur >= self._budget_max:
            return
        new = min(self._budget_max, max(cur + 1, 2 * cur))
        if self.batch_size > 16:
            self.union_cells = new
        else:
            self.m_cells = new
        self.budget_growths += 1
        self._win.clear()
        logger.info(
            "pruned auto-budget: flag rate %.2f over last %d queries > "
            "target %.2f; %s %d -> %d (max %d)", wf / wq, wq,
            self.auto_flag_target,
            "union_cells" if self.batch_size > 16 else "m_cells",
            cur, new, self._budget_max)
        self._make_step()

    def warmup(self) -> None:
        """Compile the step and the fallback programs (serving becomes
        dispatch-only).  The synthetic warmup batch does not feed the
        auto-budget window — an all-ones batch says nothing about the
        serving distribution."""
        q = np.ones((self.batch_size, self._dim))
        auto, self.auto_budget = self.auto_budget, False
        try:
            self.search(q)
        finally:
            self.auto_budget = auto

    def _fallback(self, q_block: np.ndarray, qlam: np.ndarray):
        """Oracle full scan for flagged rows, with the step's own qlam
        (no host re-prep — identical operands, identical result).  The
        row count is padded to the session batch size so ONE compiled
        program serves every flagged count."""
        from .ops.search import batched_lambda_aware_topk
        aspace = self._index.aspace
        m = q_block.shape[0]
        pad = self.batch_size - m
        if pad:
            q_block = np.pad(q_block, ((0, pad), (0, 0)),
                             constant_values=1.0)
            qlam = np.pad(qlam, (0, pad))
        s, i = batched_lambda_aware_topk(
            jnp.asarray(q_block, dtype=self._dt),
            jnp.asarray(qlam, dtype=self._dt),
            aspace.data, aspace.lambdas,
            jnp.asarray(self.alpha, dtype=self._dt), k=self.k)
        return np.asarray(s)[:m], np.asarray(i)[:m]

    def search(self, queries) -> Tuple[np.ndarray, np.ndarray]:
        """(B ≤ batch_size, F) -> (scores (B, k), ids (B, k)).  Exact:
        certified-by-bound rows come from the pruned scan, the rest from
        the full scan."""
        q = np.atleast_2d(np.asarray(queries, dtype=np.dtype(self._dt)))
        b = q.shape[0]
        if b > self.batch_size:
            raise ValueError(
                f"pruned session batch is {self.batch_size}; got {b} "
                "(loop on the host or use SearchSession)")
        if q.shape[1] != self._dim:
            raise ValueError(f"query dim {q.shape[1]} != {self._dim}")
        pad = self.batch_size - b
        if pad:
            # Pad by CYCLIC REPLICATION of the real queries, not constant
            # rows: pad rows fully participate in the union kernel's cell
            # VOTING, and a block of identical synthetic rows would put
            # its m_vote cells in the top vote stratum, displacing real
            # queries' cells from a tight union budget (flags, not wrong
            # results — but the latency win is lost).  Replication
            # multiplies every real cell's vote count ~uniformly, so the
            # vote ORDER the union gathers by is preserved.
            q = np.resize(q, (self.batch_size, q.shape[1]))
        s, i, fl, qlam = self._step(jnp.asarray(q))
        s, i, fl = jax.device_get((s, i, fl))
        s, i, fl = s[:b], i[:b], fl[:b]
        self.queries_total += b
        if fl.any():
            rows = np.nonzero(fl)[0]
            self.flagged_total += len(rows)
            qlam_h = np.asarray(qlam)
            rs, ri = self._fallback(q[rows], qlam_h[rows])
            s = s.copy()
            i = i.copy()
            s[rows] = rs
            i[rows] = ri
        if self.auto_budget:
            self._auto_budget_update(b, int(fl.sum()))
        return s, i

    @property
    def flag_rate(self) -> float:
        return (self.flagged_total / self.queries_total
                if self.queries_total else 0.0)
