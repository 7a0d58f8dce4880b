"""Incremental clustering with optimal-K heuristics.

Port of the reference's clustering module (reference: clustering.rs:30-928).

Host/device split (deliberate): optimal-K runs on ≤1000 sampled rows and the
incremental pass is order-dependent when seeded, so both stay host-side in
vectorised NumPy (with an optional C++ native fast path, see native/).  The
downstream Laplacian + λτ stages consume the resulting X×F centroid matrix
on device.

Key semantics preserved:
- fixed default seed 128 (clustering.rs:30);
- Two-NN intrinsic-dimension estimate on a ≤500 sample (clustering.rs:101-164);
- k bounds: k_min = max(ceil(sqrt(N/10)), 2),
  k_max = min(F, N/10, 5·ID, sqrt(N)) then max(k_min+1) and min(N/2)
  (clustering.rs:75-98);
- Calinski–Harabasz sweep with penalty 0.8·k·ln N, 3 seeded trials per k,
  coarse step then fine-tune, ties prefer larger k (clustering.rs:167-310);
- radius = 1.5 × p90 of within-cluster d², with inter-centroid fallback
  (clustering.rs:384-492);
- incremental pass: new centroid iff d² > radius·0.5 and under cap; running
  mean assignment iff d² <= radius; soft-outlier at relaxed radius ×1.5 after
  saturation; drop otherwise (clustering.rs:547-910);
- runtime assert: sampling ratio in (0.325, 0.89) outside test mode
  (clustering.rs:896-900).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

import numpy as np

from .config import HIGHEST, is_test_mode
from .utils.log import get_logger

logger = get_logger("arrowspace.clustering")

CLUSTERING_SEED = 128  # clustering.rs:30

__all__ = [
    "CLUSTERING_SEED", "Assignments", "compute_optimal_k",
    "estimate_intrinsic_dimension", "calinski_harabasz_score",
    "compute_threshold_from_pilot", "kmeans_lloyd", "euclidean_dist",
    "run_incremental_clustering_with_sampling", "nearest_centroid",
]


class Assignments:
    """Per-row cluster ids with ``None`` for dropped rows — the
    reference's ``Vec<Option<usize>>`` (clustering.rs:547) — backed by a
    dense int64 array with a -1 sentinel.  Materialising a 1M-element
    Python list (and converting it back to an array downstream) measured
    ~0.3 s per build; this keeps list semantics (len / index / iterate /
    ``a is None`` checks) lazy over the array, and bulk consumers read
    ``.array`` directly."""

    __slots__ = ("array",)

    def __init__(self, array):
        self.array = np.asarray(array, dtype=np.int64)

    def __len__(self) -> int:
        return self.array.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Assignments(self.array[i])
        v = int(self.array[i])
        return None if v < 0 else v

    def __iter__(self):
        for v in self.array:
            yield None if v < 0 else int(v)

    def __array__(self, dtype=None, copy=None):
        a = self.array
        if dtype is not None:
            a = a.astype(dtype, copy=False)
        return a.copy() if copy else a

    def __eq__(self, other):
        if isinstance(other, Assignments):
            return np.array_equal(self.array, other.array)
        if isinstance(other, np.ndarray):
            # compare sentinel arrays directly — without this branch
            # ndarray.__eq__ would array-ify self via __array__ and
            # return an elementwise mask instead of Option semantics
            return np.array_equal(self.array, other)
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        return NotImplemented

    # mutable container semantics: defining __eq__ sets the implicit
    # __hash__ to None; keep that explicit — instances are views over a
    # mutable array and must not land in hash-keyed collections
    __hash__ = None

    def __repr__(self) -> str:
        return f"Assignments({self.array!r})"


def euclidean_dist(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.sum((a - b) ** 2)))


def nearest_centroid(row, centroids) -> Tuple[int, float]:
    """Linear-scan nearest centroid: (index, squared distance)
    (clustering.rs:913-928)."""
    c = np.asarray(centroids, dtype=np.float64)
    d2 = np.sum((c - np.asarray(row, dtype=np.float64)[None, :]) ** 2, axis=1)
    idx = int(np.argmin(d2))
    return idx, float(d2[idx])


# ---------------------------------------------------------------------------
# K-means (pilot clustering for the heuristics)
# ---------------------------------------------------------------------------

def kmeans_lloyd(rows, k: int, max_iter: int, seed: int) -> np.ndarray:
    """Seeded Lloyd's k-means returning 0-indexed assignments
    (reference: clustering.rs:505-531, via smartcore KMeans).

    Init picks k distinct rows uniformly at random (seeded); empty clusters
    keep their previous centroid.  Semantic parity with the reference's
    seeded smartcore run (bit-parity is not possible across RNGs).
    """
    x = np.asarray(rows, dtype=np.float64)
    if x.size == 0:
        return np.zeros((0,), dtype=np.int64)
    n = x.shape[0]
    k = min(k, n)
    if k == 0:
        # k=0 returns empty assignments (reference:
        # tests/test_clustering.rs:630-633)
        return np.zeros((0,), dtype=np.int64)
    rng = np.random.default_rng(np.uint64(seed))
    init_idx = rng.choice(n, size=k, replace=False)
    centroids = x[init_idx].copy()

    assignments = np.zeros(n, dtype=np.int64)
    sq = np.sum(x * x, axis=1)
    for it in range(max_iter):
        # squared distances (n, k)
        d2 = (sq[:, None] - 2.0 * x @ centroids.T
              + np.sum(centroids * centroids, axis=1)[None, :])
        new_assignments = np.argmin(d2, axis=1)
        if it > 0 and np.array_equal(new_assignments, assignments):
            break
        assignments = new_assignments
        # vectorised centroid update; empty clusters keep their centroid
        counts = np.bincount(assignments, minlength=k)
        sums = np.zeros((k, x.shape[1]))
        np.add.at(sums, assignments, x)
        nonempty = counts > 0
        centroids[nonempty] = sums[nonempty] / counts[nonempty, None]
    return assignments


def calinski_harabasz_score(rows, assignments, k: int) -> float:
    """CH index (reference: clustering.rs:313-381)."""
    x = np.asarray(rows, dtype=np.float64)
    a = np.asarray(assignments)
    n = x.shape[0]
    if k <= 1 or k >= n:
        return 0.0
    global_centroid = x.mean(axis=0)

    valid = a < k
    av = a[valid]
    xv = x[valid]
    counts = np.bincount(av, minlength=k)
    sums = np.zeros((k, x.shape[1]))
    np.add.at(sums, av, xv)
    nonempty = counts > 0
    centroids = np.zeros((k, x.shape[1]))
    centroids[nonempty] = sums[nonempty] / counts[nonempty, None]

    bgss = float(np.sum(
        counts[nonempty, None] * (centroids[nonempty] - global_centroid) ** 2))
    wgss = float(np.sum((xv - centroids[av]) ** 2))
    if wgss < 1e-10:
        return 0.0
    return (bgss / (k - 1)) / (wgss / (n - k))


def _twonn_tile_jit():
    """Module-level jitted Two-NN distance tile (lazy so importing this
    module never initialises JAX).  Hoisted out of the per-call scope so
    (a) repeat builds in one process reuse one trace and (b) the AOT
    precompile (precompile.py) can lower it by shape alone.

    The corpus axis is processed as a lax.scan over fixed windows with a
    running two-smallest kept by pure min-reduces: the previous one-shot
    formulation materialised a (chunk, N) distance plane (10 GB at 10M
    rows) and ran lax.top_k over N-wide rows, a sort-based lowering that
    dominated a 10M build; the windowed min-reduces avoid both."""
    global _TWONN_TILE
    if _TWONN_TILE is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def tile(corpus, sel):
            n, f = corpus.shape
            win = min(TWONN_CORPUS_WIN, n)
            n_win = (n + win - 1) // win
            rows_s = jnp.take(corpus, sel, axis=0)
            rs_sq = jnp.sum(rows_s * rows_s, axis=1)[:, None]
            col = jax.lax.broadcasted_iota(jnp.int32,
                                           (sel.shape[0], win), 1)
            inf = jnp.asarray(jnp.inf, corpus.dtype)

            def body(carry, i):
                m1, m2 = carry
                w0 = i * win
                xw = jax.lax.dynamic_slice(
                    corpus, (w0, jnp.zeros((), w0.dtype)), (win, f))
                # dynamic_slice clamps a tail start to n - win; mask to
                # rows >= the UNCLAMPED start so overlap rows count once
                w0c = jnp.minimum(w0, n - win)
                gidx = col + w0c
                d2 = (rs_sq
                      - 2.0 * jnp.dot(rows_s, xw.T,
                                      preferred_element_type=corpus.dtype,
                                      precision=HIGHEST)
                      + jnp.sum(xw * xw, axis=1)[None, :])
                valid = (gidx >= w0) & \
                    (gidx != sel[:, None].astype(jnp.int32))
                d2 = jnp.where(valid, jnp.maximum(d2, 0.0), inf)
                w1 = jnp.min(d2, axis=1)
                am = jnp.argmin(d2, axis=1)
                w2 = jnp.min(jnp.where(col == am[:, None], inf, d2),
                             axis=1)
                m2n = jnp.minimum(jnp.minimum(m2, w2),
                                  jnp.maximum(m1, w1))
                m1n = jnp.minimum(m1, w1)
                return (m1n, m2n), ()

            init = (jnp.full((sel.shape[0],), jnp.inf, corpus.dtype),
                    jnp.full((sel.shape[0],), jnp.inf, corpus.dtype))
            (m1, m2), _ = jax.lax.scan(
                body, init, jnp.arange(n_win, dtype=jnp.int32))
            return jnp.stack([m1, m2], axis=1)

        _TWONN_TILE = tile
    return _TWONN_TILE


_TWONN_TILE = None
TWONN_CHUNK = 256

# corpus-axis window of the Two-NN scan: bounds the transient distance
# plane at (TWONN_CHUNK x win) f32 (~1 GB) regardless of N
TWONN_CORPUS_WIN = 1 << 20


def _twonn_two_smallest_device(device_data, indices) -> np.ndarray:
    """Two smallest squared distances per sample row, computed on device:
    one (chunk x N) distance tile per matmul + top_k, reusing
    the corpus the build already uploaded.  Returns (len(indices), 2) f64."""
    import jax.numpy as jnp

    tile = _twonn_tile_jit()
    # pad the sample count to a multiple of the chunk (repeating index 0)
    # so every corpus compiles ONE tile shape, not one per tail size;
    # duplicate rows are dropped from the output
    n_sel = len(indices)
    chunk = TWONN_CHUNK
    pad = (-n_sel) % chunk
    padded = np.concatenate([indices, np.full(pad, indices[0])]) \
        if pad else indices
    out = []
    for s0 in range(0, len(padded), chunk):
        sel = jnp.asarray(padded[s0:s0 + chunk].astype(np.int32))
        out.append(np.asarray(tile(device_data, sel), dtype=np.float64))
    return np.concatenate(out, axis=0)[:n_sel]


def estimate_intrinsic_dimension(rows, n: int, f: int, base_seed: int,
                                 device_data=None) -> int:
    """Two-NN ratio estimator (reference: clustering.rs:101-164)."""
    if n < 10:
        return min(f, 2)
    sample_size = min(n, 500)
    rng = np.random.default_rng(np.uint64((base_seed + 1) % 2 ** 64))
    indices = rng.permutation(n)[:sample_size]

    if device_data is not None and n * f >= DEVICE_CLUSTERING_MIN_ELEMS:
        # Large corpora: distance tiles on the accelerator (the corpus is
        # already resident for the downstream build stages).
        part = _twonn_two_smallest_device(device_data, indices)
        two = np.sqrt(np.maximum(part, 0.0))
        ok = two[:, 0] > 1e-12
        ratios = (two[ok, 1] / two[ok, 0]).tolist()
    else:
        # blocked: one (chunk, N) distance tile per matmul instead of a
        # matvec per sample row.  f32 is ample for a nearest-neighbour
        # RATIO estimate and halves the BLAS + partition cost.  (The
        # conversion stays inside this branch: a full-corpus np.asarray
        # is a 10 GB host copy at 10M x 128 the device path never needs.)
        x32 = np.asarray(rows, dtype=np.float32)
        sq = np.sum(x32 * x32, axis=1)
        ratios = []
        chunk = 256
        for s0 in range(0, len(indices), chunk):
            sel = indices[s0:s0 + chunk]
            d2 = sq[sel][:, None] - 2.0 * (x32[sel] @ x32.T) + sq[None, :]
            d2[np.arange(len(sel)), sel] = np.inf
            d2 = np.maximum(d2, 0.0)
            part = np.partition(d2, 1, axis=1)[:, :2]
            two = np.sqrt(np.sort(part, axis=1).astype(np.float64))
            ok = two[:, 0] > 1e-12
            ratios.extend((two[ok, 1] / two[ok, 0]).tolist())
    if not ratios:
        return min(f, 3)
    mean_ratio = float(np.mean(ratios))
    ident = 1.0 / math.log(mean_ratio) if mean_ratio > 1.001 else float(f)
    id_clamped = int(np.clip(round(ident), 1, f))
    logger.debug("Two-NN mean ratio: %.4f, estimated ID: %d",
                 mean_ratio, id_clamped)
    return id_clamped


def _step1_bounds(rows, n: int, f: int, base_seed: int, device_data=None):
    """(k_min, k_max, id) (reference: clustering.rs:75-98)."""
    id_est = estimate_intrinsic_dimension(rows, n, f, base_seed,
                                          device_data=device_data)
    k_min = max(math.ceil(math.sqrt(n / 10.0)), 2)
    k_max_candidates = [f, n // 10, 5 * id_est, int(n ** 0.5)]
    k_max = max(min(k_max_candidates), k_min + 1)
    k_max = min(k_max, n // 2)
    return k_min, k_max, id_est


def _best_ch_for_k(rows, k: int, base_seed: int, mult: int) -> float:
    best = 0.0
    for trial in range(3):
        trial_seed = (base_seed + k * mult + trial) % 2 ** 64
        assignments = kmeans_lloyd(rows, k, 20, trial_seed)
        best = max(best, calinski_harabasz_score(rows, assignments, k))
    return best


def _step2_calinski_harabasz(rows, k_min: int, k_max: int,
                             base_seed: int) -> int:
    """CH sweep with penalty and fine-tune (reference: clustering.rs:167-310)."""
    n = len(rows)
    if n < 10:
        return k_min
    k_range = k_max - k_min
    k_step = 1 if k_range <= 5 else (2 if k_range <= 15 else 3)
    k_candidates = list(range(k_min, k_max + 1, k_step))
    penalty = 0.8

    def penalized(k, mult):
        score = _best_ch_for_k(rows, k, base_seed, mult)
        return score - penalty * k * math.log(n)

    k_scores = [(k, penalized(k, 1000)) for k in k_candidates
                if 2 <= k < n]
    if not k_scores:
        return k_min
    # max by score; ties prefer larger k (clustering.rs:229-241)
    best_k, best_score = max(k_scores, key=lambda t: (t[1], t[0]))

    if k_step > 1:
        fine_range = [best_k - (k_step - 1), best_k - 1, best_k,
                      min(best_k + 1, k_max), min(best_k + k_step - 1, k_max)]
        fine_range = sorted({k for k in fine_range
                             if k_min <= k <= k_max and k < n
                             and k not in k_candidates})
        fine_scores = [(k, penalized(k, 10000)) for k in fine_range]
        if fine_scores:
            fine_k, fine_score = max(fine_scores, key=lambda t: (t[1], t[0]))
            if fine_score > best_score:
                best_k, best_score = fine_k, fine_score

    logger.debug("Best K=%d with penalized score=%.4f", best_k, best_score)
    return best_k if best_k < k_max else k_max


def compute_threshold_from_pilot(rows, k: int, base_seed: int) -> float:
    """radius = 1.5·p90(within-cluster d²), with inter-centroid fallback
    (reference: clustering.rs:384-492)."""
    x = np.asarray(rows, dtype=np.float64)
    assignments = kmeans_lloyd(rows, k, 20, (base_seed + 100000) % 2 ** 64)

    counts = np.bincount(assignments, minlength=k)
    centroids = np.zeros((k, x.shape[1]))
    np.add.at(centroids, assignments, x)
    nonempty = counts > 0
    centroids[nonempty] /= counts[nonempty, None]

    valid = assignments < k
    dists = np.sum((x[valid] - centroids[assignments[valid]]) ** 2, axis=1)
    if dists.size == 0:
        logger.warning("No distances computed; using default radius 1.0")
        return 1.0

    dists_sorted = np.sort(dists)
    p90_idx = min(int(math.ceil(dists_sorted.size * 0.9)),
                  dists_sorted.size - 1)
    percentile_90 = float(dists_sorted[p90_idx])

    ne_idx = np.nonzero(nonempty)[0]
    if ne_idx.size >= 2:
        cne = centroids[ne_idx]
        csq = np.sum(cne * cne, axis=1)
        inter_m = csq[:, None] - 2.0 * cne @ cne.T + csq[None, :]
        iu = np.triu_indices(ne_idx.size, 1)
        inter_vals = np.maximum(inter_m[iu], 0.0)
        min_inter = float(inter_vals.min())
        has_inter = True
    else:
        min_inter = float("inf")
        has_inter = False

    ratio = percentile_90 / min_inter \
        if (math.isfinite(min_inter) and min_inter > 0.0) else 1.0

    if percentile_90 < 1e-8 or ratio < 0.01:
        if has_inter:
            return max(min_inter * 0.15, 1e-6)
        return 1e-6
    return max(percentile_90 * 1.5, 1e-6)


def compute_optimal_k(rows, n: int, f: int,
                      seed_override: Optional[int] = None,
                      device_data=None) -> Tuple[int, float, int]:
    """(K, radius, intrinsic_dim) (reference: clustering.rs:36-72).

    device_data: optional device-resident copy of `rows` (the build keeps
    one anyway); large corpora then run the Two-NN distance tiles on it.
    """
    logger.info("Computing optimal K for clustering: N=%d, F=%d", n, f)
    base_seed = seed_override if seed_override is not None else CLUSTERING_SEED

    k_min, k_max, id_est = _step1_bounds(rows, n, f, base_seed,
                                         device_data=device_data)

    sample_size = min(n, 1000)
    if n > sample_size:
        rng = np.random.default_rng(np.uint64(base_seed))
        idxs = rng.permutation(n)[:sample_size]
        sampled = [rows[i] for i in idxs]
    else:
        sampled = list(rows)

    k_optimal = _step2_calinski_harabasz(sampled, k_min, k_max, base_seed)
    radius = compute_threshold_from_pilot(sampled, k_optimal, base_seed)
    return k_optimal, radius, id_est


# ---------------------------------------------------------------------------
# Incremental clustering
# ---------------------------------------------------------------------------

def run_incremental_clustering_with_sampling(
    builder,
    rows,
    nfeatures: int,
    max_clusters: int,
    radius: float,
    sampler,
    device_data=None,
) -> Tuple[np.ndarray, List[Optional[int]], List[int]]:
    """One-pass incremental clustering (reference: clustering.rs:547-910).

    Sequential scan preserving the reference's deterministic-mode contract
    (clustering.rs:842-846): in sequential execution the snapshot IS the
    current state, so snapshot-based decisions and under-lock updates
    coincide.  The unseeded rayon mode of the reference is a nondeterministic
    relaxation of this order; we keep the ordered scan for both (the native
    C++ path accelerates it).

    device_data: optional device-resident copy of `rows`; the unseeded
    chunked mode then runs its snapshot-distance tiles on the accelerator.

    Returns (centroids X×F, assignments with None for dropped rows, sizes).
    """
    if not builder.deterministic_clustering and len(rows) >= 4096:
        # Unseeded mode: the reference runs the same per-row rules under a
        # rayon race (decisions on stale snapshots, clustering.rs:570-660).
        # The chunked formulation below IS that relaxation, vectorised:
        # every row in a chunk decides against the chunk-start snapshot.
        return _incremental_clustering_chunked(
            builder, rows, nfeatures, max_clusters, radius, sampler,
            device_data=device_data)
    try:
        from .native import native_incremental_clustering
    except Exception:  # pragma: no cover
        native_incremental_clustering = None
    if native_incremental_clustering is not None:
        out = native_incremental_clustering(
            builder, rows, nfeatures, max_clusters, radius, sampler)
        if out is not None:
            return out
    return _incremental_clustering_numpy(
        builder, rows, nfeatures, max_clusters, radius, sampler)


def _chunk_dist_jit():
    """Module-level jitted snapshot-distance program (lazy; shared by all
    _DeviceChunkDistances instances and AOT-lowerable by precompile.py).
    The chunk length is static; start/n_c are runtime scalars."""
    global _CHUNK_DIST
    if _CHUNK_DIST is None:
        import functools
        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit, static_argnames=("chunk",))
        def _dist(corpus, start, cent_pad, n_c, *, chunk):
            f = corpus.shape[1]
            rows_c = jax.lax.dynamic_slice(
                corpus, (start, jnp.zeros((), start.dtype)), (chunk, f))
            d2 = (jnp.sum(rows_c * rows_c, axis=1)[:, None]
                  - 2.0 * jnp.dot(rows_c, cent_pad.T,
                                  preferred_element_type=corpus.dtype,
                                  precision=HIGHEST)
                  + jnp.sum(cent_pad * cent_pad, axis=1)[None, :])
            d2 = jnp.maximum(d2, 0.0)
            valid = jnp.arange(cent_pad.shape[0]) < n_c
            d2 = jnp.where(valid[None, :], d2, jnp.inf)
            best = jnp.argmin(d2, axis=1)
            bd = jnp.take_along_axis(d2, best[:, None], axis=1)[:, 0]
            return best.astype(jnp.int32), bd

        _CHUNK_DIST = _dist
    return _CHUNK_DIST


_CHUNK_DIST = None


def _chunk_segsum_jit():
    """Module-level jitted grouped-sum program for the running-mean
    updates: per-centroid sums and counts of a chunk window's rows,
    keyed by host-decided targets (-1 = not assigned).  Replaces the
    host's np.add.at over the fetched (chunk x F) rows — the largest
    remaining host cost of the chunked scan (~100 ms per 131k-row
    chunk) — with one small dispatch against the resident corpus."""
    global _CHUNK_SEGSUM
    if _CHUNK_SEGSUM is None:
        import functools
        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit, static_argnames=("chunk", "cap"))
        def _segsum(corpus, start, tgt, *, chunk, cap):
            f = corpus.shape[1]
            rows_c = jax.lax.dynamic_slice(
                corpus, (start, jnp.zeros((), start.dtype)), (chunk, f))
            valid = tgt >= 0
            t = jnp.where(valid, tgt, cap)   # park non-assigned in slot cap
            # accumulate in the corpus dtype: f64 on the CPU/x64 oracle
            # backend (exact parity with np.add.at), f32 on the GPU (~1e-7
            # relative on unit-scale means — inside the chunked mode's
            # documented f32 relaxation)
            sums = jnp.zeros((cap + 1, f), dtype=corpus.dtype)
            sums = sums.at[t].add(jnp.where(valid[:, None], rows_c, 0.0))
            counts = jnp.zeros((cap + 1,), dtype=jnp.int32).at[t].add(
                valid.astype(jnp.int32))
            return sums[:cap], counts[:cap]

        _CHUNK_SEGSUM = _segsum
    return _CHUNK_SEGSUM


_CHUNK_SEGSUM = None


def _chunk_decide_tail_jit():
    """Module-level jitted AT-CAP TAIL program: once n_c == max_clusters
    no row can create a centroid, so every remaining chunk's rule set
    (snapshot distances, sampling keep, the create→soft re-route,
    assign/soft routing, grouped running-mean sums, soft counts, and the
    running-mean centroid update itself) collapses into ONE device
    dispatch — a lax.scan over all remaining chunk windows carrying
    (centroids, counts).  The host uploads the sampler draws for the
    whole tail once and fetches (final centroids, final counts, the full
    tail assignment matrix, kept-row count) once: the per-chunk
    round-trip cadence of the former one-chunk decide program (~2 round
    trips x ~39 chunks at 10M rows) becomes 2 transfers total.

    n_steps is ceil(n/chunk) — purely shape-derived, so one compiled
    program serves the scan no matter where the cap was hit: steps whose
    window starts past the corpus end are inert (their in-window mask is
    empty), and the scan always starts at the first at-cap chunk
    boundary c0_tail.

    Rule parity with _apply_chunk_decisions at cap (host reference):
    want_create rows (bd > radius/2) fall through the creation loop
    untouched (no creations happen) and take the soft test on their
    UNCHANGED best distance — so routing reduces to
        assign iff keep and not create and bd <= radius
        soft   iff keep and not assign and bd <= 1.5*radius
    and the centroid update is the grouped running mean
        cent' = (cent*counts + sums) / (counts + adds)  where adds > 0
    exactly as the host applies it.  On the CPU/f64 test backend all
    arithmetic matches the host rules to scatter-order rounding (the
    parity test pins centroids at 1e-9 and assignments exactly); on the GPU
    the f32 distances/probabilities AND the f32 carried centroids sit
    inside the chunked (unseeded) mode's documented f32 relaxation —
    the former per-chunk program round-tripped the running means through
    host f64 between chunks, this one carries them in the corpus dtype."""
    global _CHUNK_DECIDE_TAIL
    if _CHUNK_DECIDE_TAIL is None:
        import functools
        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit,
                           static_argnames=("chunk", "cap", "sampler_kind",
                                            "n_steps"))
        def _tail(corpus, c0_tail, cent0, counts0, n_c, radius, draws,
                  base_rate, saturation, *, chunk, cap, sampler_kind,
                  n_steps):
            n, f = corpus.shape
            dt = corpus.dtype
            valid_c = (jnp.arange(cap) < n_c)[None, :]
            pos = jnp.arange(chunk, dtype=jnp.int32)
            radius = radius.astype(dt)

            def step(carry, inp):
                cent, counts = carry
                i, drw = inp
                c0 = c0_tail + i * chunk
                start = jnp.minimum(c0, n - chunk)
                m = jnp.clip(n - c0, 0, chunk)
                valid_from = chunk - m
                rows_c = jax.lax.dynamic_slice(
                    corpus, (start, jnp.zeros((), start.dtype)),
                    (chunk, f))
                d2 = (jnp.sum(rows_c * rows_c, axis=1)[:, None]
                      - 2.0 * jnp.dot(rows_c, cent.T,
                                      preferred_element_type=dt,
                                      precision=HIGHEST)
                      + jnp.sum(cent * cent, axis=1)[None, :])
                d2 = jnp.maximum(d2, 0.0)
                d2 = jnp.where(valid_c, d2, jnp.inf)
                best = jnp.argmin(d2, axis=1).astype(jnp.int32)
                bd = jnp.take_along_axis(
                    d2, best[:, None].astype(jnp.int64), axis=1)[:, 0]

                in_win = pos >= valid_from
                if sampler_kind == "none":
                    keep = in_win
                else:
                    if sampler_kind == "simple":
                        prob = jnp.full((chunk,), base_rate, dtype=dt)
                    else:   # density-adaptive (sampling.rs:167-238)
                        fin = jnp.isfinite(bd)
                        df = jnp.maximum(
                            jnp.log(jnp.where(fin, bd, 0.0) + 0.1), 0.0)
                        df = jnp.where(fin, df, 0.0)
                        prob = jnp.clip(
                            base_rate.astype(dt) * (1.0 - saturation * 0.1)
                            * (1.0 + df * 0.3), 0.01, 1.0)
                    keep = in_win & (drw < prob)
                kept_cnt = jnp.sum(keep.astype(jnp.int32))

                want_create = keep & (bd > radius * 0.5)
                assign_m = keep & ~want_create & (bd <= radius)
                soft_m = keep & ~assign_m & (bd <= radius * 1.5)

                t_a = jnp.where(assign_m, best, cap)   # park slot = cap
                sums = jnp.zeros((cap + 1, f), dtype=dt) \
                    .at[t_a].add(jnp.where(assign_m[:, None],
                                           rows_c, 0.0))[:cap]
                cadd = jnp.zeros((cap + 1,), jnp.int32) \
                    .at[t_a].add(assign_m.astype(jnp.int32))[:cap]
                t_s = jnp.where(soft_m, best, cap)
                scnt = jnp.zeros((cap + 1,), jnp.int32) \
                    .at[t_s].add(soft_m.astype(jnp.int32))[:cap]
                avec = jnp.where(assign_m | soft_m, best, jnp.int32(-1))

                new_counts = counts + cadd
                cf = counts.astype(dt)[:, None]
                nf = jnp.maximum(new_counts, 1).astype(dt)[:, None]
                cent = jnp.where((cadd > 0)[:, None],
                                 (cent * cf + sums) / nf, cent)
                counts = new_counts + scnt   # soft: counted, eta = 0
                return (cent, counts), (avec, kept_cnt)

            (cent, counts), (avecs, kepts) = jax.lax.scan(
                step, (cent0, counts0),
                (jnp.arange(n_steps, dtype=jnp.int32), draws))
            return cent, counts, avecs, jnp.sum(kepts)

        _CHUNK_DECIDE_TAIL = _tail
    return _CHUNK_DECIDE_TAIL


_CHUNK_DECIDE_TAIL = None

# Corpora below this many elements keep the clustering scan on host BLAS
# (a fresh accelerator compile dwarfs a few ms of matmul;
# with setup_cache persisting every program, the compile is one-time per
# corpus shape, so the gate sits where the host work starts to cost
# seconds: host Two-NN at 50k x 128 = 6.4M elements).
DEVICE_CLUSTERING_MIN_ELEMS = 1 << 22


def _device_chunk_for(nrows: int) -> int:
    """Static chunk length for the device snapshot-distance program:
    large tiles amortise the per-dispatch round trip.  Clamped to nrows
    so short-but-wide corpora (n < 8192 with n*f over the device gate,
    e.g. 4500x1024) don't trip _DeviceChunkDistances's chunk<=n
    invariant; keeping the clamp here keeps precompile.warm's AOT keys
    consistent with runtime.  Very large corpora double the chunk: at
    10M rows the scan's wall is per-chunk interconnect round trips, and
    a 256k snapshot window is still well inside the racy-mode contract
    (every row decides against a legal snapshot point)."""
    cap = 262144 if nrows >= (1 << 22) else 131072
    return min(cap, max(8192, nrows), nrows)


def _bucket_centroid_cap(max_clusters: int) -> int:
    """Pad the centroid-buffer row count to a multiple of 128 so the
    snapshot-distance program compiles once per cap bucket instead of once
    per data-dependent optimal-K value (extra rows are masked by n_c)."""
    return ((max(max_clusters, 1) + 127) // 128) * 128


class _DeviceChunkDistances:
    """Snapshot nearest-centroid distances on the accelerator.

    The corpus stays device-resident (one upload, shared with the λτ
    stages); per chunk only the (max_clusters x F) centroid snapshot goes
    up and (chunk,) best-index/best-d² come back — a few KB instead of
    a (chunk x F) tile.  The centroid buffer is padded
    to a 128-bucketed cap so one compiled program serves the whole scan
    AND any optimal-K the sweep lands on within the bucket.
    """

    def __init__(self, device_data, max_clusters: int, chunk: int):
        import jax.numpy as jnp

        self._jnp = jnp
        n, f = device_data.shape
        assert chunk <= n
        self.n = n
        self.chunk = chunk
        self.max_clusters = max_clusters
        self.mc_pad = _bucket_centroid_cap(max_clusters)
        # no padded copy: dynamic_slice clamps a tail start to n - chunk,
        # and __call__ takes the LAST m results — the corpus would
        # otherwise be held twice in HBM for the whole scan
        self.corpus = device_data
        self._dist = _chunk_dist_jit()
        self._segsum = _chunk_segsum_jit()

    def segment_sums(self, c0: int, tgt: np.ndarray):
        """Per-centroid (sums, counts) for the chunk window at c0, given
        per-row targets over the LAST min(chunk, n-c0) rows (-1 = not
        assigned).  The window alignment matches __call__: a tail start
        is clamped to n - chunk and the leading rows are masked out.

        Sums accumulate in f32 on device (the corpus dtype on the GPU): for
        unit-scale rows the running-mean error is ~1e-7 relative — well
        inside the chunked (unseeded) mode's documented f32-distance
        relaxation.  The seeded sequential path never uses this."""
        jnp = self._jnp
        m = min(self.chunk, self.n - c0)
        tgt_pad = np.full(self.chunk, -1, dtype=np.int32)
        tgt_pad[self.chunk - m:] = tgt
        sums, counts = self._segsum(
            self.corpus, np.int32(min(c0, self.n - self.chunk)),
            jnp.asarray(tgt_pad), chunk=self.chunk, cap=self.mc_pad)
        import jax
        sums, counts = jax.device_get((sums, counts))  # one round trip
        return (np.asarray(sums, dtype=np.float64),
                np.asarray(counts, dtype=np.int64))

    def tail_steps(self) -> int:
        """Static step count of the at-cap tail program: ceil(n/chunk),
        purely shape-derived (one compile per corpus/chunk shape
        regardless of where the scan saturates the cap)."""
        return (self.n + self.chunk - 1) // self.chunk

    def decide_tail(self, c0: int, cent: np.ndarray, counts: np.ndarray,
                    n_c: int, radius: float, sampler,
                    sampling_enabled: bool, max_clusters: int):
        """ALL remaining at-cap chunk decisions in one dispatch (see
        _chunk_decide_tail_jit): returns host (cent (n_c,F) f64,
        counts (n_c,) i64, assign_tail (n-c0,) i64, kept int) for the
        whole window [c0, n).  Draws come from the HOST sampler RNG in
        one pregenerated block — numpy Generators consume the bit
        stream per value, so rng.random(m_total) equals the per-chunk
        rng.random(m) sequence the host rule path draws."""
        import jax

        jnp = self._jnp
        dt = self.corpus.dtype
        n, chunk = self.n, self.chunk
        n_steps = self.tail_steps()
        m_total = n - c0
        n_real = (m_total + chunk - 1) // chunk
        cent_pad = np.zeros((self.mc_pad, self.corpus.shape[1]),
                            dtype=np.float64)
        cent_pad[:n_c] = cent[:n_c]
        counts_pad = np.zeros(self.mc_pad, dtype=np.int32)
        counts_pad[:n_c] = counts[:n_c]

        if sampling_enabled:
            from .sampling import SimpleRandomSampler
            kind = "simple" if isinstance(sampler, SimpleRandomSampler) \
                else "density"
            base = getattr(sampler, "keep_rate",
                           getattr(sampler, "base_rate", 1.0))
            draws = np.ones((n_steps, chunk), dtype=np.float64)
            flat = sampler._rng.random(m_total)
            off = 0
            for i in range(n_real):
                mi = min(chunk, n - (c0 + i * chunk))
                draws[i, chunk - mi:] = flat[off:off + mi]
                off += mi
        else:
            kind = "none"
            base = 1.0
            draws = np.zeros((n_steps, 1), dtype=np.float64)
        saturation = n_c / max_clusters if max_clusters else 0.0

        cent_new, counts_new, avecs, kept = _chunk_decide_tail_jit()(
            self.corpus, np.int32(c0),
            jnp.asarray(cent_pad, dtype=dt),
            jnp.asarray(counts_pad),
            np.int32(n_c),
            jnp.asarray(radius, dtype=dt),
            jnp.asarray(draws, dtype=dt),
            jnp.asarray(base, dtype=dt),
            jnp.asarray(saturation, dtype=dt),
            chunk=chunk, cap=self.mc_pad, sampler_kind=kind,
            n_steps=n_steps)
        cent_new, counts_new, avecs, kept = jax.device_get(
            (cent_new, counts_new, avecs, kept))
        assign_tail = np.empty(m_total, dtype=np.int64)
        off = 0
        for i in range(n_real):
            mi = min(chunk, n - (c0 + i * chunk))
            assign_tail[off:off + mi] = avecs[i, chunk - mi:]
            off += mi
        return (np.asarray(cent_new, dtype=np.float64)[:n_c],
                np.asarray(counts_new, dtype=np.int64)[:n_c],
                assign_tail, int(kept))

    def __call__(self, c0: int, cent: np.ndarray, n_c: int):
        jnp = self._jnp
        cent_pad = np.zeros((self.mc_pad, self.corpus.shape[1]),
                            dtype=np.float64)
        cent_pad[:n_c] = cent[:n_c]
        best, bd = self._dist(
            self.corpus, np.int32(c0),
            jnp.asarray(cent_pad, dtype=self.corpus.dtype),
            np.int32(n_c), chunk=self.chunk)
        m = min(self.chunk, self.n - c0)
        # tail chunk: the device window was clamped to [n - chunk, n), so
        # rows [c0, n) are the last m entries.  One batched fetch: each
        # separate np.asarray is a full device round trip.
        import jax
        best, bd = jax.device_get((best[-m:], bd[-m:]))
        return (np.asarray(best).astype(np.int64),
                np.asarray(bd, dtype=np.float64))


def _apply_chunk_decisions(rows_c, best, best_d2, offset, builder, sampler,
                           radius, max_clusters, cent, counts, assign,
                           state, segsum=None, fetch_at=None,
                           nfeatures=None) -> None:
    """Apply the per-row create/assign/soft-outlier rules for one chunk,
    given snapshot nearest-centroid results (best, best_d2).  Mutates
    cent/counts/assign in place and state["n_c"].  Shared by the
    single-chip chunked mode and the mesh-sharded build
    (parallel/distributed.sharded_incremental_clustering).

    segsum: optional device grouped-sum callable (tgt_local (m,) int32,
    -1 = not assigned) -> (sums (cap, F), counts (cap,)); when given,
    the running-mean reduction runs on the accelerator against the
    resident corpus instead of np.add.at over host rows.

    rows_c may be None when BOTH segsum and fetch_at are provided:
    fetch_at(local_idx) -> (len(idx), F) f64 rows serves the only
    remaining host use of row data — the few creator rows — so the
    sharded path never moves a full chunk of rows to the host."""
    m = best.shape[0]
    if m == 0:
        return
    if rows_c is None:
        assert segsum is not None and fetch_at is not None and \
            nfeatures is not None, \
            "lazy-row mode needs segsum + fetch_at + nfeatures"
    else:
        nfeatures = rows_c.shape[1]
    n_c = state["n_c"]
    relax = 1.5
    sampling_enabled = builder.sampling is not None

    if sampling_enabled:
        probs = sampler.keep_probability(best_d2, n_c, max_clusters)
        draws = sampler._rng.random(m)
        keep = draws < probs
        sampler.sampled_count += int(keep.sum())
        sampler.discarded_count += int(m - keep.sum())
    else:
        keep = np.ones(m, dtype=bool)

    want_create = keep & (best_d2 > radius * 0.5)
    assign_mask = keep & ~want_create & (best_d2 <= radius)
    soft_mask = keep & ~want_create & ~assign_mask \
        & (best_d2 <= radius * relax)

    # Creations: iterative refinement in row order.  A naive "every
    # creator creates" would let all same-cluster rows in a chunk spawn
    # duplicate centroids (none sees the others' creations) and slam the
    # cap on the first chunk — a far wider race than the reference's
    # rayon window of ~n_threads rows.  Instead, each actual creation
    # immediately re-filters the remaining candidates against the new
    # centroid (one vectorised matvec per creation): candidates that are
    # now within radius*0.5 re-route to assign/soft/drop on their updated
    # best distance.  Still a valid serialisation (every row's snapshot
    # point is legal), and it converges to the sequential scan's cluster
    # structure on separated data.
    creators = np.nonzero(want_create)[0]
    reroute_assign_rows, reroute_assign_tgt = [], []
    soft_extra_rows, soft_extra_tgt = [], []
    if creators.size and n_c >= max_clusters:
        # cap already reached: the creation loop cannot run, so every
        # candidate takes the soft test on its UNCHANGED best distance —
        # no row data needed (this also spares the sharded path its
        # creator-row fetch) and no f32 staging (the cast below exists
        # for the creation loop's BLAS block only).  Matches the at-cap
        # device tail program (_chunk_decide_tail_jit) bitwise on f64.
        lb = best_d2[creators]
        soft_ok = lb <= radius * relax
        soft_extra_rows.extend(creators[soft_ok].tolist())
        soft_extra_tgt.extend(best[creators][soft_ok].tolist())
    elif creators.size:
        creator_rows = rows_c[creators] if rows_c is not None \
            else fetch_at(creators)
        # fixed arrays + active mask: no per-iteration copies; f32
        # distances (this is the relaxed unseeded mode — the device
        # engine's snapshot distances are f32 already)
        cand_rows = np.ascontiguousarray(creator_rows,
                                         dtype=np.float32)
        cand_sq = np.einsum("ij,ij->i", cand_rows, cand_rows)
        cand_best = best_d2[creators].astype(np.float32)
        cand_best_idx = best[creators].astype(np.int64).copy()
        active = np.ones(creators.size, dtype=bool)
        half = np.float32(radius * 0.5)
        pos = 0
        while n_c < max_clusters:
            # first remaining candidate in row order
            rem = np.nonzero(active[pos:])[0]
            if rem.size == 0:
                break
            pos += int(rem[0])
            cent[n_c] = creator_rows[pos]
            counts[n_c] = 1
            assign[offset + creators[pos]] = n_c
            new_id = n_c
            n_c += 1
            active[pos] = False
            if not active.any():
                break
            # one BLAS matvec over the fixed candidate block
            d2new = np.maximum(
                cand_sq - 2.0 * (cand_rows @ cand_rows[pos])
                + cand_sq[pos], 0.0)
            closer = active & (d2new < cand_best)
            cand_best[closer] = d2new[closer]
            cand_best_idx[closer] = new_id
            leaving = active & (cand_best <= half)
            if leaving.any():
                # a leaver satisfies best <= radius*0.5 < radius, so it
                # always re-routes to ASSIGN (the soft-outlier band
                # radius..1.5*radius is unreachable from here)
                reroute_assign_rows.extend(creators[leaving].tolist())
                reroute_assign_tgt.extend(
                    cand_best_idx[leaving].tolist())
                active &= ~leaving
        if active.any():
            # cap reached (or candidates exhausted mid-pass): remaining
            # candidates take the soft-outlier test on their updated best
            lb = cand_best[active].astype(np.float64)
            lv = creators[active]
            li = cand_best_idx[active]
            soft_ok = lb <= radius * relax
            soft_extra_rows.extend(lv[soft_ok].tolist())
            soft_extra_tgt.extend(li[soft_ok].tolist())

    # grouped running-mean assignment (order-independent reduction),
    # including creator candidates re-routed to a within-chunk centroid
    a_idx = np.nonzero(assign_mask)[0]
    tgt = best[a_idx]
    if reroute_assign_rows:
        a_idx = np.concatenate([a_idx, np.asarray(reroute_assign_rows,
                                                  dtype=np.int64)])
        tgt = np.concatenate([tgt, np.asarray(reroute_assign_tgt,
                                              dtype=np.int64)])
    if a_idx.size:
        if segsum is not None:
            tgt_local = np.full(m, -1, dtype=np.int32)
            tgt_local[a_idx] = tgt
            sums_full, cnt_full = segsum(tgt_local)
            add_cnt = cnt_full[:n_c]
            add_sum = sums_full[:n_c]
        else:
            assert rows_c is not None
            add_cnt = np.bincount(tgt, minlength=n_c)
            add_sum = np.zeros((n_c, nfeatures))
            np.add.at(add_sum, tgt, rows_c[a_idx])
        upd = add_cnt > 0
        new_counts = counts[:n_c] + add_cnt
        cent[:n_c][upd] = (
            (cent[:n_c][upd] * counts[:n_c][upd, None]
             + add_sum[upd]) / new_counts[upd, None])
        counts[:n_c] = new_counts
        assign[offset + a_idx] = tgt

    # soft outliers: counted, centroids unmoved (eta = 0)
    soft_idx = np.nonzero(soft_mask)[0]
    soft_tgt = best[soft_idx]
    if soft_extra_rows:
        soft_idx = np.concatenate([soft_idx, np.asarray(soft_extra_rows,
                                                        dtype=np.int64)])
        soft_tgt = np.concatenate([soft_tgt, np.asarray(soft_extra_tgt,
                                                        dtype=np.int64)])
    if soft_idx.size:
        np.add.at(counts, soft_tgt, 1)
        assign[offset + soft_idx] = soft_tgt

    state["n_c"] = n_c


def _apply_atcap_tail(engine, c0: int, builder, sampler, radius,
                      max_clusters, cent, counts, assign,
                      n_c: int) -> None:
    """Apply the WHOLE at-cap remainder of the scan from the device tail
    program: final centroids/counts (running means carried on device),
    tail assignments, sampler stats — one dispatch, two transfers.
    Semantics identical to _apply_chunk_decisions chunk-by-chunk when
    n_c == max_clusters (proven by the engine-vs-host equality tests on
    the CPU/f64 backend)."""
    cent_new, counts_new, assign_tail, kept = engine.decide_tail(
        c0, cent, counts, n_c, radius, sampler,
        builder.sampling is not None, max_clusters)
    m_total = assign_tail.shape[0]
    if builder.sampling is not None:
        sampler.sampled_count += kept
        sampler.discarded_count += m_total - kept
    cent[:n_c] = cent_new
    counts[:n_c] = counts_new
    idx = np.nonzero(assign_tail >= 0)[0]
    if idx.size:
        assign[c0 + idx] = assign_tail[idx]


def _incremental_clustering_chunked(builder, rows, nfeatures, max_clusters,
                                    radius, sampler,
                                    chunk: Optional[int] = None,
                                    device_data=None):
    """Vectorised analogue of the reference's parallel (racy) mode: all
    rows in a chunk take their snapshot at the chunk boundary, distances
    are one matmul tile (device when a resident corpus is available, BLAS
    otherwise), and the running-mean updates are applied as grouped means
    (sequential running means over constant rows reduce to the same
    grouped mean).  Creations within a chunk respect the cap in row
    order; rows never see centroids created later in their own chunk —
    exactly the wider race window the reference's rayon mode allows."""
    nrows = len(rows)
    sampling_enabled = builder.sampling is not None

    engine = None
    # Sub-threshold corpora stay on host BLAS: an accelerator program
    # compile dwarfs a few ms of matmul.
    if (device_data is not None and device_data.shape[0] == nrows
            and nrows * nfeatures >= DEVICE_CLUSTERING_MIN_ELEMS):
        if chunk is None:
            chunk = _device_chunk_for(nrows)
        engine = _DeviceChunkDistances(device_data, max_clusters, chunk)
    elif chunk is None:
        chunk = 8192

    if engine is None:
        x = np.asarray(rows, dtype=np.float64)
    else:
        # with the device engine only the pre-cap chunks' rows are read
        # on the host (bootstrap + creator candidates) — the eager f64
        # conversion of the WHOLE corpus was a 10 GB host copy at
        # 10M x 128 for a scan whose at-cap majority never touches it;
        # slice-convert per visited chunk instead (identical values)
        x = rows if isinstance(rows, np.ndarray) else np.asarray(rows)
    nrows = x.shape[0]

    cent = np.zeros((max_clusters, nfeatures), dtype=np.float64)
    counts = np.zeros(max_clusters, dtype=np.int64)
    n_c = 0
    assign = np.full(nrows, -1, dtype=np.int64)
    t_scan0 = time.perf_counter()

    for c0 in range(0, nrows, chunk):
        use_engine = engine is not None

        if use_engine and n_c >= max_clusters:
            # at cap no row can create a centroid, so the ENTIRE
            # remainder of the scan (the post-cap majority of a large
            # corpus) runs on device in ONE dispatch — running means
            # carried in the scan, no per-chunk round trips
            logger.info("chunked scan: pre-cap phase %d rows in %.2fs; "
                        "at-cap tail %d rows in one dispatch",
                        c0, time.perf_counter() - t_scan0, nrows - c0)
            t_tail0 = time.perf_counter()
            _apply_atcap_tail(engine, c0, builder, sampler, radius,
                              max_clusters, cent, counts, assign, n_c)
            logger.info("chunked scan: at-cap tail done in %.2fs",
                        time.perf_counter() - t_tail0)
            break

        rows_c = np.asarray(x[c0:c0 + chunk], dtype=np.float64)
        m = rows_c.shape[0]
        offset = c0

        if n_c == 0:
            # bootstrap: scan sequentially until the first kept row seeds
            # centroid 0, then the chunk remainder proceeds vectorised
            continue_from = 0
            for r in range(m):
                kept = (not sampling_enabled) or sampler.should_keep(
                    rows_c[r], float("inf"), 0, max_clusters)
                continue_from = r + 1
                if kept:
                    cent[0] = rows_c[r]
                    counts[0] = 1
                    assign[c0 + r] = 0
                    n_c = 1
                    break
            if n_c == 0:
                continue  # whole chunk rejected before any centroid
            rows_c = rows_c[continue_from:]
            offset = c0 + continue_from
            m = rows_c.shape[0]
            if m == 0:
                continue
            # mid-chunk restart is tile-misaligned: finish this one chunk
            # on the host, the device engine resumes at the next boundary
            use_engine = False

        segsum = None
        if use_engine:
            best, best_d2 = engine(c0, cent, n_c)
            segsum = (lambda tgt_local, _c0=c0:
                      engine.segment_sums(_c0, tgt_local))
        else:
            snap = cent[:n_c]
            d2 = (np.sum(rows_c * rows_c, axis=1)[:, None]
                  - 2.0 * rows_c @ snap.T
                  + np.sum(snap * snap, axis=1)[None, :])
            d2 = np.maximum(d2, 0.0)
            best = np.argmin(d2, axis=1)
            best_d2 = d2[np.arange(m), best]

        state = {"n_c": n_c}
        _apply_chunk_decisions(rows_c, best, best_d2, offset, builder,
                               sampler, radius, max_clusters, cent, counts,
                               assign, state, segsum=segsum)
        n_c = state["n_c"]

    if n_c == 0:
        sampler_desc = str(builder.sampling) if builder.sampling else "None"
        raise RuntimeError(
            f"No clusters created from data, sampling: {sampler_desc}")

    if sampling_enabled:
        sampled, discarded = sampler.get_stats()
        ratio = sampled / nrows if nrows else 0.0
        logger.debug("Chunked clustering: %d kept (%.2f%%), %d discarded",
                     sampled, ratio * 100.0, discarded)
        if not is_test_mode():
            assert 0.325 < ratio < 0.89, (
                f"sampling_rate not in the interval 0.325..0.875 but {ratio}")

    return cent[:n_c].copy(), Assignments(assign), counts[:n_c].tolist()


def _incremental_clustering_numpy(builder, rows, nfeatures, max_clusters,
                                  radius, sampler):
    x = np.asarray(rows, dtype=np.float64)
    nrows = x.shape[0]
    logger.info("Starting incremental clustering with inline sampling "
                "(max_clusters=%d, radius=%.4f)", max_clusters, radius)

    sampling_enabled = builder.sampling is not None

    # Pre-allocated centroid buffer; `n_c` live centroids.
    cent = np.zeros((max_clusters, nfeatures), dtype=np.float64)
    counts = np.zeros(max_clusters, dtype=np.int64)
    n_c = 0
    assignments: List[Optional[int]] = [None] * nrows
    relax_factor = 1.5

    for row_idx in range(nrows):
        row = x[row_idx]

        # PHASE 1: snapshot distance (sequential => snapshot == current)
        if n_c == 0:
            best_idx, best_d2 = 0, float("inf")
        else:
            d2 = np.sum((cent[:n_c] - row[None, :]) ** 2, axis=1)
            best_idx = int(np.argmin(d2))
            best_d2 = float(d2[best_idx])

        if sampling_enabled:
            if not sampler.should_keep(row, best_d2, n_c, max_clusters):
                continue

        # First centroid special case
        if n_c == 0:
            cent[0] = row
            counts[0] = 1
            assignments[row_idx] = 0
            n_c = 1
            continue

        # PHASE 3: decision on snapshot distance
        if n_c < max_clusters and best_d2 > radius * 0.5:
            cent[n_c] = row
            counts[n_c] = 1
            assignments[row_idx] = n_c
            n_c += 1
        elif best_d2 <= radius:
            # running-mean assignment (recomputed against current state)
            d2 = np.sum((cent[:n_c] - row[None, :]) ** 2, axis=1)
            bi = int(np.argmin(d2))
            k_new = counts[bi] + 1
            cent[bi] += (row - cent[bi]) / k_new
            counts[bi] = k_new
            assignments[row_idx] = bi
        else:
            # soft-outlier policy after saturation (clustering.rs:760-814)
            d2 = np.sum((cent[:n_c] - row[None, :]) ** 2, axis=1)
            bi = int(np.argmin(d2))
            cur_d2 = float(d2[bi])
            if cur_d2 <= radius * relax_factor:
                counts[bi] += 1  # centroid not moved (eta = 0)
                assignments[row_idx] = bi
            # else: drop

    if n_c == 0:
        sampler_desc = str(builder.sampling) if builder.sampling else "None"
        raise RuntimeError(
            f"No clusters created from data, sampling: {sampler_desc}")

    if sampling_enabled:
        sampled, discarded = sampler.get_stats()
        sampling_ratio = sampled / nrows if nrows else 0.0
        logger.debug("Inline sampling complete: %d kept (%.2f%%), %d discarded",
                     sampled, sampling_ratio * 100.0, discarded)
        if not is_test_mode():
            assert 0.325 < sampling_ratio < 0.89, (
                f"sampling_rate not in the interval 0.325..0.875 "
                f"but {sampling_ratio}")

    return cent[:n_c].copy(), assignments, counts[:n_c].tolist()
