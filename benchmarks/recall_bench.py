"""Recall benchmark: λ-aware search vs brute-force cosine ground truth
at equal memory (BASELINE.json: "SIFT1M 128-d ... recall@10/@100 vs
flat-cosine at equal memory"), across MULTIPLE distributions.

SIFT1M/GloVe cannot be downloaded (zero egress), so the sweep covers:
  - sift_like      : synthetic SIFT look-alike (clustered, non-negative,
                     positive-skew magnitudes)
  - quora_real     : the reference's real 384-d sentence-transformer
                     embeddings (tests/fixtures/reference_embeddings.npz,
                     from test_data.rs:1-6/:5801), replicated with small
                     perturbations to n rows — real covariance structure
  - anisotropic    : variance concentrated in a few directions
                     (condition number ~1e3), the spectral worst case
  - duplicate_heavy: 30% of rows are exact duplicates of a small pool —
                     tie-ordering stress
  - heavy_tailed   : log-normal row norms spanning ~4 decades

Per family: recall@10/@100 of the λ-blend vs flat cosine at several α
(the index stores the raw vectors + one λ scalar per row — memory parity
with a flat index up to (N+1)/N), an exactness assert of the production
search path (ArrowSpace.search_lambda_aware_batch) against the jitted
step, and the f64_rescore exact-order@10 assert.

Usage: python benchmarks/recall_bench.py [N] (default 100_000)
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FIXTURES = pathlib.Path(__file__).parent.parent / "tests" / "fixtures"


def sift_like(n: int, f: int = 128, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_clusters = 64
    centers = rng.gamma(2.0, 20.0, (n_clusters, f))
    labels = rng.integers(0, n_clusters, n)
    rows = centers[labels] + rng.normal(0, 8.0, (n, f))
    return np.maximum(rows, 0.0)  # SIFT is non-negative


def quora_real(n: int, seed: int = 0) -> np.ndarray:
    """Real 384-d embeddings replicated with small perturbations: keeps
    the true covariance/cosine-concentration structure of
    sentence-transformer space (the regime where f32 recall@10 dropped
    to ~0.96 in round 2)."""
    data = np.load(FIXTURES / "reference_embeddings.npz")
    base = np.concatenate([data["quora"], data["proteins"]], axis=0)
    rng = np.random.default_rng(seed)
    rows = base[rng.integers(0, base.shape[0], n)]
    rows = rows + rng.normal(0, 0.02, rows.shape)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def anisotropic(n: int, f: int = 128, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scales = np.geomspace(1.0, 1e-3, f)
    basis = np.linalg.qr(rng.normal(size=(f, f)))[0]
    return rng.normal(size=(n, f)) * scales @ basis.T


def duplicate_heavy(n: int, f: int = 128, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pool = rng.normal(size=(max(n // 100, 10), f))
    rows = rng.normal(size=(n, f))
    dup_idx = rng.integers(0, n, int(0.3 * n))
    rows[dup_idx] = pool[rng.integers(0, pool.shape[0], dup_idx.shape[0])]
    return rows


def heavy_tailed(n: int, f: int = 128, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n, f))
    norms = rng.lognormal(0.0, 2.0, n)
    return rows * norms[:, None]


FAMILIES = {
    "sift_like": sift_like,
    "quora_real": quora_real,
    "anisotropic": anisotropic,
    "duplicate_heavy": duplicate_heavy,
    "heavy_tailed": heavy_tailed,
}


def run_family(name: str, make, n: int, results: list) -> None:
    import jax
    import jax.numpy as jnp
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.index import ArrowIndex
    from arrowspace_tpu.ops.search import (batched_lambda_aware_topk,
                                           cosine_scores)
    from arrowspace_tpu.taumode import select_tau_batch, \
        synthetic_lambda_batch

    n_queries = 100
    corpus = make(n)
    rng = np.random.default_rng(1234)
    q_src = corpus[rng.integers(0, n, n_queries)]
    queries = q_src * 0.98 + make(n_queries, seed=4321)[:, :q_src.shape[1]] \
        * 0.02

    t0 = time.time()
    builder = (ArrowSpaceBuilder()
               .with_lambda_graph(0.5, 8, 4, 2.0, None)
               .with_seed(7))
    aspace, gl = builder.build(corpus)
    print(f"[{name}] build({n}x{corpus.shape[1]}): {time.time()-t0:.1f}s "
          f"clusters={aspace.n_clusters}", file=sys.stderr, flush=True)

    dt = aspace.data.dtype
    qd = jnp.asarray(queries, dtype=dt)
    gt_scores = cosine_scores(qd, aspace.data)
    gt100 = np.asarray(jax.lax.top_k(gt_scores, 100)[1])

    taus = select_tau_batch(qd, aspace.taumode)
    qlam = synthetic_lambda_batch(qd, gl.matrix.astype(dt), taus)

    fam = {"family": name, "n": n, "f": int(corpus.shape[1]),
           "recall": {}}
    print(f"[{name}] {'alpha':>6} {'recall@10':>10} {'recall@100':>11}",
          file=sys.stderr, flush=True)
    for alpha in (1.0, 0.95, 0.9, 0.8):
        _, idx = batched_lambda_aware_topk(
            qd, qlam, aspace.data, aspace.lambdas,
            jnp.asarray(alpha, dtype=dt), k=100)
        idx = np.asarray(idx)
        r10 = np.mean([len(set(idx[i][:10]) & set(gt100[i][:10])) / 10.0
                       for i in range(n_queries)])
        r100 = np.mean([len(set(idx[i]) & set(gt100[i])) / 100.0
                        for i in range(n_queries)])
        fam["recall"][str(alpha)] = {"r10": round(float(r10), 4),
                                     "r100": round(float(r100), 4)}
        print(f"[{name}] {alpha:>6.2f} {r10:>10.3f} {r100:>11.3f}",
              file=sys.stderr, flush=True)

    # Production-path exactness at scale: the public batched search must
    # match the jitted step EXACTLY — duplicate_heavy makes this a tie
    # storm.
    s_prod, i_prod = aspace.search_lambda_aware_batch(
        queries, np.asarray(qlam), 10, 0.9)
    _, i_oracle = batched_lambda_aware_topk(
        qd, qlam, aspace.data, aspace.lambdas,
        jnp.asarray(0.9, dtype=dt), k=10)
    mismatch = int((np.asarray(i_prod) != np.asarray(i_oracle)).sum())
    fam["production_kernel_idx_mismatches"] = mismatch
    assert mismatch == 0, f"{name}: production kernel != XLA oracle"
    print(f"[{name}] production kernel == XLA oracle at k=10 (exact)",
          file=sys.stderr, flush=True)

    # f64 re-ranking: exact f64 ordering on every family.  The pool is
    # sized for the worst duplicate multiplicity in the sweep: the
    # replicated-real-embedding family packs ~n/25 near-copies per base
    # vector, and a pool smaller than the f32-tie width cannot contain
    # the f64 top-10 (index.search docstring).
    index = ArrowIndex(aspace, gl, builder)
    pool = min(4096, n)
    s64, i64 = index.search(queries, k=10, alpha=1.0,
                            precision="f64_rescore", rescore_pool=pool)
    qn = np.linalg.norm(queries, axis=1)[:, None]
    cn = np.linalg.norm(corpus, axis=1)[None, :]
    denom = qn * cn
    cosd = np.where(denom > 0, (queries @ corpus.T) / np.where(
        denom > 0, denom, 1.0), 0.0)
    gt64 = np.lexsort((np.broadcast_to(np.arange(n), cosd.shape),
                       -cosd), axis=1)[:, :10]
    exact = np.mean([list(i64[i]) == list(gt64[i])
                     for i in range(n_queries)])
    fam["f64_rescore_exact_order_at_10"] = round(float(exact), 4)
    print(f"[{name}] f64_rescore exact-order@10: {exact:.3f}",
          file=sys.stderr, flush=True)
    assert exact == 1.0, f"{name}: f64_rescore must recover exact order"
    results.append(fam)


def main() -> None:
    from arrowspace_tpu.config import setup_cache
    setup_cache()

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    only = sys.argv[2].split(",") if len(sys.argv) > 2 else None
    results = []
    for name, make in FAMILIES.items():
        if only and name not in only:
            continue
        run_family(name, make, n, results)
    print(json.dumps({"recall_bench": results}), flush=True)


if __name__ == "__main__":
    main()
