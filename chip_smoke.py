#!/usr/bin/env python3
"""Run the λτ build and serving path once on an NVIDIA GPU and check it
against a plain NumPy f64 reference.

    python chip_smoke.py              # one card, every phase below
    python chip_smoke.py --gpus 4     # four cards: the sharded path only

Phases (one card), each fatal on failure:

  setup    build the native clustering library (make -C
           arrowspace_tpu/native), print the card's name and power limit
  build    ArrowIndex.build over 1M x 128 seeded clustered rows; λτ
           against the f64 per-item oracle on 4096 sampled rows
  serve    SearchSession B=2048 (f32, bf16), B=16, search_one, the
           f64_rescore and α=1 paths, planted exact duplicates
  routing  B=16 over 8k x 128 on the host CPU backend and on the card
  wide     500k x 768: λτ and B=2048 queries, the same checks
  memory   a 10M x 128 SearchSession at B=2048 (a bounded score plane)
  pruned   the device-built cell screen at B=16 with auto_budget over
           1M x 128 rows of 1024 small clusters
  energy   1M x 64 EnergySearchSession at B=256 and B=2048
  live     the 1M index at capacity 2M: add, update, delete, search

Every line before the last carries the card's name and power limit; the
last line is one JSON object {"ok": true, "device": {...}}.  Without a
GPU the script exits non-zero and prints no such line.  The phase
functions take their sizes as arguments, so the tests run them on the
CPU at tiny sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Score tolerance against the f64 reference (BASELINE.json's 1e-5 λτ
# target), and the f64 rank gap below which two results count as tied.
SCORE_TOL = 1e-5
TIE_GAP = 2e-5
# The energy score reads ||z_q - z|| through the f32 d² = |a|² + |b|² -
# 2a·b expansion, whose cancellation costs ~1e-5 on unit-scale z.
ENERGY_TOL = 1e-4
ENERGY_GAP = 2e-4

FULL = dict(n=1_000_000, f=128, centers=64, b=2048, k=10, alpha=0.9,
            n_check=256, n_lambda=4096, wide_n=500_000, wide_f=768,
            wide_lambda=1024, mem_n=10_000_000, route_n=8192,
            energy_n=1_000_000, energy_f=64, energy_b=(256, 2048),
            pruned_batches=8, pruned_centers=1024, live_cap=2_000_000, live_add=10_000,
            live_update=1_000, live_delete=1_000, mesh_n=4_000_000)


class SmokeError(RuntimeError):
    """A phase's check failed."""


class Ctx:
    """Printing and checking for one run: every line carries the label
    (the card's name and power limit)."""

    def __init__(self, label: str, out=sys.stdout):
        self.label = label
        self.out = out

    def log(self, phase: str, **values) -> None:
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in values.items())
        print(f"[{self.label}] {phase}: {kv}", file=self.out, flush=True)

    @staticmethod
    def check(cond, what: str) -> None:
        if not cond:
            raise SmokeError(what)


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def card_label() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# data, seeded
# ---------------------------------------------------------------------------

def clustered_rows(n: int, f: int, centers: int, seed: int,
                   noise: float = 0.05) -> np.ndarray:
    """Clustered Gaussian rows, f64 on the host."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (centers, f))
    return c[rng.integers(0, centers, n)] + rng.normal(0, noise, (n, f))


def plant_duplicates(rows: np.ndarray) -> list:
    """Three exact copies of one row, far apart; returns their indices."""
    n = rows.shape[0]
    dup = [n // 81 + 1, (2 * n) // 5, (7 * n) // 9]
    rows[dup[1]] = rows[dup[0]]
    rows[dup[2]] = rows[dup[0]]
    return dup


def noisy_queries(rows: np.ndarray, m: int, seed: int,
                  noise: float = 0.01) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, rows.shape[0], m)
    return rows[pick] + rng.normal(0, noise, (m, rows.shape[1]))


# ---------------------------------------------------------------------------
# the f64 reference
# ---------------------------------------------------------------------------

def ref_tau_median(x: np.ndarray) -> np.ndarray:
    """Per-row median τ with the 1e-10 floor (taumode.rs:87-127)."""
    return np.maximum(np.median(x, axis=1), 1e-10)


def ref_lambda(x: np.ndarray, lap: np.ndarray,
               block: int = 16) -> np.ndarray:
    """Direct per-item synthetic λ in f64 (taumode.rs:552-660, the
    pairwise form of tests/helpers.oracle_synthetic_lambda), vectorised
    over row blocks; a graph wider than the rows reads them zero-padded
    (the allow_tall_graphs extension)."""
    x = np.asarray(x, np.float64)
    lap = np.asarray(lap, np.float64)
    n = lap.shape[0]
    tau = ref_tau_median(x)
    xn = np.pad(x, ((0, 0), (0, n - x.shape[1]))) if n > x.shape[1] \
        else x[:, :n]
    w = np.maximum(-lap, 0.0)
    np.fill_diagonal(w, 0.0)
    out = np.empty(x.shape[0])
    for lo in range(0, x.shape[0], block):
        xb = xn[lo:lo + block]
        num = np.einsum("bi,ij,bj->b", xb, lap, xb)
        den = np.sum(x[lo:lo + block] ** 2, axis=1)
        e = np.where(den > 1e-12, num / np.where(den > 1e-12, den, 1.0),
                     0.0)
        diff = xb[:, :, None] - xb[:, None, :]
        contrib = w[None] * diff * diff
        s = contrib.sum(axis=(1, 2))
        g = np.where(s > 0, (contrib ** 2).sum(axis=(1, 2))
                     / np.where(s > 0, s * s, 1.0), 0.0)
        g = np.clip(g, 0.0, 1.0)
        t = tau[lo:lo + block]
        out[lo:lo + block] = t * e / (e + t) + (1.0 - t) * g
    return out


def _unit(a: np.ndarray) -> np.ndarray:
    nrm = np.linalg.norm(a, axis=1, keepdims=True)
    return np.where(nrm > 0, a / np.where(nrm > 0, nrm, 1.0), 0.0)


def ref_topk(score_block, n_q: int, k: int, chunk: int = 32):
    """Top-(k+1) of an f64 score plane computed `chunk` queries at a
    time by score_block(lo, hi) -> (hi-lo, N); ties to the lowest
    index.  Returns (scores (B, k+1), ids (B, k+1))."""
    ss, ii = [], []
    for lo in range(0, n_q, chunk):
        s = score_block(lo, min(lo + chunk, n_q))
        m = min(k + 1 + 64, s.shape[1])
        part = np.argpartition(-s, m - 1, axis=1)[:, :m]
        for r in range(s.shape[0]):
            cand = part[r]
            order = np.lexsort((cand, -s[r, cand]))[:k + 1]
            ss.append(s[r, cand[order]])
            ii.append(cand[order])
    return np.stack(ss), np.stack(ii)


def ref_lambda_topk(q, qlam, x_unit, lam, alpha, k):
    """f64 λ-aware top-(k+1) (core.rs:135-175, 760-798)."""
    qh = _unit(np.asarray(q, np.float64))

    def block(lo, hi):
        cos = qh[lo:hi] @ x_unit.T
        dl = np.abs(qlam[lo:hi, None] - lam[None, :])
        return alpha * cos + (1.0 - alpha) * (1.0 - np.minimum(dl, 1.0))
    return ref_topk(block, q.shape[0], k)


def ref_energy_topk(zq, qlam, z, lam, wl, wd, k):
    """f64 energy top-(k+1) (energymaps.rs:368-407)."""
    zsq = np.sum(z * z, axis=1)

    def block(lo, hi):
        d2 = (np.sum(zq[lo:hi] ** 2, axis=1)[:, None] + zsq[None, :]
              - 2.0 * zq[lo:hi] @ z.T)
        num = np.sqrt(np.maximum(d2, 0.0))
        d_dir = np.minimum(num / (1.0 + num), 1.0)
        return -(wl * np.abs(qlam[lo:hi, None] - lam[None, :])
                 + wd * d_dir)
    return ref_topk(block, zq.shape[0], k)


def check_topk(ctx: Ctx, what: str, s, i, ref_s, ref_i, tol=SCORE_TOL,
               gap=TIE_GAP) -> dict:
    """Device top-k against the f64 top-(k+1): every score within tol;
    the id set equal wherever the rank-k/k+1 gap exceeds `gap`; each
    position equal where both neighbouring gaps exceed it."""
    s = np.asarray(s, np.float64)
    i = np.asarray(i)
    k = s.shape[1]
    err = float(np.max(np.abs(s - ref_s[:, :k])))
    ctx.check(err <= tol, f"{what}: max |Δscore| {err:.3g} > {tol}")
    set_rows = pos_checked = 0
    for r in range(s.shape[0]):
        gaps = ref_s[r, :-1] - ref_s[r, 1:]          # (k,)
        if gaps[k - 1] > gap:
            set_rows += 1
            ctx.check(set(i[r]) == set(ref_i[r, :k]),
                      f"{what}: row {r} ids {list(i[r])} != "
                      f"{list(ref_i[r, :k])}")
        for j in range(k):
            left = gaps[j - 1] if j else np.inf
            if left > gap and gaps[j] > gap:
                pos_checked += 1
                ctx.check(i[r, j] == ref_i[r, j],
                          f"{what}: row {r} rank {j} id {i[r, j]} != "
                          f"{ref_i[r, j]}")
    return dict(max_score_err=err, rows_set_checked=set_rows,
                ranks_checked=pos_checked)


def lambda_error(ctx: Ctx, what: str, lam_dev, rows, lap, n_sample: int,
                 seed: int) -> float:
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(rows.shape[0], min(n_sample, rows.shape[0]),
                              replace=False))
    ref = ref_lambda(rows[pick], lap)
    err = float(np.max(np.abs(np.asarray(lam_dev)[pick] - ref)))
    ctx.check(err <= SCORE_TOL, f"{what}: max |Δλ| {err:.3g} > {SCORE_TOL}")
    return err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_setup(ctx: Ctx) -> None:
    """Build and load the native clustering library (a 1M build without
    it crawls through the Python scan)."""
    t0 = time.perf_counter()
    subprocess.run(["make", "-s", "-C",
                    os.path.join(HERE, "arrowspace_tpu", "native")],
                   check=True)
    from arrowspace_tpu.native import clustering_native
    ctx.check(clustering_native._load() is not None,
              "native clustering library did not load")
    ctx.log("setup", native="loaded", seconds=time.perf_counter() - t0)


def _timed_stream(sess, batches):
    """Warm the session, then stream the batches; returns (results,
    warmup seconds, per-batch seconds)."""
    t0 = time.perf_counter()
    sess.warmup()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = list(sess.search_stream(batches))
    return out, t_warm, (time.perf_counter() - t0) / len(batches)


def phase_build(ctx: Ctx, n: int, f: int, centers: int, n_lambda: int,
                seed: int):
    """1M x 128 seeded build through ArrowIndex.build; λτ against the f64
    oracle; data and λ must live on the GPU (the CPU in tests)."""
    import jax

    from arrowspace_tpu.index import ArrowIndex
    rows = clustered_rows(n, f, centers, seed)
    dup = plant_duplicates(rows)
    t0 = time.perf_counter()
    index = ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=seed)
    jax.block_until_ready(index.aspace.lambdas)
    t_build = time.perf_counter() - t0
    platform = jax.devices()[0].platform
    for name, arr in (("data", index.aspace.data),
                      ("lambdas", index.aspace.lambdas)):
        kinds = {d.platform for d in arr.devices()}
        ctx.check(kinds == {platform},
                  f"aspace.{name} lives on {kinds}, not {platform}")
    err = lambda_error(ctx, "build λτ", index.aspace.lambdas, rows,
                       np.asarray(index.gl.matrix), n_lambda, seed + 1)
    ctx.log("build", rows=n, features=f, seconds=t_build,
            clusters=index.aspace.n_clusters,
            graph=index.gl.shape()[0], lambda_max_err=err,
            lambda_rows_checked=min(n_lambda, n))
    return index, rows, dup


def _session_checks(ctx, what, index, rows, queries, k, alpha, b,
                    precision="f32"):
    """One session over `queries` (whole batches of b), checked against
    the f64 reference.  Returns (scores, ids, timings)."""
    sess = index.make_search_session(batch_size=b, k=k, alpha=alpha,
                                     precision=precision)
    batches = [queries[lo:lo + b] for lo in range(0, queries.shape[0], b)]
    out, t_warm, t_batch = _timed_stream(sess, batches)
    s = np.concatenate([o[0] for o in out])
    i = np.concatenate([o[1] for o in out])
    return s, i, dict(warmup_s=t_warm, batch_s=t_batch)


def phase_serve(ctx: Ctx, index, rows, dup, b: int, k: int, alpha: float,
                n_check: int, seed: int) -> None:
    """SearchSession B=b in f32 and bf16, B=16, search_one, f64_rescore,
    α=1 and the planted duplicates, against the f64 reference."""
    gl_lap = np.asarray(index.gl.matrix, np.float64)
    lam_dev = np.asarray(index.aspace.lambdas, np.float64)
    x_unit = _unit(rows)
    queries = noisy_queries(rows, b, seed)
    queries[:3] = rows[dup[0]] * 1.01          # planted-duplicate probes
    qc = queries[:n_check]
    qlam_ref = ref_lambda(qc, gl_lap)

    s32, i32, t32 = _session_checks(ctx, "serve", index, rows, queries, k,
                                    alpha, b)
    ref_s, ref_i = ref_lambda_topk(qc, qlam_ref, x_unit, lam_dev, alpha, k)
    res = check_topk(ctx, f"serve B={b} f32", s32[:n_check],
                     i32[:n_check], ref_s, ref_i)
    ctx.check(list(i32[0, :3]) == sorted(dup),
              f"planted duplicates {sorted(dup)} came back as "
              f"{list(i32[0, :3])}")
    ctx.log("serve", batch=b, precision="f32", **t32, **res,
            duplicates_lowest_first=True)

    s16, i16, t16 = _session_checks(ctx, "serve", index, rows, queries, k,
                                    alpha, b, precision="bf16")
    overlap = float(np.mean([len(set(x) & set(y)) / k
                             for x, y in zip(i32, i16)]))
    ctx.check(overlap >= 0.99, f"bf16 top-{k} overlap {overlap:.4f} < 0.99")
    ctx.log("serve", batch=b, precision="bf16", **t16,
            top_k_overlap_vs_f32=overlap)

    small = queries[:16]
    s_b16, i_b16, t_b16 = _session_checks(ctx, "serve", index, rows, small,
                                          k, alpha, 16)
    res16 = check_topk(ctx, "serve B=16", s_b16, i_b16, ref_s[:16],
                       ref_i[:16])
    one = index.search_one(small[3], k=k, alpha=alpha)
    s1, i1 = index.search(small[3:4], k=k, alpha=alpha)
    ctx.check([a for a, _ in one] == [int(a) for a in i1[0]]
              and np.allclose([c for _, c in one], s1[0], rtol=0,
                              atol=1e-6),
              f"search_one {one} != B=1 search {list(i1[0])}")
    ctx.log("serve", batch=16, **t_b16, **res16, search_one="== B=1")

    # f64_rescore: exact ids against the f64 score over the index's own λ
    qlam_dev = np.asarray(index.aspace.prepare_query_items_batch(
        qc, index.gl), np.float64)
    _, i_rs = index.search(qc, k=k, alpha=alpha, precision="f64_rescore")
    _, ref_rs_i = ref_lambda_topk(qc, qlam_dev, x_unit, lam_dev, alpha, k)
    ctx.check(np.array_equal(i_rs, ref_rs_i[:, :k]),
              "f64_rescore ids differ from the f64 reference")
    # α=1: the step's plane is the cosine; brute-force f64 cosine
    s_a1, i_a1 = index.search(qc, k=k, alpha=1.0)
    ref_a1_s, ref_a1_i = ref_lambda_topk(qc, qlam_ref, x_unit, lam_dev,
                                         1.0, k)
    res_a1 = check_topk(ctx, "alpha=1", s_a1, i_a1, ref_a1_s, ref_a1_i)
    ctx.log("serve", f64_rescore="ids exact",
            alpha1_max_score_err=res_a1["max_score_err"])


def phase_routing(ctx: Ctx, n: int, f: int, seed: int, reps: int = 50
                  ) -> dict:
    """B=16 over n x f: the one XLA step on the host CPU backend and on
    the default device, timed end to end (dispatch + result fetch)."""
    import jax
    import jax.numpy as jnp

    from arrowspace_tpu.ops.search import batched_lambda_aware_topk
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    lam = rng.uniform(size=n).astype(np.float32)
    q = rng.normal(size=(16, f)).astype(np.float32)
    ql = rng.uniform(size=16).astype(np.float32)

    def time_on(dev):
        with jax.default_device(dev):
            xd, ld = jnp.asarray(x), jnp.asarray(lam)

            def run():
                return jax.device_get(batched_lambda_aware_topk(
                    jnp.asarray(q), jnp.asarray(ql), xd, ld,
                    jnp.float32(0.9), k=10))
            run()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    host = time_on(jax.devices("cpu")[0])
    card = time_on(jax.devices()[0])
    ctx.log("routing", batch=16, rows=n, features=f, host_ms=host,
            device_ms=card, device=jax.devices()[0].platform)
    return dict(host_ms=host, device_ms=card)


def _index_over(index, data, lambdas=None):
    """An ArrowIndex over new rows with `index`'s graph and settings —
    the reference's λ semantics (item edits never rebuild the graph,
    core.rs:644): λτ is computed for every row on the device."""
    from arrowspace_tpu.eigenmaps import compute_taumode
    from arrowspace_tpu.index import ArrowIndex
    aspace = dataclasses.replace(
        index.aspace, nitems=int(data.shape[0]), data=data,
        lambdas=lambdas, host_rows=None, _projected_cache=None,
        cluster_assignments=None, cluster_sizes=None)
    aspace._lambda_order = None
    if lambdas is None:
        compute_taumode(aspace, index.gl)
    return ArrowIndex(aspace, index.gl)


def phase_wide(ctx: Ctx, n: int, f: int, centers: int, b: int, k: int,
               alpha: float, n_check: int, n_lambda: int, seed: int) -> None:
    """500k x 768: the graph from a seeded 8%-of-rows build, λτ for every
    row on the device, B=b queries — the serve checks at wide F."""
    import jax
    import jax.numpy as jnp

    from arrowspace_tpu.index import ArrowIndex
    rows = clustered_rows(n, f, centers, seed)
    t0 = time.perf_counter()
    sub = ArrowIndex.build(rows[: max(n // 12, 64)], eps=1.0, k=6, topk=3,
                           seed=seed)
    t_graph = time.perf_counter() - t0
    data = jnp.asarray(rows, dtype=sub.aspace.data.dtype)
    t0 = time.perf_counter()
    index = _index_over(sub, data)
    jax.block_until_ready(index.aspace.lambdas)
    t_lam = time.perf_counter() - t0
    lap = np.asarray(index.gl.matrix, np.float64)
    err = lambda_error(ctx, "wide λτ", index.aspace.lambdas, rows, lap,
                       n_lambda, seed + 1)
    ctx.log("wide", rows=n, features=f, graph_build_s=t_graph,
            lambda_s=t_lam, lambda_max_err=err)
    queries = noisy_queries(rows, b, seed + 2)
    s, i, t = _session_checks(ctx, "wide", index, rows, queries, k, alpha,
                              b)
    qc = queries[:n_check]
    ref_s, ref_i = ref_lambda_topk(qc, ref_lambda(qc, lap), _unit(rows),
                                   np.asarray(index.aspace.lambdas,
                                              np.float64), alpha, k)
    res = check_topk(ctx, f"wide B={b}", s[:n_check], i[:n_check], ref_s,
                     ref_i)
    ctx.log("wide", batch=b, **t, **res)


def phase_memory(ctx: Ctx, index, n: int, b: int, k: int, alpha: float,
                 seed: int) -> dict:
    """A SearchSession over n rows at B=b whose (B, N) plane would not fit
    the card (84 GB at 10M x 2048): the step scans row chunks.  The
    corpus is generated on the device; every batch's top-1 is its own
    source row."""
    import jax
    import jax.numpy as jnp

    f = index.aspace.nfeatures
    dt = index.aspace.data.dtype
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    centers = jax.random.uniform(k1, (64, f), dt, 0.2, 0.8)
    assign = jax.random.randint(k2, (n,), 0, 64)
    data = centers[assign] + 0.05 * jax.random.normal(k3, (n, f), dt)
    t0 = time.perf_counter()
    big = _index_over(index, data)
    jax.block_until_ready(big.aspace.lambdas)
    t_lam = time.perf_counter() - t0
    src = np.random.default_rng(seed).choice(n, b, replace=False)
    queries = np.asarray(data[jnp.asarray(src)], np.float64)
    sess = big.make_search_session(batch_size=b, k=k, alpha=alpha)
    out, t_warm, t_batch = _timed_stream(sess, [queries, queries * 1.001])
    s, i = out[0]
    ctx.check(s.shape == (b, k) and np.all(np.isfinite(s)),
              "10M session returned non-finite scores")
    hits = float(np.mean(i[:, 0] == src))
    ctx.check(hits >= 0.99, f"10M session self-match {hits:.4f} < 0.99")
    stats = jax.devices()[0].memory_stats() or {}     # None on the CPU
    peak = stats.get("peak_bytes_in_use", -1)
    ctx.log("memory", rows=n, batch=b, lambda_s=t_lam, warmup_s=t_warm,
            batch_s=t_batch, self_match=hits,
            peak_bytes_in_use=peak, peak_gib=peak / 2**30,
            bytes_limit=stats.get("bytes_limit", -1))
    del sess, big, data
    return dict(peak_bytes=peak)


def phase_pruned(ctx: Ctx, index, n: int, centers: int, k: int,
                 alpha: float, n_batches: int, seed: int) -> float:
    """PrunedSearchSession(engine="device", B=16, auto_budget=True) over
    an n-row corpus of many small clusters (noise 0.03; the screen's
    deployment shape — a few huge clusters make every cell's bound
    reach the query and flag everything) with the built index's graph,
    on hot-region queries (rows of 16 clusters): every returned row
    equals the full-scan step's, except at full-scan gaps below 1e-6.
    Returns the flag rate."""
    import jax.numpy as jnp

    f = index.aspace.nfeatures
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (centers, f))
    assign = rng.integers(0, centers, n)
    rows = c[assign] + rng.normal(0, 0.03, (n, f))
    idx = _index_over(index, jnp.asarray(rows,
                                         dtype=index.aspace.data.dtype))
    t0 = time.perf_counter()
    sess = idx.make_pruned_session(batch_size=16, k=k, alpha=alpha,
                                   engine="device", auto_budget=True)
    t_cells = time.perf_counter() - t0
    sess.warmup()
    hot = np.nonzero(assign < 16)[0]
    pick = rng.choice(hot, 16 * n_batches, replace=len(hot) < 16 * n_batches)
    queries = rows[pick] * 1.002
    got_s, got_i = [], []
    t0 = time.perf_counter()
    for lo in range(0, queries.shape[0], 16):
        s, i = sess.search(queries[lo:lo + 16])
        got_s.append(s)
        got_i.append(i)
    t_search = (time.perf_counter() - t0) / n_batches
    got_i = np.concatenate(got_i)
    full_s, full_i = idx.search(queries, k=k, alpha=alpha)
    mismatched = 0
    for r in range(queries.shape[0]):
        for j in range(k):
            if got_i[r, j] == full_i[r, j]:
                continue
            near = [abs(full_s[r, j] - full_s[r, t]) for t in
                    (j - 1, j + 1) if 0 <= t < k]
            ctx.check(min(near + [np.inf]) < 1e-6,
                      f"pruned row {r} rank {j}: {got_i[r, j]} != "
                      f"{full_i[r, j]} (full-scan gap >= 1e-6)")
            mismatched += 1
    ctx.log("pruned", rows=n, clusters=centers, batch=16,
            queries=queries.shape[0], cells_build_s=t_cells,
            batch_s=t_search, flag_rate=sess.flag_rate,
            budget_growths=sess.budget_growths, m_cells=sess.m_cells,
            tie_swaps=mismatched)
    return sess.flag_rate


def phase_energy(ctx: Ctx, n: int, f: int, centers: int, batches, k: int,
                 n_check: int, seed: int) -> None:
    """1M x 64 energy index (the graph from a seeded 10%-of-rows build,
    λτ for every row on the device), EnergySearchSession at each batch
    size, against the f64 energy score."""
    import jax
    import jax.numpy as jnp

    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.energymaps import (EnergyParams, build_energy,
                                           energy_signals)
    from arrowspace_tpu.index import ArrowIndex
    rows = clustered_rows(n, f, centers, seed)
    t0 = time.perf_counter()
    b = (ArrowSpaceBuilder().with_seed(seed).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    aspace, gl = build_energy(b, rows[: max(n // 10, 200)],
                              EnergyParams(split_quantile=0.2,
                                           allow_tall_graphs=True))
    t_graph = time.perf_counter() - t0
    sub = ArrowIndex(aspace, gl, b)
    index = _index_over(sub, jnp.asarray(rows, dtype=aspace.data.dtype))
    jax.block_until_ready(index.aspace.lambdas)
    asp = index.aspace
    proj = asp.projection_matrix._host_matrix() \
        if asp.projection_matrix is not None else None
    r = proj.shape[1] if proj is not None else f
    sig, use_sig = energy_signals(asp, r, asp.data.dtype)
    sig = np.asarray(sig, np.float64)

    def z_of(x):
        xp = x[:, :proj.shape[0]] @ proj if proj is not None else x
        return xp @ sig.T if use_sig else xp

    lam_dev = np.asarray(asp.lambdas, np.float64)
    z = z_of(rows)
    ctx.log("energy", rows=n, features=f, graph_build_s=t_graph,
            z_width=z.shape[1], signals=use_sig,
            graph=gl.shape()[0])
    queries = noisy_queries(rows, max(batches), seed + 7, noise=0.05)
    qc = queries[:n_check]
    qp = qc[:, :proj.shape[0]] @ proj if proj is not None else qc
    qlam = ref_lambda(qp, np.asarray(gl.matrix, np.float64))
    ref_s, ref_i = ref_energy_topk(z_of(qc), qlam, z, lam_dev, 1.0, 0.5, k)
    for bsz in batches:
        sess = index.make_energy_session(batch_size=bsz, k=k,
                                         w_lambda=1.0, w_dirichlet=0.5)
        qs = queries[:bsz]
        out, t_warm, t_batch = _timed_stream(sess, [qs])
        s, i = out[0]
        res = check_topk(ctx, f"energy B={bsz}", s[:n_check], i[:n_check],
                         ref_s[:min(bsz, n_check)],
                         ref_i[:min(bsz, n_check)], tol=ENERGY_TOL,
                         gap=ENERGY_GAP)
        ctx.log("energy", batch=bsz, warmup_s=t_warm, batch_s=t_batch,
                **res)


def phase_live(ctx: Ctx, index, rows, cap: int, n_add: int, n_update: int,
               n_delete: int, b: int, k: int, alpha: float, n_check: int,
               seed: int) -> None:
    """Live session from the built index: add, update and delete, then
    search at B=b against the f64 reference over the live rows."""
    rng = np.random.default_rng(seed)
    n0, f = rows.shape
    lap = np.asarray(index.gl.matrix, np.float64)
    t0 = time.perf_counter()
    sess = index.make_live_session(batch_size=b, k=k, alpha=alpha,
                                   capacity=cap)
    sess.warmup()
    t_warm = time.perf_counter() - t0
    live_rows = {i: rows[i] for i in range(n0)}
    live_lam = dict(enumerate(np.asarray(index.aspace.lambdas, np.float64)))
    added = clustered_rows(n_add, f, 64, seed + 11)
    t0 = time.perf_counter()
    ids = sess.add(added)
    new_lam = ref_lambda(added, lap)
    for j, e in enumerate(ids):
        live_rows[int(e)], live_lam[int(e)] = added[j], new_lam[j]
    upd_ids = rng.choice(n0, n_update, replace=False)
    upd_rows = clustered_rows(n_update, f, 64, seed + 12)
    sess.update(upd_ids, upd_rows)
    upd_lam = ref_lambda(upd_rows, lap)
    for j, e in enumerate(upd_ids):
        live_rows[int(e)], live_lam[int(e)] = upd_rows[j], upd_lam[j]
    rest = np.setdiff1d(np.arange(n0), upd_ids)
    del_ids = np.concatenate([rng.choice(rest, n_delete - n_delete // 2,
                                         replace=False),
                              ids[: n_delete // 2]])
    sess.delete(del_ids)
    for e in del_ids:
        del live_rows[int(e)], live_lam[int(e)]
    t_mut = time.perf_counter() - t0
    ext = np.fromiter(live_rows.keys(), dtype=np.int64)
    x = np.stack([live_rows[int(e)] for e in ext])
    lam = np.fromiter((live_lam[int(e)] for e in ext), dtype=np.float64)
    queries = noisy_queries(x, b, seed + 13)
    t0 = time.perf_counter()
    s, i = sess.search(queries)
    t_search = time.perf_counter() - t0
    qc = queries[:n_check]
    ref_s, ref_pos = ref_lambda_topk(qc, ref_lambda(qc, lap), _unit(x), lam,
                                     alpha, k)
    res = check_topk(ctx, f"live B={b}", s[:n_check], i[:n_check], ref_s,
                     ext[ref_pos])
    ctx.check(sess.nitems == len(ext), "live count drifted")
    ctx.log("live", capacity=sess.capacity, live_rows=sess.nitems,
            added=n_add, updated=n_update, deleted=n_delete,
            warmup_s=t_warm, mutate_s=t_mut, search_s=t_search, **res)


def phase_mesh(ctx: Ctx, n: int, f: int, centers: int, b: int, k: int,
               alpha: float, n_check: int, n_lambda: int, seed: int,
               n_dev: int) -> None:
    """The sharded path over n_dev devices: distributed_build_step,
    DistributedSearchSession at B=b, distributed_pruned_topk and
    DistributedEnergySearchSession, against the f64 reference; each
    device holds 1/n_dev of the rows.  The corpus has many small
    clusters (noise 0.03), the shape the cell screen certifies on."""
    import jax
    import jax.numpy as jnp

    from arrowspace_tpu import clustering
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.graph import GraphParams
    from arrowspace_tpu.laplacian import build_laplacian_matrix
    from arrowspace_tpu.parallel import (DistributedEnergySearchSession,
                                         DistributedSearchSession,
                                         distributed_build_step,
                                         distributed_pruned_topk, make_mesh)
    from arrowspace_tpu.pruned import build_cells_device
    from arrowspace_tpu.taumode import TauMode

    mesh = make_mesh(n_dev)
    rows = clustered_rows(n, f, centers, seed, noise=0.03)
    queries = noisy_queries(rows, b, seed + 2)
    params = GraphParams(eps=1.0, k=6, topk=3, p=2.0, sigma=None,
                         normalise=False, sparsity_check=False)
    items = jnp.asarray(rows, dtype=jnp.float32)
    t0 = time.perf_counter()
    k_opt, radius, _ = clustering.compute_optimal_k(
        rows[: min(n, 65536)], min(n, 65536), f, seed)
    builder = ArrowSpaceBuilder()
    builder.sampling = None
    cent, lambdas, _, _ = distributed_build_step(
        items, builder, jnp.asarray(queries[:16], jnp.float32),
        TauMode.median(), params, k, mesh, max_clusters=k_opt,
        radius=radius)
    jax.block_until_ready(lambdas)
    t_build = time.perf_counter() - t0
    gl = build_laplacian_matrix(jnp.asarray(cent).T, params, n_items=n)
    lap = np.asarray(gl.matrix, np.float64)
    err = lambda_error(ctx, "mesh λτ", lambdas, rows, lap, n_lambda,
                       seed + 1)
    # each device holds a quarter of the rows: shards and memory
    from arrowspace_tpu.parallel.mesh import items_sharding
    items = jax.device_put(items, items_sharding(mesh))
    shards = items.addressable_shards
    ctx.check(len({s.device for s in shards}) == n_dev,
              "corpus shards do not span every device")
    ctx.check(all(s.data.shape == (n // n_dev, f) for s in shards),
              f"shard shapes {[s.data.shape for s in shards]}")
    stats = [d.memory_stats() for d in mesh.devices.flat]
    if mesh.devices.flat[0].platform == "cpu":
        in_use = "not measured (the CPU backend keeps no memory stats)"
    else:
        in_use = [st["bytes_in_use"] for st in stats]
        ctx.check(all(u >= n // n_dev * f * 4 for u in in_use),
                  f"per-device bytes_in_use {in_use} below a quarter "
                  f"of the corpus")
    ctx.log("mesh", devices=n_dev, rows=n, build_s=t_build,
            clusters=int(np.asarray(cent).shape[0]), lambda_max_err=err,
            shard_rows=[s.data.shape[0] for s in shards],
            bytes_in_use=in_use)

    lam_np = np.asarray(lambdas, np.float64)
    x_unit = _unit(rows)
    qc = queries[:n_check]
    qlam_ref = ref_lambda(qc, lap)
    ref_s, ref_i = ref_lambda_topk(qc, qlam_ref, x_unit, lam_np, alpha, k)
    sess = DistributedSearchSession(items, lambdas,
                                    jnp.asarray(lap, jnp.float32), mesh, b,
                                    k=k, alpha=alpha)
    out, t_warm, t_batch = _timed_stream(sess, [queries])
    s, i = out[0]
    res = check_topk(ctx, f"mesh session B={b}", s[:n_check], i[:n_check],
                     ref_s, ref_i)
    ctx.log("mesh", session_batch=b, warmup_s=t_warm, batch_s=t_batch,
            **res)

    t0 = time.perf_counter()
    cells = build_cells_device(items, lambdas, cap=256, seed=seed)
    t_cells = time.perf_counter() - t0
    qs16 = jnp.asarray(qc[:16], jnp.float32)
    ql16 = jnp.asarray(qlam_ref[:16], jnp.float32)
    ps, pi, pfl = distributed_pruned_topk(qs16, ql16, cells, alpha, k, mesh,
                                          m_cells=32)
    pfl = np.asarray(pfl)
    sub_s, sub_i = ref_s[:16], ref_i[:16]
    ok_rows = np.nonzero(~pfl)[0]
    res_p = check_topk(ctx, "mesh pruned", np.asarray(ps)[ok_rows],
                       np.asarray(pi)[ok_rows], sub_s[ok_rows],
                       sub_i[ok_rows]) if len(ok_rows) else {}
    ctx.log("mesh", pruned_batch=16, cells_build_s=t_cells,
            flagged=int(pfl.sum()), **res_p)

    esess = DistributedEnergySearchSession(
        items, lambdas, jnp.asarray(lap, jnp.float32), mesh, b, k=k,
        taumode=TauMode.median())
    out, t_warm, t_batch = _timed_stream(esess, [queries])
    es, ei = out[0]
    ref_es, ref_ei = ref_energy_topk(qc, qlam_ref, rows, lam_np, 1.0, 0.5,
                                     k)
    res_e = check_topk(ctx, f"mesh energy B={b}", es[:n_check],
                       ei[:n_check], ref_es, ref_ei, tol=ENERGY_TOL,
                       gap=ENERGY_GAP)
    ctx.log("mesh", energy_batch=b, warmup_s=t_warm, batch_s=t_batch,
            **res_e)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_single(ctx: Ctx, sz: dict, seed: int) -> None:
    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(ctx, *a, **kw)
        ctx.log("phase", name=name, seconds=time.perf_counter() - t0)
        return out

    index, rows, dup = timed("build", phase_build, sz["n"], sz["f"],
                             sz["centers"], sz["n_lambda"], seed)
    timed("serve", phase_serve, index, rows, dup, sz["b"], sz["k"],
          sz["alpha"], sz["n_check"], seed + 3)
    timed("routing", phase_routing, sz["route_n"], sz["f"], seed + 4)
    timed("memory", phase_memory, index, sz["mem_n"], sz["b"], sz["k"],
          sz["alpha"], seed + 5)
    timed("pruned", phase_pruned, index, sz["n"], sz["pruned_centers"],
          sz["k"], sz["alpha"], sz["pruned_batches"], seed + 6)
    timed("live", phase_live, index, rows, sz["live_cap"], sz["live_add"],
          sz["live_update"], sz["live_delete"], sz["b"], sz["k"],
          sz["alpha"], sz["n_check"], seed + 7)
    del index, rows
    timed("wide", phase_wide, sz["wide_n"], sz["wide_f"], sz["centers"],
          sz["b"], sz["k"], sz["alpha"], sz["n_check"], sz["wide_lambda"],
          seed + 8)
    timed("energy", phase_energy, sz["energy_n"], sz["energy_f"],
          sz["centers"], sz["energy_b"], sz["k"], sz["n_check"], seed + 9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path over four cards")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform}); "
              "this script never runs on the CPU", file=sys.stderr)
        return 2
    if args.gpus > len(devs):
        print(f"chip_smoke: --gpus {args.gpus} but JAX sees {len(devs)}",
              file=sys.stderr)
        return 2

    from arrowspace_tpu.config import setup_cache
    setup_cache()
    ctx = Ctx(card_label())
    print(card_label(), flush=True)
    ctx.log("device", platform=devs[0].platform, kind=devs[0].device_kind,
            count=len(devs), jax=jax.__version__)
    t0 = time.perf_counter()
    phase_setup(ctx)
    if args.gpus == 4:
        sz = FULL
        phase_mesh(ctx, sz["mesh_n"], sz["f"], sz["pruned_centers"],
                   sz["b"], sz["k"], sz["alpha"], sz["n_check"],
                   sz["n_lambda"], args.seed, 4)
    else:
        run_single(ctx, FULL, args.seed)
    ctx.log("total", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": args.gpus if args.gpus == 4 else len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
