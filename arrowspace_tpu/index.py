"""ArrowIndex: a serving-grade facade over the build/persist/query cycle.

The reference exposes builder + ArrowSpace + storage as separate pieces;
this facade composes them the way a production deployment uses them:

    index = ArrowIndex.build(rows, eps=1e-3, k=6, seed=42)
    index.save("/ckpt", "prod")
    ...
    index = ArrowIndex.load("/ckpt", "prod")
    scores, ids = index.search(queries, k=10, alpha=0.9)   # batched
    hits = index.range(lo, hi)                             # O(log N + M)

Everything device-side is batched: query λ preparation is one fused
program, and scoring + top-k is the one XLA λ-aware step
(ops.search.lambda_topk), which scans large corpora in row chunks.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, List, Optional, Tuple

import numpy as np

from .builder import ArrowSpaceBuilder
from .core import ArrowItem, ArrowSpace
from .graph import GraphLaplacian
from .sampling import SamplerType
from .taumode import TauMode
from .utils.log import get_logger

logger = get_logger("arrowspace.index")

__all__ = ["ArrowIndex", "SearchSession", "EnergySearchSession"]


_SESSION_STEP = None


def _session_step_jit():
    """Module-level jitted serving step (lazy).  One program fuses query-λ
    preparation with scoring + top-k; statics carry the session config so
    (a) every SearchSession with the same config shares one executable and
    (b) precompile.py can AOT-lower it by shape alone.

    Returns (scores (B, k), ids (B, k) int32)."""
    global _SESSION_STEP
    if _SESSION_STEP is None:
        import functools
        import jax
        import jax.numpy as jnp

        @functools.partial(
            jax.jit, static_argnames=("taumode", "alpha", "k", "has_proj",
                                      "pad_tall", "use_bf16"))
        def step(q_raw, data, lambdas, lap, proj, *, taumode, alpha, k,
                 has_proj, pad_tall, use_bf16=False):
            from .ops.search import lambda_topk
            from .taumode import prepare_lambdas
            _, qlam = prepare_lambdas(q_raw, lap, proj, taumode,
                                      has_proj=has_proj, pad_tall=pad_tall)
            return lambda_topk(q_raw, qlam, data, lambdas,
                               jnp.asarray(alpha, dtype=q_raw.dtype), k=k,
                               use_bf16=use_bf16)

        _SESSION_STEP = step
    return _SESSION_STEP


_ENERGY_STEP = None


def _energy_step_jit():
    """Module-level jitted ENERGY serving step (lazy) — the energy-index
    counterpart of _session_step_jit: one program fuses query-λ
    preparation (projection, τ selection, synthetic λ against the energy
    laplacian) with the z-space projection and energy scoring + top-k
    (search_energy semantics, energymaps.rs:368-407).

    Returns (scores (B, k), ids (B, k) int32)."""
    global _ENERGY_STEP
    if _ENERGY_STEP is None:
        import functools
        import jax
        import jax.numpy as jnp

        @functools.partial(
            jax.jit, static_argnames=("taumode", "k", "has_proj",
                                      "has_signals", "pad_tall"))
        def step(q_raw, z_items, item_lambdas, lap, proj, signals, wl, wd,
                 *, taumode, k, has_proj, has_signals, pad_tall):
            from .energymaps import energy_query_z, energy_topk
            from .taumode import prepare_lambdas
            q_prep, qlam = prepare_lambdas(q_raw, lap, proj, taumode,
                                           has_proj=has_proj,
                                           pad_tall=pad_tall)
            z_q = energy_query_z(q_prep, signals, has_signals)
            return energy_topk(z_q, qlam, z_items, item_lambdas, wl, wd,
                               k=k)

        _ENERGY_STEP = step
    return _ENERGY_STEP


def stream_search(step, batches, batch_size: int, depth: int, dt,
                  dim=None, async_fetch: bool = True):
    """Shared pipelined stream driver (used by every session): yield
    (scores, ids) per input batch with `depth` batches in flight —
    dispatch batch i+1 before fetching batch i's results.  Partial
    batches (e.g. a stream tail) are padded to batch_size so the
    compiled step is never retraced mid-stream; their results are sliced
    back on the host.

    async_fetch moves the device_get onto a fetch thread, so the main
    loop's query uploads overlap result downloads instead of
    serialising with them; yield order is preserved by the pending
    queue."""
    import jax
    import jax.numpy as jnp
    from concurrent.futures import ThreadPoolExecutor

    def finish(out, m):
        s, i = jax.device_get(out)
        return s[:m], i[:m]

    executor = ThreadPoolExecutor(max_workers=1) if async_fetch else None
    try:
        pending = deque()
        for qb in batches:
            # cast to the session dtype on the HOST: a raw f64 batch would
            # otherwise upload at double width and compile a device-side
            # convert on the first production search (np and XLA round
            # f64->f32 identically, so scores are unchanged)
            qb = np.ascontiguousarray(qb, dtype=np.dtype(dt))
            nq = qb.shape[0]
            if dim is not None and qb.shape[1] != dim:
                raise ValueError(
                    f"query batch has {qb.shape[1]} features but the "
                    f"session index has {dim}")
            if nq != batch_size:
                assert nq < batch_size, (
                    f"batch of {nq} exceeds the session batch_size "
                    f"{batch_size}")
                qb = np.pad(qb, ((0, batch_size - nq), (0, 0)),
                            constant_values=1.0)
            out = step(jnp.asarray(qb, dtype=dt))  # async dispatch
            if executor is not None:
                pending.append(executor.submit(finish, out, nq))
            else:
                pending.append((out, nq))
            if len(pending) > depth:
                item = pending.popleft()
                yield item.result() if executor is not None \
                    else finish(*item)
        while pending:
            item = pending.popleft()
            yield item.result() if executor is not None else finish(*item)
    finally:
        if executor is not None:
            executor.shutdown(wait=False)


def warm_step(step, batch_size: int, dim: int, dt) -> None:
    """Compile a session step so serving latency is dispatch-only: one
    full-batch pass through the PRODUCTION stream driver compiles every
    program of the serving path exactly as a real search runs it (host
    upload, step, result fetch)."""
    list(stream_search(step, [np.ones((batch_size, dim))], batch_size,
                       1, dt, dim=dim, async_fetch=False))


def _check_precision(precision: str) -> bool:
    """Session precision -> use_bf16 (bf16 operands, f32 accumulation)."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unsupported session precision {precision!r}")
    return precision == "bf16"


class SearchSession:
    """Compiled, pipelined streaming search for serving.

    One jitted program fuses query-λ preparation (projection, τ selection,
    synthetic λ) with scoring + top-k, so a batch costs ONE dispatch.  The
    stream driver keeps `depth` batches in flight: while batch i's results
    return to the host, batch i+1 is already computing — the reference's
    per-query scan (core.rs:760-798) has no pipelining to mirror.

    precision="f32" scores at Precision.HIGHEST; "bf16" casts the score
    matmul's operands to bf16 and accumulates in f32.
    """

    def __init__(self, index: "ArrowIndex", batch_size: int, k: int = 10,
                 alpha: float = 0.9, depth: int = 2,
                 precision: str = "f32"):
        import jax.numpy as jnp

        use_bf16 = _check_precision(precision)
        self.batch_size = int(batch_size)
        self.k = min(int(k), index.nitems)
        self.depth = max(1, int(depth))
        aspace, gl = index.aspace, index.gl

        dt = aspace.data.dtype
        self._dt = dt
        data, lambdas = aspace.data, aspace.lambdas
        lap = jnp.asarray(gl.matrix, dtype=dt)
        has_proj = aspace.projection_matrix is not None
        proj = aspace.projection_matrix.matrix(dtype=dt) if has_proj \
            else jnp.zeros((1, 1), dtype=dt)
        # The corpus arrays are ARGUMENTS, not closure captures: jit would
        # otherwise embed them as HLO constants in the executable.
        jitted = _session_step_jit()
        self._step = lambda q: jitted(
            q, data, lambdas, lap, proj, taumode=aspace.taumode,
            alpha=float(alpha), k=self.k, has_proj=has_proj,
            pad_tall=aspace.pad_tall_graphs, use_bf16=use_bf16)
        self._dim = aspace.nfeatures

    def warmup(self) -> None:
        """Compile the step program so serving latency is dispatch-only."""
        warm_step(self._step, self.batch_size, self._dim, self._dt)

    def search_stream(self, batches: Iterable) -> Iterable[Tuple[np.ndarray,
                                                                 np.ndarray]]:
        """Yield (scores, ids) per input batch, keeping `depth` batches in
        flight — see stream_search (shared with the multi-chip session)."""
        return stream_search(self._step, batches, self.batch_size,
                             self.depth, self._dt, dim=self._dim)


class EnergySearchSession:
    """Compiled, pipelined streaming ENERGY search for serving.

    The energy-index counterpart of SearchSession: one jitted program
    fuses query-λ preparation with the z-space projection and energy
    scoring + top-k (search_energy_batch semantics,
    energymaps.rs:368-407), so a batch costs ONE dispatch; the shared
    stream driver keeps `depth` batches in flight."""

    def __init__(self, index: "ArrowIndex", batch_size: int, k: int = 10,
                 w_lambda: float = 1.0, w_dirichlet: float = 0.5,
                 depth: int = 2):
        import jax.numpy as jnp

        from .energymaps import _energy_z_items, energy_signals

        self.batch_size = int(batch_size)
        self.k = min(int(k), index.nitems)
        self.depth = max(1, int(depth))
        aspace, gl = index.aspace, index.gl

        dt = aspace.data.dtype
        self._dt = dt
        self._dim = aspace.nfeatures
        lap = jnp.asarray(gl.matrix, dtype=dt)
        has_proj = aspace.projection_matrix is not None
        proj = aspace.projection_matrix.matrix(dtype=dt) if has_proj \
            else jnp.zeros((1, 1), dtype=dt)
        items_proj = aspace.projected_items()
        signals, use_signals = energy_signals(aspace, items_proj.shape[1],
                                              dt)
        z_items = _energy_z_items(aspace, items_proj, signals, use_signals)
        lambdas = aspace.lambdas
        wl = jnp.asarray(w_lambda, dtype=dt)
        wd = jnp.asarray(w_dirichlet, dtype=dt)

        # corpus arrays are ARGUMENTS, not closure captures (see
        # SearchSession)
        jitted = _energy_step_jit()
        self._step = lambda q: jitted(
            q, z_items, lambdas, lap, proj, signals, wl, wd,
            taumode=aspace.taumode, k=self.k, has_proj=has_proj,
            has_signals=use_signals, pad_tall=aspace.pad_tall_graphs)

    def warmup(self) -> None:
        """Compile the step program so serving latency is dispatch-only."""
        warm_step(self._step, self.batch_size, self._dim, self._dt)

    def search_stream(self, batches: Iterable) -> Iterable[Tuple[np.ndarray,
                                                                 np.ndarray]]:
        """Yield (scores, ids) per input batch, keeping `depth` batches in
        flight — see stream_search (shared with SearchSession)."""
        return stream_search(self._step, batches, self.batch_size,
                             self.depth, self._dt, dim=self._dim)


class ArrowIndex:
    """Built index = ArrowSpace + GraphLaplacian + builder config."""

    def __init__(self, aspace: ArrowSpace, gl: GraphLaplacian,
                 builder: Optional[ArrowSpaceBuilder] = None):
        self.aspace = aspace
        self.gl = gl
        self.builder = builder

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, rows, *, eps: float = 1e-3, k: int = 6, topk: int = 3,
              p: float = 2.0, sigma: Optional[float] = None,
              taumode: TauMode = TauMode.median(),
              normalise: bool = False,
              sampling: Optional[SamplerType] = SamplerType.simple(0.6),
              dims_reduction: bool = False,
              rp_eps: Optional[float] = None,
              seed: Optional[int] = None,
              spectral: bool = False) -> "ArrowIndex":
        b = (ArrowSpaceBuilder()
             .with_lambda_graph(eps, k, topk, p, sigma)
             .with_synthesis(taumode)
             .with_normalisation(normalise)
             .with_inline_sampling(sampling)
             .with_dims_reduction(dims_reduction, rp_eps))
        if spectral:
            b = b.with_spectral(True)
        if seed is not None:
            b = b.with_seed(seed)
        aspace, gl = b.build(rows)
        return cls(aspace, gl, b)

    @classmethod
    def build_energy(cls, rows, energy_params=None, *,
                     seed: Optional[int] = None,
                     **kwargs) -> "ArrowIndex":
        from .energymaps import EnergyParams, build_energy
        b = ArrowSpaceBuilder().with_dims_reduction(True, kwargs.get(
            "rp_eps", 0.5))
        if "eps" in kwargs:
            b = b.with_lambda_graph(kwargs["eps"], kwargs.get("k", 6),
                                    kwargs.get("topk", 3),
                                    kwargs.get("p", 2.0),
                                    kwargs.get("sigma"))
        if seed is not None:
            b = b.with_seed(seed)
        aspace, gl = build_energy(b, rows,
                                  energy_params or EnergyParams())
        return cls(aspace, gl, b)

    # ------------------------------------------------------------------
    def _synthesize_builder(self) -> ArrowSpaceBuilder:
        """Builder config reconstructed from live index state, used when
        no builder was attached (always the case for loaded indexes).
        Persisting defaults instead would silently change query-lambda
        preparation on load->save->load round trips."""
        b = ArrowSpaceBuilder()
        b.synthesis = self.aspace.taumode
        gp = getattr(self.gl, "graph_params", None)
        if gp is not None:
            b.with_lambda_graph(gp.eps, gp.k, gp.topk, gp.p, gp.sigma)
            b.normalise = gp.normalise
            b.sparsity_check = gp.sparsity_check
        b.use_dims_reduction = self.aspace.projection_matrix is not None
        b.prebuilt_spectral = (self.aspace.signals is not None
                               and self.aspace.signals.shape[0] > 0)
        b.cluster_max_clusters = self.aspace.n_clusters or None
        b.cluster_radius = self.aspace.cluster_radius or 1.0
        return b

    def save(self, path, name: str) -> None:
        """Persist via the builder's Parquet artifacts so the reference's
        tooling can read them back too."""
        from .storage import parquet as pq
        import pathlib
        base = pathlib.Path(path)
        base.mkdir(parents=True, exist_ok=True)
        b = self.builder or self._synthesize_builder()
        pq.save_dense_matrix_with_builder(
            np.asarray(self.aspace.data, dtype=np.float64), base,
            f"{name}-raw_input", b)
        pq.save_dense_matrix_with_builder(
            np.asarray(self.gl.init_data, dtype=np.float64).T, base,
            f"{name}-laplacian-input", b)
        pq.save_sparse_matrix_with_builder(
            self.gl.matrix, base, f"{name}-gl-matrix", b,
            structural_nnz=self.gl.structural_nnz)
        pq.save_lambda_with_builder(
            np.asarray(self.aspace.lambdas, dtype=np.float64), base,
            f"{name}-lambdas", b, projection=self.aspace.projection_matrix)
        if self.aspace.signals is not None and \
                self.aspace.signals.shape[0] > 0:
            pq.save_sparse_matrix_with_builder(
                self.aspace.signals, base, f"{name}-aspace-signals", b)
        logger.info("index saved to %s as '%s'", base, name)

    @classmethod
    def load(cls, path, name: str) -> "ArrowIndex":
        from .storage import parquet as pq
        aspace, gl = pq.load_arrowspace_index(path, name)
        return cls(aspace, gl)

    # ------------------------------------------------------------------
    def search(self, queries, k: int = 10, alpha: float = 0.9,
               precision: str = "f32",
               rescore_pool: Optional[int] = None):
        """Batched λ-aware search: (B, F) -> (scores (B, k), ids (B, k)).
        Query λ preparation is fused; scoring is the one XLA λ-aware step
        (f32 at Precision.HIGHEST).

        precision="bf16" runs the cosine matmul with bf16 operands and f32
        accumulation (half the corpus bytes per product; returned scores
        differ in the 3rd decimal).

        precision="f64_rescore" re-ranks a device candidate pool against
        the original f64 rows on the host, recovering exact f64 tie
        ordering among near-duplicate cosines (the clustered-data regime
        where plain f32 recall@10 drops to ~0.96).  rescore_pool sizes
        the pool (default max(4k, k+32)); corpora with heavy
        near-duplication need a pool of roughly the duplicate
        multiplicity — if more rows tie within f32 resolution than the
        pool holds, the f64 top-k may not be in the pool at all
        (measured: 25-base x 4000-copy replicated 384-d embeddings need
        a ~4096 pool; the default suffices for distinct rows)."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float64))
        qlam = self.aspace.prepare_query_items_batch(queries, self.gl)
        if precision == "f64_rescore":
            from .ops.search import rescore_topk_f64
            if self.aspace.host_rows is None:
                raise ValueError(
                    "f64_rescore needs the original f64 rows; they were "
                    "invalidated by an in-place device mutation")
            m = min(rescore_pool or max(4 * k, k + 32),
                    self.aspace.nitems)
            _s, cand = self.aspace.search_lambda_aware_batch(
                queries, np.asarray(qlam), m, alpha)
            return rescore_topk_f64(
                queries, np.asarray(qlam), self.aspace.host_rows,
                np.asarray(self.aspace.lambdas), alpha, np.asarray(cand),
                min(k, self.aspace.nitems))
        use_bf16 = _check_precision(precision)
        scores, ids = self.aspace.search_lambda_aware_batch(
            queries, np.asarray(qlam), k, alpha, use_bf16=use_bf16)
        return np.asarray(scores), np.asarray(ids)

    def search_one(self, query, k: int = 10, alpha: float = 0.9
                   ) -> List[Tuple[int, float]]:
        qlam = self.aspace.prepare_query_item(query, self.gl)
        return self.aspace.search_lambda_aware(ArrowItem(query, qlam), k,
                                               alpha)

    def search_hybrid(self, query, k: int = 10, alpha: float = 0.9
                      ) -> List[Tuple[int, float]]:
        qlam = self.aspace.prepare_query_item(query, self.gl)
        return self.aspace.search_lambda_aware_hybrid(
            ArrowItem(query, qlam), k, alpha)

    def range(self, lo: float, hi: float,
              limit: Optional[int] = None) -> List[Tuple[int, float]]:
        """Two-sided λ-band via the sorted index (O(log N + M))."""
        return self.aspace.range_search_sorted(lo, hi, limit)

    def search_energy(self, queries, k: int = 10, w_lambda: float = 1.0,
                      w_dirichlet: float = 0.5):
        """Batched energy-only ranking (for indices built with
        build_energy): (B, F) -> (scores, ids)."""
        from .energymaps import search_energy_batch
        return search_energy_batch(self.aspace, queries, self.gl, k,
                                   w_lambda, w_dirichlet)

    def make_search_session(self, batch_size: int, k: int = 10,
                            alpha: float = 0.9, depth: int = 2,
                            precision: str = "f32") -> SearchSession:
        """Compiled streaming search for serving: one fused
        prep+score+top-k program per batch, `depth` batches in flight.
        precision="bf16" scores the matmul with bf16 operands and f32
        accumulation (see SearchSession)."""
        return SearchSession(self, batch_size, k=k, alpha=alpha, depth=depth,
                             precision=precision)

    def make_pruned_session(self, batch_size: int = 16, k: int = 10,
                            alpha: float = 0.9, cap: int = 256,
                            m_cells: Optional[int] = None,
                            margin: float = 1e-3, seed: int = 0,
                            m_vote: int = 8,
                            union_cells: Optional[int] = None,
                            auto_budget: bool = False,
                            engine: str = "host",
                            n_clusters: Optional[int] = None,
                            lloyd_sample: Optional[int] = None):
        """Exact cell-screened search (pruned.py): queries exact-score
        only the cells whose score upper bound can reach their top-k;
        un-certifiable queries transparently re-run through the full
        scan.  The latency counterpart of make_search_session — B ≤ 16
        gathers per query, B in (16, 512] shares one two-level cell
        UNION per batch (m_vote votes/query, union_cells gathered);
        device work ∝ scanned cells instead of N on clustered
        corpora.  auto_budget=True grows the screening budget when the
        observed flag rate exceeds 5% (see PrunedSearchSession).
        engine="device" builds the cell layout fully on device
        (build_cells_device — the multi-GB-corpus path); n_clusters /
        lloyd_sample tune the Lloyd pass at large N (oversample
        n_clusters 2-4x the expected cluster count — see the
        provisioning rule in build_cells's docstring)."""
        from .pruned import PrunedSearchSession
        return PrunedSearchSession(self, batch_size, k=k, alpha=alpha,
                                   cap=cap, m_cells=m_cells,
                                   margin=margin, seed=seed,
                                   m_vote=m_vote, union_cells=union_cells,
                                   auto_budget=auto_budget,
                                   engine=engine, n_clusters=n_clusters,
                                   lloyd_sample=lloyd_sample)

    def make_live_session(self, batch_size: int, k: int = 10,
                          alpha: float = 0.9, depth: int = 2,
                          precision: str = "f32",
                          capacity: Optional[int] = None):
        """Serving session with zero-recompile add/update/delete: the
        corpus lives in a capacity-padded device buffer and the true row
        count rides to the kernels as data (live.LiveSearchSession).
        Results carry stable external ids."""
        from .live import LiveSearchSession
        return LiveSearchSession(self, batch_size, k=k, alpha=alpha,
                                 depth=depth, precision=precision,
                                 capacity=capacity)

    def make_live_energy_session(self, batch_size: int, k: int = 10,
                                 w_lambda: float = 1.0,
                                 w_dirichlet: float = 0.5,
                                 depth: int = 2,
                                 capacity: Optional[int] = None):
        """Energy-index live session: add/update/delete with zero
        recompiles over the capacity-padded z corpus
        (live.LiveEnergySearchSession)."""
        from .live import LiveEnergySearchSession
        return LiveEnergySearchSession(self, batch_size, k=k,
                                       w_lambda=w_lambda,
                                       w_dirichlet=w_dirichlet,
                                       depth=depth, capacity=capacity)

    def make_energy_session(self, batch_size: int, k: int = 10,
                            w_lambda: float = 1.0, w_dirichlet: float = 0.5,
                            depth: int = 2) -> EnergySearchSession:
        """Compiled streaming ENERGY search for serving (indices built
        with build_energy): one fused prep+z-project+score+top-k program
        per batch, `depth` batches in flight."""
        return EnergySearchSession(self, batch_size, k=k,
                                   w_lambda=w_lambda,
                                   w_dirichlet=w_dirichlet, depth=depth)

    def warmup(self, batch_sizes=(1, 16, 256), k: int = 10,
               alpha: float = 0.9) -> None:
        """Pre-compile the search programs for the given batch sizes so
        first-query latency in serving is dispatch-only."""
        rng = np.random.default_rng(0)
        for b in batch_sizes:
            q = rng.uniform(0.1, 1.0, (b, self.aspace.nfeatures))
            self.search(q, k=min(k, self.nitems), alpha=alpha)
        logger.info("warmup complete for batch sizes %s", batch_sizes)

    # ------------------------------------------------------------------
    @property
    def lambdas(self) -> np.ndarray:
        return np.asarray(self.aspace.lambdas)

    @property
    def nitems(self) -> int:
        return self.aspace.nitems

    def stats(self) -> dict:
        lam = self.lambdas
        gstats = self.gl.statistics()
        return {
            "n_items": self.aspace.nitems,
            "n_features": self.aspace.nfeatures,
            "n_clusters": self.aspace.n_clusters,
            "graph_nodes": self.gl.shape()[0],
            "graph_nnz": self.gl.nnz(),
            "graph_sparsity": gstats.sparsity,
            "lambda_min": float(lam.min()),
            "lambda_max": float(lam.max()),
            "lambda_mean": float(lam.mean()),
            "lambda_std": float(lam.std()),
        }
