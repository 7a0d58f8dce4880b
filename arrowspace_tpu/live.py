"""Live serving sessions: zero-recompile add / update / delete.

The reference's ArrowSpace is mutable — set_item + λ maintenance
(core.rs:614-727) — but every other serving surface (SearchSession,
EnergySearchSession, the distributed session) freezes the corpus at
construction.  This module closes that gap: the corpus lives on device
in a CAPACITY-padded buffer and the true row count rides to the scoring
step as data (the XLA step masks positions >= n_live), so mutations are
row writes + a host counter — no retrace, no recompile, serving stays
hot.

Mechanics (shared by the cosine/λ and energy sessions):

* capacity is rounded up to a coarse row bucket (config.bucket_rows), so
  nearby capacities share one compiled program.
* ``add`` ingests raw rows: projection (if the index was built with one),
  τ selection and synthetic λ run in ONE jitted program with donated
  buffers, then the rows scatter into position.  λ semantics are exactly
  the index's query/item preparation pipeline against the frozen build
  graph — identical to what core.ArrowSpace._refresh_lambda_row assigns
  after set_item (pinned by tests), and the same trade the reference
  makes: item edits never rebuild the graph (core.rs:644 recomputes λ
  against the existing Laplacian).  Periodic ``to_index()`` + rebuild
  refreshes the graph.
* ``delete`` is swap-with-last: tail survivors move into the holes (one
  gather+scatter), the live count shrinks.  Device positions therefore
  change — results map device positions to stable EXTERNAL ids through a
  host-side table, which is what every production vector store exposes
  anyway.
* All mutation index vectors are padded to power-of-two buckets
  (_pad_bucket) — a device op sized by a raw mutation count would
  compile once per novel count.  Pad entries repeat a real (index, row)
  pair, so duplicate scatter writes carry identical values and the
  result is deterministic.

Searches interleaved with mutations see a consistent snapshot: each
dispatch reads the live count at submit time.  Mutating while a
``search_stream`` has batches in flight applies to subsequent batches;
deleting concurrently with an in-flight stream is not supported (the id
table is read at yield time).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Optional, Tuple

import numpy as np

from .taumode import prepare_lambdas
from .utils.log import get_logger

logger = get_logger("arrowspace.live")

__all__ = ["LiveSearchSession", "LiveEnergySearchSession"]

_LIVE_STEP = None
_LIVE_ENERGY_STEP = None
_INGEST = None
_ENERGY_INGEST = None
_MOVE = None


def _live_step_jit():
    """Module-level jitted live serving step (lazy) — the dynamic-count
    analogue of index._session_step_jit: same fused query-λ preparation,
    but the corpus row count is a traced operand (n_live) so one
    executable serves every mutation state within capacity."""
    global _LIVE_STEP
    if _LIVE_STEP is None:
        import jax
        import jax.numpy as jnp

        @functools.partial(
            jax.jit, static_argnames=("taumode", "alpha", "k", "has_proj",
                                      "pad_tall", "use_bf16"))
        def step(q_raw, data, lambdas, lap, proj, n_live, *, taumode,
                 alpha, k, has_proj, pad_tall, use_bf16):
            from .ops.search import lambda_topk
            _, qlam = prepare_lambdas(q_raw, lap, proj, taumode,
                                      has_proj=has_proj, pad_tall=pad_tall)
            return lambda_topk(
                q_raw, qlam, data, lambdas,
                jnp.asarray(alpha, dtype=q_raw.dtype), k=k, n_live=n_live,
                use_bf16=use_bf16)

        _LIVE_STEP = step
    return _LIVE_STEP


def _live_energy_step_jit():
    """Energy analogue of _live_step_jit (mirrors index._energy_step_jit
    with a traced n_live): fused query-λ prep + z projection + energy
    scoring over the live prefix of a capacity-padded z corpus."""
    global _LIVE_ENERGY_STEP
    if _LIVE_ENERGY_STEP is None:
        import jax

        @functools.partial(
            jax.jit, static_argnames=("taumode", "k", "has_proj",
                                      "has_signals", "pad_tall"))
        def step(q_raw, z_items, item_lambdas, lap, proj, signals, wl,
                 wd, n_live, *, taumode, k, has_proj, has_signals,
                 pad_tall):
            from .energymaps import energy_query_z, energy_topk
            q_prep, qlam = prepare_lambdas(q_raw, lap, proj, taumode,
                                           has_proj=has_proj,
                                           pad_tall=pad_tall)
            z_q = energy_query_z(q_prep, signals, has_signals)
            return energy_topk(z_q, qlam, z_items, item_lambdas, wl, wd,
                               k=k, n_live=n_live)

        _LIVE_ENERGY_STEP = step
    return _LIVE_ENERGY_STEP


def _ingest_jit():
    """One jitted program per ingest geometry: project → τ → synthetic λ
    (the exact query/item preparation pipeline) + scatter into the
    donated capacity buffers.  Buffers are donated so XLA updates them
    in place instead of copying the corpus per mutation."""
    global _INGEST
    if _INGEST is None:
        import jax

        @functools.partial(
            jax.jit, static_argnames=("taumode", "has_proj", "pad_tall"),
            donate_argnums=(2, 3))
        def ingest(rows, pos, raw, lam, lap, proj, *, taumode, has_proj,
                   pad_tall):
            r = rows.astype(raw.dtype)
            _, new_lam = prepare_lambdas(r, lap, proj, taumode,
                                         has_proj=has_proj,
                                         pad_tall=pad_tall)
            return (raw.at[pos].set(r),
                    lam.at[pos].set(new_lam.astype(lam.dtype)))

        _INGEST = ingest
    return _INGEST


def _energy_ingest_jit():
    """Energy ingest: project → τ → λ → z-space transform, then scatter
    into the donated (z, λ) capacity buffers."""
    global _ENERGY_INGEST
    if _ENERGY_INGEST is None:
        import jax

        @functools.partial(
            jax.jit,
            static_argnames=("taumode", "has_proj", "has_signals",
                             "pad_tall"),
            donate_argnums=(2, 3))
        def ingest(rows, pos, z, lam, lap, proj, signals, *,
                   taumode, has_proj, has_signals, pad_tall):
            from .energymaps import energy_query_z
            r = rows.astype(z.dtype)
            q_prep, new_lam = prepare_lambdas(r, lap, proj, taumode,
                                              has_proj=has_proj,
                                              pad_tall=pad_tall)
            z_new = energy_query_z(q_prep, signals, has_signals)
            return (z.at[pos].set(z_new),
                    lam.at[pos].set(new_lam.astype(lam.dtype)))

        _ENERGY_INGEST = ingest
    return _ENERGY_INGEST


def _move_jit():
    """Swap-with-last compaction for deletes: gather the tail survivors
    at src and scatter them into the holes at dst (disjoint sets, one
    donated in-place program).  Works on any tuple of row-indexed
    arrays (2-D or 1-D)."""
    global _MOVE
    if _MOVE is None:
        import jax

        @functools.partial(jax.jit, donate_argnums=(0,))
        def move(arrays, src, dst):
            return tuple(a.at[dst].set(a[src]) for a in arrays)

        _MOVE = move
    return _MOVE


def _pad_bucket(arr: np.ndarray) -> np.ndarray:
    """Pad axis 0 to a power-of-two bucket by REPEATING the last real
    entry (duplicate scatter writes then carry identical values — safe
    in any scatter order).  The bucket keeps one compiled program per
    power of two instead of one per novel mutation count."""
    m = arr.shape[0]
    b = 1 << max(0, int(m - 1).bit_length())
    if b == m:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], b - m, axis=0)],
                          axis=0)


class _LiveBase:
    """Shared live-session machinery: the stable-external-id table,
    bucketed mutation bookkeeping, and the generic search/stream/warmup
    drivers.  Subclasses provide the device state: _ingest_rows(rows,
    positions), _row_arrays() (the tuple compacted on delete),
    _grow_arrays(pad), plus _step."""

    MAX_MUTATION_BLOCK = 4096

    def _init_ids(self, n0: int, cap_pad: int) -> None:
        self.capacity = cap_pad        # bucket headroom is usable space
        self._n = n0
        self._ids = np.full(cap_pad, -1, dtype=np.int64)
        self._ids[:n0] = np.arange(n0)
        self._pos = {int(i): int(i) for i in range(n0)}
        self._next_id = n0

    @property
    def nitems(self) -> int:
        return self._n

    def _check_k_vs_live(self) -> None:
        # user-reachable state (deletes legitimately shrink n below k):
        # a masked top_k would return -inf rows mapping through _ids to
        # stale/-1 external ids silently, so raise — not assert
        if self.k > self._n:
            raise ValueError(
                f"k={self.k} exceeds the live corpus size {self._n}; "
                f"add rows (or rebuild the session with a smaller k)")

    def _position_of(self, ext_id) -> int:
        try:
            return self._pos[int(ext_id)]
        except KeyError:
            raise KeyError(
                f"unknown or deleted external id {int(ext_id)}") from None

    # -- mutation -------------------------------------------------------
    def add(self, rows) -> np.ndarray:
        """Ingest new vectors; returns their external ids (int64).
        λ is assigned by the standard preparation pipeline against the
        frozen build graph (see module docstring)."""
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float64))
        m = rows.shape[0]
        if m == 0:
            return np.empty((0,), dtype=np.int64)
        if rows.shape[1] != self._dim:
            raise ValueError(
                f"rows have {rows.shape[1]} features, index has {self._dim}")
        if self._n + m > self.capacity:
            raise ValueError(
                f"live corpus full: {self._n} + {m} > capacity "
                f"{self.capacity}; construct the session with a larger "
                f"capacity= (or grow(), which recompiles)")
        positions = np.arange(self._n, self._n + m)
        self._ingest_blocks(rows, positions)
        ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
        self._ids[positions] = ids
        for i, p in zip(ids, positions):
            self._pos[int(i)] = int(p)
        self._next_id += m
        self._n += m
        return ids

    def update(self, ids, rows) -> None:
        """Overwrite existing vectors in place; λ is refreshed exactly
        like core.ArrowSpace.set_item + _refresh_lambda_row (pinned by
        tests/test_live.py)."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float64))
        if len(ids) != rows.shape[0]:
            raise ValueError(
                f"update(): {len(ids)} ids but {rows.shape[0]} rows")
        if len(np.unique(ids)) != len(ids):
            # duplicate ids would scatter different values to the SAME
            # position; XLA's .at[pos].set order for duplicates is
            # implementation-defined, so the surviving row would be
            # nondeterministic — refuse instead of guessing intent
            uniq, counts = np.unique(ids, return_counts=True)
            dupes = uniq[counts > 1]
            raise ValueError(
                f"update(): duplicate external ids {dupes[:8]}"
                f" — deduplicate on the caller side (keep the intended "
                f"occurrence) before dispatch")
        positions = np.array([self._position_of(i) for i in ids])
        self._ingest_blocks(rows, positions)

    def delete(self, ids) -> None:
        """Remove vectors by external id (swap-with-last compaction —
        one gather+scatter regardless of where the holes are)."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        doomed = sorted({self._position_of(i) for i in ids})
        m = len(doomed)
        if m == 0:
            return
        n_new = self._n - m
        doomed_set = set(doomed)
        holes = [p for p in doomed if p < n_new]
        survivors = [p for p in range(n_new, self._n)
                     if p not in doomed_set]
        assert len(holes) == len(survivors), (holes, survivors)
        if holes:
            import jax.numpy as jnp
            src = jnp.asarray(_pad_bucket(
                np.asarray(survivors, dtype=np.int32)))
            dst = jnp.asarray(_pad_bucket(
                np.asarray(holes, dtype=np.int32)))
            self._set_row_arrays(_move_jit()(self._row_arrays(), src, dst))
            for s, d in zip(survivors, holes):
                moved = self._ids[s]
                self._ids[d] = moved
                self._pos[int(moved)] = d
        for i in ids:
            self._pos.pop(int(i), None)
        self._ids[n_new:self._n] = -1
        self._n = n_new

    def _ingest_blocks(self, rows: np.ndarray,
                       positions: np.ndarray) -> None:
        for lo in range(0, len(positions), self.MAX_MUTATION_BLOCK):
            hi = min(lo + self.MAX_MUTATION_BLOCK, len(positions))
            self._ingest_rows(
                _pad_bucket(np.asarray(rows[lo:hi], dtype=np.float64)),
                _pad_bucket(positions[lo:hi].astype(np.int32)))

    def grow(self, new_capacity: int) -> None:
        """Reallocate to a larger capacity bucket.  Changes program
        shapes — the next dispatch recompiles (unless the bucket is
        already in the persistent cache); prefer sizing capacity up
        front."""
        cap_pad = _capacity_pad(new_capacity)
        if cap_pad <= self.capacity:
            return
        pad = cap_pad - self.capacity
        self._grow_arrays(pad)
        self._ids = np.concatenate(
            [self._ids, np.full(pad, -1, dtype=np.int64)])
        logger.info("live session grown %d -> %d rows", self.capacity,
                    cap_pad)
        self.capacity = cap_pad

    # -- search ---------------------------------------------------------
    def warmup(self, mutation_buckets=(1, 2)) -> None:
        """Compile the serving step AND the mutation programs so
        production serving and mutations are dispatch-only.

        ``mutation_buckets`` lists the power-of-two ingest block sizes to
        pre-compile — each novel bucket otherwise pays one XLA compile on
        the first production mutation of that size.  The default covers
        1- and 2-row mutations plus one COMPACTING delete (a multi-row
        block whose first row is deleted leaves a hole a tail survivor
        must fill, which compiles the swap-with-last move program).
        Pass the buckets your ingest pipeline actually uses (e.g.
        ``(1, 2, 4, ..., 4096)`` for arbitrary block sizes); buckets that
        do not fit the remaining capacity are skipped."""
        from .index import warm_step
        warm_step(self._step, self.batch_size, self._dim, self._dt)
        for b in sorted({int(x) for x in mutation_buckets}):
            if b < 1 or self._n + b > self.capacity:
                continue
            pid = self.add(np.zeros((b, self._dim)))
            # first-of-block delete exercises _move_jit when b > 1
            self.delete(pid[:1])
            if b > 1:
                self.delete(pid[1:])

    def search(self, queries) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous batched search over the CURRENT live rows:
        (B, F) -> (scores (B, k), external ids (B, k) int64)."""
        from .index import stream_search
        self._check_k_vs_live()
        # no f64 intermediate: stream_search host-casts to the session
        # dtype, so widening here would only double the upload
        queries = np.atleast_2d(np.asarray(queries))
        out = []
        for lo in range(0, queries.shape[0], self.batch_size):
            qb = queries[lo:lo + self.batch_size]
            out.append(next(iter(stream_search(
                self._step, [qb], self.batch_size, 1, self._dt,
                dim=self._dim, async_fetch=False))))
        s = np.concatenate([o[0] for o in out], axis=0)
        i = np.concatenate([o[1] for o in out], axis=0)
        return s, self._ids[i]

    def search_stream(self, batches: Iterable
                      ) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
        """Pipelined streaming search (see index.stream_search); yields
        (scores, external ids) per batch.  Mutations between batches
        apply to subsequent dispatches; the id table is read at yield
        time, so do not DELETE concurrently with an in-flight stream."""
        from .index import stream_search
        self._check_k_vs_live()
        for s, i in stream_search(self._step, batches, self.batch_size,
                                  self.depth, self._dt, dim=self._dim):
            yield s, self._ids[i]


class LiveSearchSession(_LiveBase):
    """Serving session over a capacity-padded live corpus (λ-aware
    cosine scoring, the canonical search mode).

    Built from an ArrowIndex snapshot; ``add`` / ``update`` / ``delete``
    mutate the device corpus with zero recompiles (see module docstring)
    and searches always score the current live rows.  Results carry
    stable EXTERNAL ids (int64): the initial rows get ids 0..n-1 (their
    index positions), ``add`` returns freshly assigned ids.

    ``capacity`` bounds the live row count; it is rounded up to a coarse
    row bucket (so intermediate sizes are free) and defaults to the
    index size's own bucket — which already carries up to 25% headroom.
    ``grow()`` reallocates to a larger capacity but changes program
    shapes (a fresh compile; size capacity for the deployment's ceiling
    up front instead).  precision as in index.SearchSession.
    """

    def __init__(self, index, batch_size: int, k: int = 10,
                 alpha: float = 0.9, depth: int = 2,
                 precision: str = "f32",
                 capacity: Optional[int] = None):
        import jax.numpy as jnp

        from .index import _check_precision

        use_bf16 = _check_precision(precision)
        aspace, gl = index.aspace, index.gl
        n0 = index.nitems
        cap = max(int(capacity or n0), n0)
        self.batch_size = int(batch_size)
        # clamp k against CAPACITY, not the initial corpus size — the
        # live corpus is designed to grow, and a session seeded from a
        # small index must not silently serve n0 results forever; the
        # search-time k<=n_live guard covers a temporarily small count
        self.k = min(int(k), cap)
        self.depth = max(1, int(depth))
        self.alpha = float(alpha)

        dt = aspace.data.dtype
        self._dt = dt
        self._dim = aspace.nfeatures
        self._lap = jnp.asarray(gl.matrix, dtype=dt)
        self._has_proj = aspace.projection_matrix is not None
        self._proj = aspace.projection_matrix.matrix(dtype=dt) \
            if self._has_proj else jnp.zeros((1, 1), dtype=dt)
        self._taumode = aspace.taumode
        self._pad_tall = aspace.pad_tall_graphs
        self._aspace, self._gl = aspace, gl

        cap_pad = _capacity_pad(cap)
        self._init_ids(n0, cap_pad)

        # capacity-padded device state
        pad = cap_pad - n0
        self._raw = jnp.pad(aspace.data.astype(dt), ((0, pad), (0, 0)))
        self._lam = jnp.pad(aspace.lambdas.astype(dt), (0, pad))

        jitted = _live_step_jit()
        self._step = lambda q: jitted(
            q, self._raw, self._lam, self._lap, self._proj,
            jnp.asarray(self._n, dtype=jnp.int32),
            taumode=self._taumode, alpha=self.alpha, k=self.k,
            has_proj=self._has_proj, pad_tall=self._pad_tall,
            use_bf16=use_bf16)

    def _ingest_rows(self, rows: np.ndarray, pos: np.ndarray) -> None:
        import jax.numpy as jnp
        self._raw, self._lam = _ingest_jit()(
            jnp.asarray(rows, dtype=self._dt), jnp.asarray(pos),
            self._raw, self._lam, self._lap, self._proj,
            taumode=self._taumode, has_proj=self._has_proj,
            pad_tall=self._pad_tall)

    def _row_arrays(self):
        return (self._raw, self._lam)

    def _set_row_arrays(self, arrays) -> None:
        self._raw, self._lam = arrays

    def _grow_arrays(self, pad: int) -> None:
        import jax.numpy as jnp
        self._raw = jnp.pad(self._raw, ((0, pad), (0, 0)))
        self._lam = jnp.pad(self._lam, (0, pad))

    # -- snapshot ---------------------------------------------------------
    def to_index(self):
        """Materialise the live corpus as a regular ArrowIndex (for
        persistence via ArrowIndex.save, or a full graph rebuild).
        Returns (index, external_ids (n,) int64): row j of the snapshot
        is the live vector whose stable id is external_ids[j]."""
        import copy

        import jax
        import jax.numpy as jnp

        from .index import ArrowIndex
        rows, lams = jax.device_get(
            (self._raw[:self._n], self._lam[:self._n]))
        aspace = dataclasses.replace(
            self._aspace,
            nitems=self._n,
            data=jnp.asarray(rows),
            lambdas=jnp.asarray(lams),
            host_rows=np.asarray(rows, dtype=np.float64),
            _projected_cache=None,
        )
        aspace._lambda_order = None
        gl = copy.copy(self._gl)
        gl.nnodes = self._n     # the reference's nnodes==nitems quirk
        return (ArrowIndex(aspace, gl),
                self._ids[:self._n].copy())


class LiveEnergySearchSession(_LiveBase):
    """Energy-index counterpart of LiveSearchSession: the z-space corpus
    (energymaps._energy_z_items) lives in a capacity-padded buffer;
    mutations maintain (z, λ) and the energy step masks against the
    traced live count.  search_energy semantics preserved per
    energymaps.rs:368-407.

    No ``to_index`` snapshot: an energy index's persistent form needs
    the original optical-compression state (energymaps.build_energy
    artifacts), not the z-plane — rebuild from source data instead.
    """

    def __init__(self, index, batch_size: int, k: int = 10,
                 w_lambda: float = 1.0, w_dirichlet: float = 0.5,
                 depth: int = 2, capacity: Optional[int] = None):
        import jax.numpy as jnp

        from .energymaps import _energy_z_items, energy_signals

        aspace, gl = index.aspace, index.gl
        n0 = index.nitems
        cap = max(int(capacity or n0), n0)
        self.batch_size = int(batch_size)
        # clamp against capacity (see LiveSearchSession.__init__)
        self.k = min(int(k), cap)
        self.depth = max(1, int(depth))

        dt = aspace.data.dtype
        self._dt = dt
        self._dim = aspace.nfeatures
        self._lap = jnp.asarray(gl.matrix, dtype=dt)
        self._has_proj = aspace.projection_matrix is not None
        self._proj = aspace.projection_matrix.matrix(dtype=dt) \
            if self._has_proj else jnp.zeros((1, 1), dtype=dt)
        self._taumode = aspace.taumode
        self._pad_tall = aspace.pad_tall_graphs

        items_proj = aspace.projected_items()
        self._signals, self._has_signals = energy_signals(
            aspace, items_proj.shape[1], dt)
        z_items = _energy_z_items(aspace, items_proj, self._signals,
                                  self._has_signals)
        self._wl = jnp.asarray(w_lambda, dtype=dt)
        self._wd = jnp.asarray(w_dirichlet, dtype=dt)

        cap_pad = _capacity_pad(cap)
        self._init_ids(n0, cap_pad)

        pad = cap_pad - n0
        self._z = jnp.pad(z_items.astype(dt), ((0, pad), (0, 0)))
        self._lam = jnp.pad(aspace.lambdas.astype(dt), (0, pad))

        jitted = _live_energy_step_jit()
        self._step = lambda q: jitted(
            q, self._z, self._lam, self._lap, self._proj, self._signals,
            self._wl, self._wd, jnp.asarray(self._n, dtype=jnp.int32),
            taumode=self._taumode, k=self.k, has_proj=self._has_proj,
            has_signals=self._has_signals, pad_tall=self._pad_tall)

    def _ingest_rows(self, rows: np.ndarray, pos: np.ndarray) -> None:
        import jax.numpy as jnp
        self._z, self._lam = _energy_ingest_jit()(
            jnp.asarray(rows, dtype=self._dt), jnp.asarray(pos),
            self._z, self._lam, self._lap, self._proj, self._signals,
            taumode=self._taumode, has_proj=self._has_proj,
            has_signals=self._has_signals, pad_tall=self._pad_tall)

    def _row_arrays(self):
        return (self._z, self._lam)

    def _set_row_arrays(self, arrays) -> None:
        self._z, self._lam = arrays

    def _grow_arrays(self, pad: int) -> None:
        import jax.numpy as jnp
        self._z = jnp.pad(self._z, ((0, pad), (0, 0)))
        self._lam = jnp.pad(self._lam, (0, pad))


def _capacity_pad(cap: int) -> int:
    """Capacity rounded up to its coarse row bucket (config.bucket_rows)."""
    from .config import bucket_rows
    return max(bucket_rows(cap), 8)
