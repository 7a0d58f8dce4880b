"""Distributed λτ build and query over a sharded corpus.

Design (SURVEY.md §2):
- the graph matrix is tiny (F′×F′) and replicated on every device;
- the N-items axis is sharded; the λτ batch is embarrassingly data-parallel
  (each shard runs the same fused matmuls on its rows — no collectives);
- query scoring is data-parallel over item shards: every shard runs the
  one XLA λ-aware step (ops.search.lambda_topk) on its rows, and the top-k
  merge is an ``all_gather`` of the k·D candidates and a final top-k — a
  1:1 mapping of the reference's per-thread-heap fold/reduce
  (core.rs:818-888) onto collectives.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.search import lambda_topk
from ..taumode import (TauMode, prepare_lambdas, select_tau_batch,
                       synthetic_lambda_batch)
from .mesh import ITEMS_AXIS, items_sharding, replicated_sharding
from .multiprocess import ensure_global, is_multiprocess, put_global

__all__ = ["sharded_compute_taumode_lambdas",
           "distributed_lambda_aware_topk", "distributed_pruned_topk",
           "distributed_index_step",
           "sharded_incremental_clustering", "distributed_build_step",
           "DistributedSearchSession", "DistributedEnergySearchSession"]


def sharded_compute_taumode_lambdas(
    items: jax.Array,          # (N, F) — will be sharded over the mesh
    laplacian: jax.Array,      # (n, n) — replicated
    taumode: TauMode,
    mesh: Mesh,
) -> jax.Array:
    """λτ batch with the items axis sharded across the mesh.  XLA sees
    replicated small matmul operands and a sharded N axis; no collectives
    are inserted in the forward pass."""
    items = ensure_global(items, items_sharding(mesh))
    laplacian = put_global(laplacian, replicated_sharding(mesh))

    @functools.partial(jax.jit, static_argnames=("mode",),
                       out_shardings=items_sharding(mesh, ndim=1))
    def _run(x, lap, *, mode):
        taus = select_tau_batch(x, mode)
        return synthetic_lambda_batch(x, lap, taus)

    return _run(items, laplacian, mode=taumode)


def _merge_shards(local_scores, local_idx, shard_n: int, k: int):
    """Globalise shard-local indices and merge every shard's candidates:
    all_gather along the items axis (shard order = global index order,
    so lax.top_k's lower-position tie rule keeps the lowest global
    index) and a final top-k.  Runs inside shard_map."""
    gidx = local_idx + jax.lax.axis_index(ITEMS_AXIS) * shard_n
    all_scores = jax.lax.all_gather(local_scores, ITEMS_AXIS, axis=1,
                                    tiled=True)
    all_idx = jax.lax.all_gather(gidx, ITEMS_AXIS, axis=1, tiled=True)
    top_scores, pos = jax.lax.top_k(all_scores, k)
    return top_scores, jnp.take_along_axis(all_idx, pos, axis=1)


def distributed_lambda_aware_topk(
    queries: jax.Array,        # (B, F) — replicated
    query_lambdas: jax.Array,  # (B,)
    items: jax.Array,          # (N, F) — sharded over mesh
    item_lambdas: jax.Array,   # (N,)  — sharded over mesh
    alpha,
    k: int,
    mesh: Mesh,
):
    """Per-shard top-k + all_gather merge (the heap-merge analogue).
    Each shard runs ops.search.lambda_topk on its rows.  Returns
    (scores (B, k), global indices (B, k))."""
    n = items.shape[0]
    n_dev = mesh.devices.size
    assert n % n_dev == 0, (
        f"N={n} must be padded to a multiple of the mesh size {n_dev}")
    shard_n = n // n_dev
    k_local = min(k, shard_n)

    queries = put_global(queries, replicated_sharding(mesh))
    query_lambdas = put_global(query_lambdas, replicated_sharding(mesh))
    items = ensure_global(items, items_sharding(mesh))
    item_lambdas = ensure_global(item_lambdas,
                                 items_sharding(mesh, ndim=1))
    alpha = put_global(np.asarray(alpha, dtype=np.dtype(items.dtype)),
                       replicated_sharding(mesh))

    def _shard_fn(q, qlam, x, xlam, a):
        ls, li = lambda_topk(q, qlam, x, xlam, a, k=k_local)
        return _merge_shards(ls, li, shard_n, min(k, n))

    fn = shard_map(
        _shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(ITEMS_AXIS, None), P(ITEMS_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)(queries, query_lambdas, items, item_lambdas, alpha)


def distributed_lambda_aware_topk_2d(
    queries: jax.Array,
    query_lambdas: jax.Array,
    items: jax.Array,          # (N, F) — sharded over BOTH mesh axes
    item_lambdas: jax.Array,
    alpha,
    k: int,
    mesh: Mesh,
) -> Tuple[jax.Array, jax.Array]:
    """Hierarchical top-k merge over a 2-D ("dcn", "ici") mesh, for
    multi-host meshes whose outer axis spans hosts.

    Stage 1: per-device top-k (ops.search.lambda_topk).
    Stage 2: all_gather + re-top-k WITHIN each inner ("ici") group.
    Stage 3: all_gather the per-group winners ACROSS the outer ("dcn")
             axis — only k candidates per group cross it — and take the
             final top-k.
    """
    n = items.shape[0]
    n_dcn, n_ici = mesh.devices.shape
    n_dev = n_dcn * n_ici
    assert n % n_dev == 0, (
        f"N={n} must be padded to a multiple of the mesh size {n_dev}")
    shard_n = n // n_dev
    k_local = min(k, shard_n)

    spec_items = P(("dcn", "ici"), None)
    spec_lam = P(("dcn", "ici"))
    queries = put_global(queries, NamedSharding(mesh, P()))
    query_lambdas = put_global(query_lambdas, NamedSharding(mesh, P()))
    items = ensure_global(items, NamedSharding(mesh, spec_items))
    item_lambdas = ensure_global(item_lambdas,
                                 NamedSharding(mesh, spec_lam))
    alpha = put_global(np.asarray(alpha, dtype=np.dtype(items.dtype)),
                       NamedSharding(mesh, P()))

    def _shard_fn(q, qlam, x, xlam, a):
        local_scores, local_idx = lambda_topk(q, qlam, x, xlam, a,
                                              k=k_local)
        dcn_id = jax.lax.axis_index("dcn")
        ici_id = jax.lax.axis_index("ici")
        shard_id = dcn_id * n_ici + ici_id
        gidx = local_idx + shard_id * shard_n

        # inner-group merge
        s_ici = jax.lax.all_gather(local_scores, "ici", axis=1, tiled=True)
        i_ici = jax.lax.all_gather(gidx, "ici", axis=1, tiled=True)
        k_grp = min(k, s_ici.shape[1])
        s_grp, pos = jax.lax.top_k(s_ici, k_grp)
        i_grp = jnp.take_along_axis(i_ici, pos, axis=1)

        # outer merge: only k_grp candidates per group cross the outer axis
        s_all = jax.lax.all_gather(s_grp, "dcn", axis=1, tiled=True)
        i_all = jax.lax.all_gather(i_grp, "dcn", axis=1, tiled=True)
        top_scores, pos = jax.lax.top_k(s_all, min(k, n))
        top_idx = jnp.take_along_axis(i_all, pos, axis=1)
        return top_scores, top_idx

    fn = shard_map(
        _shard_fn, mesh=mesh,
        in_specs=(P(), P(), spec_items, spec_lam, P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)(queries, query_lambdas, items, item_lambdas, alpha)


def distributed_pruned_topk(
    queries: jax.Array,        # (B, F) — replicated
    query_lambdas: jax.Array,  # (B,)
    cells,                     # PrunedCells — unit axis sharded
    alpha,
    k: int,
    mesh: Mesh,
    m_cells: int = 8,
    margin: float = 1e-3,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Cell-screened exact top-k over the mesh: each shard screens its
    own slice of the cell layout (pruned.pruned_topk on the local
    units) and the per-shard winners merge with a two-key (score,
    global-id) sort, so cross-shard exact ties still resolve to the
    lowest GLOBAL id like the single-device screen.

    Soundness of per-shard certification: the merged global k-th score
    dominates every shard-local k-th (the k largest of a union are
    element-wise ≥ the k largest of any subset), so a shard's
    certificate — "no unscanned LOCAL cell's bound reaches my local
    k-th" — implies no unscanned cell anywhere reaches the global
    k-th.  Flags reduce by any-shard OR; a flagged query re-runs
    through the distributed full scan, exactly the single-chip
    flag/fallback contract.  Per-shard m_cells means the mesh scans
    n_dev·m_cells cells total — strictly MORE coverage than the
    single-chip screen at equal per-chip latency.

    This is the 100M-config serving shape (SURVEY §2 long-axis row):
    per device the gather stays ∝ m_cells·cap while a full scan pays the
    whole per-shard corpus read.

    Returns (scores (B, k), global ids (B, k), flags (B,)).
    Reference anchor: core.rs:802-928 (hybrid's per-thread heaps +
    merge, made exact and cell-screened)."""
    from ..pruned import pruned_topk

    u_pad = cells.cent.shape[0]
    n_dev = mesh.devices.size
    assert u_pad % n_dev == 0, (
        f"unit axis {u_pad} must be a multiple of the mesh size "
        f"{n_dev} (pruned._unit_pad pads to pow2/1024-multiples, both "
        f"divisible by typical mesh sizes)")
    cap = cells.cap
    dt = cells.x.dtype

    rep = replicated_sharding(mesh)
    rows_spec = NamedSharding(mesh, P(ITEMS_AXIS, None))
    vec_spec = NamedSharding(mesh, P(ITEMS_AXIS))
    queries = put_global(queries.astype(dt), rep)
    query_lambdas = put_global(query_lambdas.astype(dt), rep)
    alpha_g = put_global(np.asarray(alpha, dtype=np.dtype(dt)), rep)
    cx = ensure_global(cells.x, rows_spec)
    clam = ensure_global(cells.lam, vec_spec)
    cids = ensure_global(cells.ids, vec_spec)
    cent = ensure_global(cells.cent, rows_spec)
    radius = ensure_global(cells.radius, vec_spec)
    cosr = ensure_global(cells.cosr, vec_spec)
    sinr = ensure_global(cells.sinr, vec_spec)
    lam_lo = ensure_global(cells.lam_lo, vec_spec)
    lam_hi = ensure_global(cells.lam_hi, vec_spec)

    def _shard_fn(q, qlam, x, lam, ids, ce, ra, co, si, lo, hi, a):
        # per-shard screen, exporting the best-unscanned-cell bound:
        # certification MUST ride the merged GLOBAL k-th — a
        # shard-local k-th is too weak on shards that don't hold the
        # query's hot region (their local candidates score low, so
        # every unscanned local bound reaches the local k-th and the
        # whole batch would flag; measured exactly so on the first cut)
        s, i, nb = pruned_topk(
            q, qlam, x, lam, ids, ce, ra, co, si, lo, hi, a, k=k,
            m_cells=m_cells, cap=cap, margin=margin,
            return_next_bound=True)
        # ids are GLOBAL row ids stored in the layout — no shard offset
        nb_max = jax.lax.pmax(nb, ITEMS_AXIS)           # (B,) shifted
        all_s = jax.lax.all_gather(s, ITEMS_AXIS, axis=1, tiled=True)
        all_i = jax.lax.all_gather(i, ITEMS_AXIS, axis=1, tiled=True)
        # lowest-global-id tie order across shards: -inf pads from
        # underfilled shards sort last either way
        s_sorted, i_sorted = jax.lax.sort((-all_s, all_i), num_keys=2)
        top_s, top_i = -s_sorted[:, :k], i_sorted[:, :k]
        c1 = 1.0 - a.astype(top_s.dtype)
        kth_shifted = top_s[:, k - 1] - c1              # back to plane
        fl = (nb_max + jnp.asarray(margin, top_s.dtype) >= kth_shifted) \
            | ~jnp.isfinite(kth_shifted)
        return top_s, top_i, fl

    fn = shard_map(
        _shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(ITEMS_AXIS, None), P(ITEMS_AXIS),
                  P(ITEMS_AXIS), P(ITEMS_AXIS, None), P(ITEMS_AXIS),
                  P(ITEMS_AXIS), P(ITEMS_AXIS), P(ITEMS_AXIS),
                  P(ITEMS_AXIS), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)(queries, query_lambdas, cx, clam, cids, cent,
                       radius, cosr, sinr, lam_lo, lam_hi, alpha_g)


def sharded_incremental_clustering(
    items_sharded: jax.Array,   # (N, F) sharded over the mesh items axis
    builder,
    max_clusters: int,
    radius: float,
    sampler,
    mesh: Mesh,
    rounds_chunk: int = 65536,  # rows per device per round
):
    """Sharded unseeded incremental clustering: the build-stage scan over
    a mesh-sharded corpus (SURVEY §2, "sharding the N-items axis ... for
    build").

    Each round, EVERY device computes nearest-centroid distances for its
    next `rounds_chunk` rows against the round-start snapshot — one
    shard_map with no collectives — and the host applies the per-row
    create/assign/soft-outlier rules chunk by chunk in device order.
    This is the same snapshot relaxation as the single-chip chunked mode
    (clustering.py), with a race window of n_devices chunks per round —
    still a valid serialisation of the reference's racy rayon semantics
    (clustering.rs:570-660).

    The corpus stays device-resident throughout: the host fetches one
    chunk's rows at a time for the create/assign bookkeeping (peak host
    memory O(chunk x F), total transfer one pass of the data), so the
    100M x 768 sharded config never materialises ~600 GB on the host.

    Returns (centroids (X, F) host f64, assignments list, sizes list).
    """
    import numpy as np

    from ..clustering import _bucket_centroid_cap

    n, f = items_sharded.shape
    n_dev = mesh.devices.size
    assert n % n_dev == 0, (
        f"N={n} must be padded to a multiple of the mesh size {n_dev}")
    shard_n = n // n_dev
    chunk = min(rounds_chunk, shard_n)
    dt = items_sharded.dtype
    np_dt = np.dtype(dt)
    mc_pad = _bucket_centroid_cap(max_clusters)
    # Under multi-process the host bookkeeping below consumes these
    # results on EVERY process, but a host can only fetch addressable
    # shards — so the per-chunk vectors (n_dev·chunk ints/floats, tiny
    # next to the corpus) are all_gathered to replicated outputs.
    mp = is_multiprocess()

    def _dist_shard(x_shard, start, cent_pad, n_c):
        rows_c = jax.lax.dynamic_slice(
            x_shard, (start[0], jnp.zeros((), start.dtype)), (chunk, f))
        d2 = (jnp.sum(rows_c * rows_c, axis=1)[:, None]
              - 2.0 * jnp.dot(rows_c, cent_pad.T,
                              preferred_element_type=dt,
                              precision=jax.lax.Precision.HIGHEST)
              + jnp.sum(cent_pad * cent_pad, axis=1)[None, :])
        d2 = jnp.maximum(d2, 0.0)
        valid = jnp.arange(cent_pad.shape[0]) < n_c[0]
        d2 = jnp.where(valid[None, :], d2, jnp.inf)
        best = jnp.argmin(d2, axis=1).astype(jnp.int32)
        bd = jnp.take_along_axis(d2, best[:, None].astype(jnp.int32),
                                 axis=1)[:, 0]
        if mp:
            best = jax.lax.all_gather(best, ITEMS_AXIS, axis=0,
                                      tiled=True)
            bd = jax.lax.all_gather(bd, ITEMS_AXIS, axis=0, tiled=True)
        return best, bd

    dist_fn = jax.jit(shard_map(
        _dist_shard, mesh=mesh,
        in_specs=(P(ITEMS_AXIS, None), P(), P(), P()),
        out_specs=(P(), P()) if mp else (P(ITEMS_AXIS), P(ITEMS_AXIS)),
        check_vma=False,
    ))

    # Host bookkeeping state (identical rules to clustering.py's chunked
    # mode, reused via its helpers).  The corpus is NEVER materialised on
    # host in full — at the 100M x 768 target that would be ~600 GB.
    # Host row traffic is limited to (a) the bootstrap block scan and
    # (b) the few CREATOR rows per chunk (lazy fetch_at): the
    # running-mean reduction and the fresh-centroid refresh run as
    # SHARD-LOCAL SPMD programs (each shard slices its OWN window; the
    # segsum merges via a tiny (cap, F) psum) — a jit(dynamic_slice)
    # over the mesh-sharded corpus would make SPMD insert conservative
    # cross-shard gathers per call, i.e. corpus allgathers in the build
    # hot loop.
    from ..clustering import _apply_chunk_decisions

    # One compiled fetch program per window LENGTH (runtime offset via
    # dynamic_slice): python slicing would bake each distinct offset into
    # its own program — 8-16 fresh compiles per build.
    fetch_cache = {}
    rep_out = replicated_sharding(mesh) if mp else None

    def fetch_rows(lo: int, hi: int) -> np.ndarray:
        m = hi - lo
        if m not in fetch_cache:
            fetch_cache[m] = jax.jit(
                lambda arr, start, _m=m: jax.lax.dynamic_slice(
                    arr, (start, jnp.zeros((), start.dtype)), (_m, f)),
                out_shardings=rep_out)
        out = fetch_cache[m](items_sharded, np.int32(min(lo, n - m)))
        return np.asarray(out, dtype=np.float64)

    # Creator-row gather, bucketed by candidate count so one compiled
    # program serves a range of creator counts (indices padded by
    # repetition; the padded tail is sliced off host-side).
    gather_cache = {}

    def fetch_rows_at(global_idx: np.ndarray) -> np.ndarray:
        cnt = int(global_idx.shape[0])
        bucket = 8
        while bucket < cnt:
            bucket *= 2
        if bucket not in gather_cache:
            gather_cache[bucket] = jax.jit(
                lambda arr, idx: jnp.take(arr, idx, axis=0),
                out_shardings=rep_out)
        idx_pad = np.full(bucket, int(global_idx[0]), dtype=np.int32)
        idx_pad[:cnt] = global_idx
        out = gather_cache[bucket](items_sharded, idx_pad)
        return np.asarray(out, dtype=np.float64)[:cnt]

    # Shard-local grouped sums: every shard reduces ITS window's rows
    # keyed by the (replicated) targets, masked to the active device;
    # the psum of the small (cap, F) partials leaves exactly the active
    # shard's contribution.  One program serves the whole build.
    def _seg_shard(x_shard, start, tgt_pad, d_active):
        rows_c = jax.lax.dynamic_slice(
            x_shard, (start[0], jnp.zeros((), start[0].dtype)), (chunk, f))
        active = jax.lax.axis_index(ITEMS_AXIS) == d_active[0]
        t = jnp.where(active, tgt_pad, -1)
        valid = t >= 0
        tt = jnp.where(valid, t, mc_pad)
        sums = jnp.zeros((mc_pad + 1, f), dtype=dt).at[tt].add(
            jnp.where(valid[:, None], rows_c, 0.0))
        cnts = jnp.zeros((mc_pad + 1,), dtype=jnp.int32).at[tt].add(
            valid.astype(jnp.int32))
        return (jax.lax.psum(sums[:mc_pad], ITEMS_AXIS),
                jax.lax.psum(cnts[:mc_pad], ITEMS_AXIS))

    seg_fn = jax.jit(shard_map(
        _seg_shard, mesh=mesh,
        in_specs=(P(ITEMS_AXIS, None), P(), P(), P()),
        out_specs=(P(), P()), check_vma=False))

    cent = np.zeros((max_clusters, f), dtype=np.float64)
    counts = np.zeros(max_clusters, dtype=np.int64)
    assign = np.full(n, -1, dtype=np.int64)
    state = {"n_c": 0}

    # bootstrap centroid 0 from the first kept row (host scan over small
    # fetched blocks; with any realistic keep-rate this is one block)
    sampling_enabled = builder.sampling is not None
    boot = 0
    for b0 in range(0, n, 1024):
        block = fetch_rows(b0, min(b0 + 1024, n))
        for j in range(block.shape[0]):
            kept = (not sampling_enabled) or sampler.should_keep(
                block[j], float("inf"), 0, max_clusters)
            boot = b0 + j + 1
            if kept:
                cent[0] = block[j]
                counts[0] = 1
                assign[b0 + j] = 0
                state["n_c"] = 1
                break
        if state["n_c"]:
            break
    if state["n_c"] == 0:
        raise RuntimeError("No clusters created from data (all rows "
                           "rejected by sampling)")

    for start in range(0, shard_n, chunk):
        # m < chunk on a partial final round: dynamic_slice clamps the
        # device window to [shard_n - chunk, shard_n), so the wanted rows
        # [start, shard_n) are the LAST m entries of each shard's result.
        m = min(chunk, shard_n - start)
        cent_host = np.zeros((mc_pad, f))
        cent_host[:max_clusters] = cent
        # small operands upload as HOST numpy values: identical on every
        # process, so they are valid replicated inputs under
        # multi-process (a committed single-device jnp array is not)
        cent_pad = np.asarray(cent_host, dtype=np_dt)
        round_start_nc = state["n_c"]
        best_all, bd_all = dist_fn(
            items_sharded,
            np.asarray([start], dtype=np.int32),
            cent_pad, np.asarray([state["n_c"]], dtype=np.int32))
        best_all, bd_all = jax.device_get((best_all, bd_all))
        best_all = best_all.astype(np.int64)
        bd_all = np.asarray(bd_all, dtype=np.float64)
        # device-order serialisation: apply each shard's chunk in turn
        for d in range(n_dev):
            offset = d * shard_n + start
            lo, hi = d * chunk + (chunk - m), (d + 1) * chunk
            sl = slice(0, m)
            if offset + m > boot > offset:
                # rows consumed by the bootstrap scan are already decided
                sl = slice(boot - offset, m)
            elif offset + m <= boot:
                continue
            best_c = best_all[lo:hi][sl].copy()
            bd_c = bd_all[lo:hi][sl].copy()
            offs = offset + sl.start
            m_eff = m - sl.start
            # rows [offs, offs+m_eff) sit at positions
            # [(chunk-m)+sl.start, chunk) of shard d's clamped window —
            # the same tail convention as the round's dist_fn results
            p0 = (chunk - m) + sl.start
            # Refresh against centroids created by EARLIER chunks of
            # this round (the device distances only saw the round-start
            # snapshot) — reuses the round's SPMD distance program with
            # the fresh centroids in the bucketed buffer (every shard
            # computes its own window; the host reads shard d's
            # segment).  Keeps the cross-device race window from
            # duplicating clusters round-wide without fetching rows.
            if state["n_c"] > round_start_nc and bd_c.size:
                n_fresh = state["n_c"] - round_start_nc
                fresh_pad = np.zeros((mc_pad, f))
                fresh_pad[:n_fresh] = cent[round_start_nc:state["n_c"]]
                fb, fd = dist_fn(
                    items_sharded, np.asarray([start], dtype=np.int32),
                    np.asarray(fresh_pad, dtype=np_dt),
                    np.asarray([n_fresh], dtype=np.int32))
                seg = slice(d * chunk + p0, d * chunk + p0 + m_eff)
                fbest, fbd = jax.device_get((fb[seg], fd[seg]))
                fbest = fbest.astype(np.int64)
                fbd = np.asarray(fbd, dtype=np.float64)
                closer = fbd < bd_c
                best_c = np.where(closer, fbest + round_start_nc, best_c)
                bd_c = np.where(closer, fbd, bd_c)

            def segsum(tgt_local, _p0=p0, _d=d, _start=start, _m=m_eff):
                tgt_pad = np.full(chunk, -1, dtype=np.int32)
                tgt_pad[_p0:_p0 + _m] = tgt_local
                sums, cnts = seg_fn(
                    items_sharded, np.asarray([_start], dtype=np.int32),
                    tgt_pad, np.asarray([_d], np.int32))
                sums, cnts = jax.device_get((sums, cnts))
                return (np.asarray(sums, dtype=np.float64),
                        np.asarray(cnts, dtype=np.int64))

            _apply_chunk_decisions(
                None, best_c, bd_c, offs, builder, sampler, radius,
                max_clusters, cent, counts, assign, state,
                segsum=segsum,
                fetch_at=lambda li, _offs=offs: fetch_rows_at(
                    np.asarray(li, dtype=np.int64) + _offs),
                nfeatures=f)

    if state["n_c"] == 0:
        raise RuntimeError("No clusters created from data")
    n_c = state["n_c"]
    from ..clustering import Assignments
    return cent[:n_c].copy(), Assignments(assign), counts[:n_c].tolist()


def distributed_build_step(
    items: jax.Array,       # (N, F) — will be sharded
    builder,
    queries: jax.Array,
    taumode: TauMode,
    graph_params,
    k: int,
    mesh: Mesh,
    max_clusters: int,
    radius: float,
):
    """Full sharded build -> query: sharded clustering (device distance
    tiles, host rules), replicated graph build from the centroids, sharded
    λτ batch, distributed top-k.  This is the end-to-end multi-chip path
    the dry run exercises."""
    items = ensure_global(items, items_sharding(mesh))
    if (is_multiprocess() and builder.sampling is not None
            and builder.clustering_seed is None):
        # every process replays the same host create/assign rules; an
        # unseeded sampler draws per-process OS entropy and the
        # processes would silently diverge (deterministic contract of
        # clustering.rs:842-846, lifted to the process level)
        raise ValueError(
            "multi-process builds require a seeded builder "
            "(with_seed) when inline sampling is enabled — unseeded "
            "samplers draw per-process entropy and host decisions "
            "would diverge across processes")
    sampler = (builder.sampling.make(seed=builder.clustering_seed)
               if builder.sampling is not None else None)
    if sampler is None:
        from ..sampling import SamplerType
        sampler = SamplerType.simple(1.0).make(seed=1)
        builder.sampling = None
    cent, assignments, sizes = sharded_incremental_clustering(
        items, builder, max_clusters, radius, sampler, mesh)
    centroids = jnp.asarray(cent, dtype=items.dtype)
    lambdas, scores, idx = distributed_index_step(
        items, centroids, queries, taumode, graph_params, k, mesh)
    return centroids, lambdas, scores, idx


class DistributedSearchSession:
    """Pipelined streaming search over a device mesh — the multi-chip
    counterpart of index.SearchSession.

    ONE jitted program per batch fuses query-λ preparation (τ selection +
    synthetic λ against the replicated graph) with per-shard scoring
    through ops.search.lambda_topk and the ``all_gather`` candidate merge
    (the reference's per-thread-heap fold/reduce, core.rs:818-888).  The
    stream driver keeps ``depth`` batches in flight so result readback
    overlaps the next batch's compute on every device.
    """

    def __init__(self, items, item_lambdas, laplacian, mesh: Mesh,
                 batch_size: int, k: int = 10, alpha: float = 0.9,
                 taumode: TauMode = None, depth: int = 2,
                 projection=None, pad_tall: bool = False):
        self.batch_size = int(batch_size)
        self.depth = max(1, int(depth))
        self.mesh = mesh
        n = items.shape[0]
        n_dev = mesh.devices.size
        assert n % n_dev == 0, (
            f"N={n} must be padded to a multiple of the mesh size {n_dev}")
        k_eff = min(int(k), n)
        self.k = k_eff
        shard_n = n // n_dev
        k_local = min(k_eff, shard_n)
        taumode = taumode if taumode is not None else TauMode.median()
        dt = items.dtype
        self._dt = dt
        self._dim = items.shape[1]

        items = ensure_global(items, items_sharding(mesh))
        item_lambdas = ensure_global(item_lambdas,
                                     items_sharding(mesh, ndim=1))
        laplacian = put_global(np.asarray(laplacian, dtype=np.dtype(dt)),
                               replicated_sharding(mesh))
        has_proj = projection is not None
        proj = put_global(
            np.asarray(projection, dtype=np.dtype(dt)) if has_proj
            else np.zeros((1, 1), dtype=np.dtype(dt)),
            replicated_sharding(mesh))
        _check_graph_width(laplacian, items, has_proj, pad_tall)

        def _shard_fn(q, x, xlam, lap, pr):
            # dims-reduced index: the projected query prepares λ, the RAW
            # query scores against the raw items (ArrowIndex.search
            # semantics; core.rs:509-549)
            _, qlam = prepare_lambdas(q, lap, pr, taumode,
                                      has_proj=has_proj, pad_tall=pad_tall)
            ls, li = lambda_topk(q, qlam, x, xlam,
                                 jnp.asarray(alpha, dtype=dt), k=k_local)
            return _merge_shards(ls, li, shard_n, k_eff)

        fn = shard_map(_shard_fn, mesh=mesh,
                       in_specs=(P(), P(ITEMS_AXIS, None), P(ITEMS_AXIS),
                                 P(), P()),
                       out_specs=(P(), P()), check_vma=False)
        self._step = _bind_step(jax.jit(fn), mesh,
                                (items, item_lambdas, laplacian, proj))

    @classmethod
    def from_index(cls, index, mesh: Mesh, batch_size: int, k: int = 10,
                   alpha: float = 0.9,
                   depth: int = 2) -> "DistributedSearchSession":
        """Open a mesh session over a built/loaded ArrowIndex (the corpus
        and λ re-shard over the mesh; the graph and any JL projection
        replicate)."""
        aspace, gl = index.aspace, index.gl
        dt = aspace.data.dtype
        proj = None
        if aspace.projection_matrix is not None:
            proj = aspace.projection_matrix.matrix(dtype=dt)
        return cls(aspace.data, aspace.lambdas,
                   jnp.asarray(gl.matrix, dtype=dt), mesh, batch_size,
                   k=k, alpha=alpha, taumode=aspace.taumode, depth=depth,
                   projection=proj, pad_tall=aspace.pad_tall_graphs)

    def warmup(self) -> None:
        """Compile the fused multi-chip step so serving is dispatch-only."""
        from ..index import warm_step
        warm_step(self._step, self.batch_size, self._dim, self._dt)

    def search_stream(self, batches):
        """Yield (scores, ids) per input batch with ``depth`` batches in
        flight across the mesh (shared driver: index.stream_search)."""
        from ..index import stream_search
        return stream_search(self._step, batches, self.batch_size,
                             self.depth, self._dt, dim=self._dim)


def _check_graph_width(laplacian, items, has_proj: bool, pad_tall: bool):
    if (not has_proj and not pad_tall
            and laplacian.shape[0] != items.shape[1]):
        raise ValueError(
            f"graph has {laplacian.shape[0]} nodes but items have "
            f"{items.shape[1]} coordinates — a dims-reduced index "
            f"needs the projection matrix (projection=...), a tall "
            f"energy graph needs pad_tall=True")


def _bind_step(jitted, mesh: Mesh, operands):
    """Session step q -> (scores, ids) over fixed corpus operands.  Under
    multi-process the stream driver hands a process-local committed
    query array; it is re-placed as a global replicated operand (every
    process streams identical batches — the one-driver-per-host
    contract)."""
    if is_multiprocess():
        rep = replicated_sharding(mesh)
        return lambda q: jitted(put_global(np.asarray(q), rep), *operands)
    return lambda q: jitted(q, *operands)


class DistributedEnergySearchSession:
    """Multi-chip ENERGY serving session — the energy-index counterpart
    of DistributedSearchSession (search_energy semantics,
    energymaps.rs:368-407), sharing its design: one jitted program per
    batch fuses query-λ preparation + the z-space projection with
    per-shard scoring (energymaps.energy_topk) and the all_gather
    candidate merge.

    The z-plane is computed PER SHARD at construction (one shard_map:
    z = x_proj Sᵀ on each shard's rows against the replicated signals)
    — at the 100M×768 target the (N, G) z corpus never exists on one
    device or host.
    """

    def __init__(self, items, item_lambdas, laplacian, mesh: Mesh,
                 batch_size: int, k: int = 10, w_lambda: float = 1.0,
                 w_dirichlet: float = 0.5, taumode: TauMode = None,
                 depth: int = 2, projection=None, signals=None,
                 pad_tall: bool = False):
        from ..energymaps import energy_query_z, energy_topk
        self.batch_size = int(batch_size)
        self.depth = max(1, int(depth))
        self.mesh = mesh
        n = items.shape[0]
        n_dev = mesh.devices.size
        assert n % n_dev == 0, (
            f"N={n} must be padded to a multiple of the mesh size {n_dev}")
        k_eff = min(int(k), n)
        self.k = k_eff
        shard_n = n // n_dev
        k_local = min(k_eff, shard_n)
        taumode = taumode if taumode is not None else TauMode.median()
        dt = items.dtype
        self._dt = dt
        self._dim = items.shape[1]

        items = ensure_global(items, items_sharding(mesh))
        item_lambdas = ensure_global(item_lambdas,
                                     items_sharding(mesh, ndim=1))
        laplacian = put_global(np.asarray(laplacian, dtype=np.dtype(dt)),
                               replicated_sharding(mesh))
        has_proj = projection is not None
        proj = put_global(
            np.asarray(projection, dtype=np.dtype(dt)) if has_proj
            else np.zeros((1, 1), dtype=np.dtype(dt)),
            replicated_sharding(mesh))
        has_signals = (signals is not None
                       and np.shape(signals)[0] > 0)
        sig = put_global(
            np.asarray(signals, dtype=np.dtype(dt)) if has_signals
            else np.zeros((1, 1), dtype=np.dtype(dt)),
            replicated_sharding(mesh))
        _check_graph_width(laplacian, items, has_proj, pad_tall)

        # z-plane per shard: z = (x @ proj?) @ signalsᵀ (identity maps
        # when absent) — mirrors energymaps._energy_z_items shard-wise
        def _z_shard(x, pr, sg):
            xp = x if not has_proj else jnp.dot(
                x, pr, preferred_element_type=dt,
                precision=jax.lax.Precision.HIGHEST)
            return energy_query_z(xp, sg, has_signals)

        z_items = jax.jit(shard_map(
            _z_shard, mesh=mesh,
            in_specs=(P(ITEMS_AXIS, None), P(), P()),
            out_specs=P(ITEMS_AXIS, None), check_vma=False))(
                items, proj, sig)
        self._g = z_items.shape[1]

        def _shard_fn(q, z, zlam, lap, pr, sg):
            q_prep, qlam = prepare_lambdas(q, lap, pr, taumode,
                                           has_proj=has_proj,
                                           pad_tall=pad_tall)
            ls, li = energy_topk(
                energy_query_z(q_prep, sg, has_signals), qlam, z, zlam,
                jnp.asarray(w_lambda, dtype=dt),
                jnp.asarray(w_dirichlet, dtype=dt), k=k_local)
            return _merge_shards(ls.astype(dt), li, shard_n, k_eff)

        fn = shard_map(_shard_fn, mesh=mesh,
                       in_specs=(P(), P(ITEMS_AXIS, None), P(ITEMS_AXIS),
                                 P(), P(), P()),
                       out_specs=(P(), P()), check_vma=False)
        self._step = _bind_step(jax.jit(fn), mesh,
                                (z_items, item_lambdas, laplacian, proj,
                                 sig))

    @classmethod
    def from_index(cls, index, mesh: Mesh, batch_size: int, k: int = 10,
                   w_lambda: float = 1.0, w_dirichlet: float = 0.5,
                   depth: int = 2, **kw) -> "DistributedEnergySearchSession":
        """Open a mesh energy session over a built energy ArrowIndex
        (the corpus and λ re-shard; graph/signals/projection
        replicate)."""
        aspace, gl = index.aspace, index.gl
        dt = aspace.data.dtype
        proj = None
        if aspace.projection_matrix is not None:
            proj = aspace.projection_matrix.matrix(dtype=dt)
        items_proj = aspace.projected_items()
        use_signals = (aspace.signals is not None
                       and np.shape(aspace.signals)[0] > 0
                       and np.shape(aspace.signals)[1]
                       == items_proj.shape[1])
        signals = np.asarray(aspace.signals) if use_signals else None
        # the session shards RAW items and projects PER SHARD inside the
        # z-plane program (queries project inside the step, exactly like
        # prepare_query_items_batch + search_energy_batch do on one chip)
        return cls(aspace.data, aspace.lambdas,
                   jnp.asarray(gl.matrix, dtype=dt), mesh, batch_size,
                   k=k, w_lambda=w_lambda, w_dirichlet=w_dirichlet,
                   taumode=aspace.taumode, depth=depth, projection=proj,
                   signals=signals, pad_tall=aspace.pad_tall_graphs, **kw)

    def warmup(self) -> None:
        """Compile the fused multi-chip energy step so serving is
        dispatch-only."""
        from ..index import warm_step
        warm_step(self._step, self.batch_size, self._dim, self._dt)

    def search_stream(self, batches):
        """Yield (scores, ids) per input batch with ``depth`` batches in
        flight across the mesh (shared driver: index.stream_search)."""
        from ..index import stream_search
        return stream_search(self._step, batches, self.batch_size,
                             self.depth, self._dt, dim=self._dim)


def distributed_index_step(
    items: jax.Array,       # (N, F) sharded
    centroids: jax.Array,   # (X, F) replicated (from host clustering)
    queries: jax.Array,     # (B, F) replicated
    taumode: TauMode,
    graph_params,
    k: int,
    mesh: Mesh,
):
    """One full device-side index+query step over the mesh — the
    "training step" analogue used by the multi-chip dry run:

    1. build the F′×F′ λτ-graph from the (replicated) centroids;
    2. compute λτ for every (sharded) item;
    3. prepare query λ and run the distributed top-k.
    """
    from ..laplacian import build_laplacian_matrix

    gl = build_laplacian_matrix(centroids.T, graph_params,
                                n_items=items.shape[0])
    lap = put_global(np.asarray(gl.matrix), replicated_sharding(mesh))

    lambdas = sharded_compute_taumode_lambdas(items, lap, taumode, mesh)

    q_taus = select_tau_batch(queries, taumode)
    q_lambdas = synthetic_lambda_batch(queries, lap, q_taus)

    scores, idx = distributed_lambda_aware_topk(
        queries, q_lambdas, items, lambdas,
        jnp.asarray(0.9, dtype=items.dtype), k, mesh)
    return lambdas, scores, idx
