"""Multi-process dryrun worker: one process per "host".

Launched by multiprocess.run_cpu_multiprocess_dryrun (and the driver's
dryrun_multichip multi-process stage): each process owns
``--xla_force_host_platform_device_count`` virtual CPU devices, joins
the jax.distributed runtime over a localhost coordinator, ingests ONLY
its own corpus row slice, and runs the full sharded build → λτ →
query → serving path end to end — the same pipeline a real multi-host
deployment runs with one process per host (SURVEY.md §5 distributed
backend; the merge semantics distributed here are the reference's
per-thread-heap fold of core.rs:865-888).

Prints one ``MP_DRYRUN_RESULT {json}`` line from process 0.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--f", type=int, default=64)
    args = ap.parse_args(argv)

    import jax
    # the worker is a pure-CPU process (virtual devices + gloo
    # collectives) whatever accelerator the host has
    jax.config.update("jax_platforms", "cpu")

    from arrowspace_tpu.parallel.multiprocess import (
        init_distributed, local_row_range, make_sharded_corpus)
    init_distributed(f"localhost:{args.port}", num_processes=args.nproc,
                     process_id=args.pid)
    assert jax.process_count() == args.nproc, jax.process_count()

    import jax.numpy as jnp
    import numpy as np

    from arrowspace_tpu.parallel import make_mesh
    from arrowspace_tpu.parallel.mesh import items_sharding

    mesh = make_mesh()          # 1-D items mesh over the GLOBAL devices
    n, f, b = args.n, args.f, 16

    # Deterministic FIXED-BLOCK row generator: any host can regenerate
    # any row range without owning it (queries reference rows that live
    # on process 0; every host must pass identical query batches).  The
    # RNG is keyed per 4096-row block so a range's values never depend
    # on how much of the stream the caller asks for.
    centers = np.random.default_rng(1).uniform(0.2, 0.8, (64, f))
    BLK = 4096

    def _gen_block(b0: int) -> np.ndarray:
        rng = np.random.default_rng(10_000 + b0)
        a = rng.integers(0, 64, BLK)
        return (centers[a]
                + rng.normal(0, 0.05, (BLK, f))).astype(np.float32)

    def rows_block(lo: int, hi: int) -> np.ndarray:
        first = (lo // BLK) * BLK
        parts = [_gen_block(b0)
                 for b0 in range(first, hi, BLK)]
        return np.concatenate(parts)[lo - first:hi - first]

    sharding = items_sharding(mesh)
    lo, hi = local_row_range(sharding, n)
    local = rows_block(lo, hi)  # per-host ingestion: ONLY this slice
    items = make_sharded_corpus(local, mesh, n)
    assert not items.is_fully_addressable  # truly spans processes
    queries = rows_block(0, b) * 1.01

    # Pilot optimal-K on process 0, broadcast — different hosts' BLAS
    # may differ bitwise, and the build's host rules need identical
    # (k_opt, radius) everywhere.  (Here all processes share a machine,
    # but this is the pattern a real pod needs.)
    from jax.experimental import multihost_utils

    from arrowspace_tpu import clustering
    if jax.process_index() == 0:
        pilot = rows_block(0, min(16384, n))
        k_opt, radius, _ = clustering.compute_optimal_k(
            pilot, pilot.shape[0], f, 99)
        pack = np.asarray([float(k_opt), float(radius)], dtype=np.float64)
    else:
        pack = np.zeros(2, dtype=np.float64)
    pack = np.asarray(multihost_utils.broadcast_one_to_all(pack))
    k_opt, radius = int(pack[0]), float(pack[1])

    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.graph import GraphParams
    from arrowspace_tpu.parallel import (DistributedSearchSession,
                                         distributed_build_step)
    from arrowspace_tpu.taumode import TauMode

    params = GraphParams(eps=1.0, k=5, topk=3, p=2.0, sigma=None,
                         normalise=False, sparsity_check=False)

    # unseeded sampling must be refused under multi-process (host
    # decisions would diverge on per-process OS entropy)
    from arrowspace_tpu.sampling import SamplerType
    bad = ArrowSpaceBuilder()
    bad.sampling = SamplerType.simple(0.6)
    try:
        distributed_build_step(items, bad, jnp.asarray(queries),
                               TauMode.median(), params, 10, mesh,
                               max_clusters=k_opt, radius=radius)
        raise AssertionError("unseeded multi-process build not refused")
    except ValueError as e:
        assert "seeded" in str(e), e

    builder = ArrowSpaceBuilder()
    builder.sampling = None
    t0 = time.perf_counter()
    centroids, lambdas, scores, idx = distributed_build_step(
        items, builder, jnp.asarray(queries), TauMode.median(), params,
        10, mesh, max_clusters=k_opt, radius=radius)
    jax.block_until_ready((scores, idx))
    build_s = time.perf_counter() - t0
    idx_h = np.asarray(idx)
    hits = sum(1 for qi in range(b) if int(idx_h[qi][0]) == qi)
    assert hits >= b - 2, f"self-match {hits}/{b}"

    # local-shard λτ parity: this host's shard of the global sharded λ
    # batch vs a single-device recompute over ITS OWN rows
    from arrowspace_tpu.laplacian import build_laplacian_matrix
    from arrowspace_tpu.taumode import compute_taumode_lambdas
    gl = build_laplacian_matrix(jnp.asarray(centroids).T, params,
                                n_items=n)
    lam_ref = compute_taumode_lambdas(
        jnp.asarray(local), gl.matrix.astype(jnp.float32),
        TauMode.median())
    shards = sorted(lambdas.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    lam_local = np.concatenate([np.asarray(s.data) for s in shards])
    assert np.allclose(lam_local, np.asarray(lam_ref), rtol=1e-5,
                       atol=1e-6), "local λτ shard parity failed"

    # hierarchical (dcn=processes, ici=local devices) merge parity: the
    # 2-D path's top-k must equal the 1-D path's on the same corpus
    from arrowspace_tpu.parallel import (distributed_lambda_aware_topk,
                                         distributed_lambda_aware_topk_2d,
                                         make_mesh_2d)
    from arrowspace_tpu.taumode import (select_tau_batch,
                                        synthetic_lambda_batch)
    qj = jnp.asarray(queries)
    qlam = synthetic_lambda_batch(
        qj, gl.matrix.astype(jnp.float32),
        select_tau_batch(qj, TauMode.median()))
    s1, i1 = distributed_lambda_aware_topk(
        qj, qlam, items, lambdas, 0.9, 10, mesh)
    mesh2d = make_mesh_2d(args.nproc, jax.local_device_count())
    s2, i2 = distributed_lambda_aware_topk_2d(
        qj, qlam, items, lambdas, 0.9, 10, mesh2d)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    # serving session over the global corpus
    lapm = jnp.asarray(gl.matrix, dtype=jnp.float32)
    sess = DistributedSearchSession(items, lambdas, lapm, mesh,
                                    batch_size=b, k=10, alpha=0.9)
    sess.warmup()
    outs = list(sess.search_stream(
        [queries, rows_block(b, 2 * b) * 1.01]))
    s_hits = sum(1 for qi in range(b) if int(outs[0][1][qi][0]) == qi)
    assert s_hits >= b - 2, f"session self-match {s_hits}/{b}"

    if jax.process_index() == 0:
        print("MP_DRYRUN_RESULT " + json.dumps({
            "ok": True,
            "process_count": jax.process_count(),
            "global_devices": jax.device_count(),
            "local_devices": jax.local_device_count(),
            "n": n, "f": f,
            "local_rows": [lo, hi],
            "centroids": int(np.asarray(centroids).shape[0]),
            "build_s": round(build_s, 2),
            "self_match": f"{hits}/{b}",
            "session_self_match": f"{s_hits}/{b}",
            "hierarchical_topk_equal": True,
        }), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
