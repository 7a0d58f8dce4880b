"""Multi-process (multi-host) runtime: jax.distributed over localhost.

The heavyweight test launches 2 real processes × 4 virtual CPU devices
(gloo collectives) and runs the full per-host-ingested sharded
build→query→serve dryrun (parallel/mp_worker.py) — the process-level
analogue of the single-process mesh tests in test_distributed.py.
Skips when the environment cannot host the localhost coordinator (no
gloo / sandboxed sockets); any in-worker assertion is a FAILURE, not a
skip.

Reference anchor: the merge semantics distributed here are the
reference's per-thread-heap fold (core.rs:865-888); the reference
itself has no multi-process runtime (SURVEY.md §2) — this layer exists
for the BASELINE 100M×768 multi-host config.
"""

import numpy as np
import pytest


def test_local_row_range_contract():
    """Single-process: every process (the only one) owns all rows, and
    the helper agrees with the sharding's index map."""
    import jax

    from arrowspace_tpu.parallel import make_mesh
    from arrowspace_tpu.parallel.mesh import items_sharding
    from arrowspace_tpu.parallel.multiprocess import local_row_range

    mesh = make_mesh(8)
    lo, hi = local_row_range(items_sharding(mesh), 4096)
    assert (lo, hi) == (0, 4096)
    assert jax.process_count() == 1


def test_put_global_single_process_is_device_put():
    from arrowspace_tpu.parallel import make_mesh
    from arrowspace_tpu.parallel.mesh import replicated_sharding
    from arrowspace_tpu.parallel.multiprocess import put_global

    mesh = make_mesh(8)
    x = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    g = put_global(x, replicated_sharding(mesh))
    np.testing.assert_array_equal(np.asarray(g), x)
    # placing an already-global array is a no-op passthrough
    assert put_global(g, replicated_sharding(mesh)) is g


def test_two_process_build_query_serve():
    """2 localhost processes × 4 virtual CPU devices each: per-host
    corpus ingestion, sharded incremental clustering, λτ shard parity,
    hierarchical (dcn=processes, ici=local) top-k parity, and both
    serving sessions — all asserted INSIDE the workers; this test
    checks the aggregate result."""
    from arrowspace_tpu.parallel import run_cpu_multiprocess_dryrun

    try:
        r = run_cpu_multiprocess_dryrun(num_processes=2, local_devices=4,
                                        n_rows=32768, f=64, timeout=900)
    except RuntimeError as e:
        msg = str(e)
        if ("gloo" in msg.lower() or "coordinator" in msg.lower()
                or "address already in use" in msg.lower()):
            pytest.skip(f"multi-process runtime unavailable: {msg[:200]}")
        raise
    assert r["ok"] is True
    assert r["process_count"] == 2
    assert r["global_devices"] == 8
    assert r["self_match"] == "16/16"
    assert r["session_self_match"] == "16/16"
    assert r["hierarchical_topk_equal"] is True
    # per-host ingestion: process 0 loaded only the first half
    assert r["local_rows"] == [0, 16384]


def test_four_process_build_query_serve():
    """4 localhost processes × 2 virtual CPU devices each — a DIFFERENT
    (dcn, ici) split of the same 8-device world than the 2×4 test, so
    the hierarchical merge's dcn-frugality and the per-host ingestion
    contract are exercised at a second process topology."""
    from arrowspace_tpu.parallel import run_cpu_multiprocess_dryrun

    try:
        r = run_cpu_multiprocess_dryrun(num_processes=4, local_devices=2,
                                        n_rows=32768, f=64, timeout=900)
    except RuntimeError as e:
        msg = str(e)
        if ("gloo" in msg.lower() or "coordinator" in msg.lower()
                or "address already in use" in msg.lower()):
            pytest.skip(f"multi-process runtime unavailable: {msg[:200]}")
        raise
    assert r["ok"] is True
    assert r["process_count"] == 4
    assert r["global_devices"] == 8
    assert r["self_match"] == "16/16"
    assert r["session_self_match"] == "16/16"
    assert r["hierarchical_topk_equal"] is True
    # per-host ingestion: process 0 loaded only the first quarter
    assert r["local_rows"] == [0, 8192]
