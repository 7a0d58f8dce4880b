"""Multi-process (multi-host) runtime.

The reference is strictly single-process (SURVEY.md §2: its only
parallelism is rayon shared-memory fan-out), but the BASELINE
100M×768 target spans hosts.  This module adds the process layer
the hierarchical (dcn, ici) mesh machinery needs to actually span them:

* ``init_distributed`` — one call per host process wires
  ``jax.distributed.initialize`` (coordinator address, process count,
  process id).  After it, ``jax.devices()`` is the GLOBAL device list
  and every jitted program in this package runs SPMD across hosts with
  XLA collectives within and between hosts.
* ``local_row_range`` / ``make_sharded_corpus`` — the per-host corpus
  ingestion contract: each host loads ONLY its contiguous row slice and
  the global (N, F) array is assembled from process-local shards
  (``jax.make_array_from_process_local_data``).  No host ever
  materialises the full corpus — at 100M×768 that would be ~300 GB.
* ``put_global`` — a device_put that works under multi-process for
  host values every process holds identically (queries, graph,
  centroid buffers): each process contributes only its addressable
  shards.

Execution model: every process runs the SAME host driver code (one
driver per host).  Device programs whose results the host bookkeeping
consumes are emitted with REPLICATED output shardings under
multi-process (an extra all_gather of small per-chunk vectors), because
a host can only fetch addressable shards; all processes then apply the
same deterministic host rules to bit-identical inputs and stay in
lockstep with no coordination beyond jax.distributed itself — the
multi-host analogue of the reference's in-process determinism contract
(clustering.rs:842-846).  Multi-process *builds* therefore require a
seeded builder: unseeded samplers draw OS entropy per process and the
host decisions would diverge (enforced in
``distributed_build_step``).

Tested here with N localhost processes × M virtual CPU devices each
(gloo collectives): tests/test_multiprocess.py and the driver's
``dryrun_multichip`` multi-process stage.  On a real multi-host
deployment the same code path runs with one process per host and the
accelerators' own collectives instead of gloo.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

__all__ = ["init_distributed", "is_multiprocess", "put_global",
           "ensure_global", "local_row_range", "make_sharded_corpus",
           "run_cpu_multiprocess_dryrun"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Wire this process into the multi-host runtime.  Call once per
    host process BEFORE any device use.  With no arguments, defers to
    jax.distributed's environment auto-detection (cluster metadata /
    the standard JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID variables).  Safe to call when already initialised
    (no-op)."""
    import jax
    # NB: jax.process_count() would itself initialise the backend, which
    # forbids a later distributed.initialize — probe the runtime state
    # instead (private but stable; the public API offers no probe)
    from jax._src import distributed as _dist_state
    if _dist_state.global_state.client is not None:
        return  # already initialised
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def is_multiprocess() -> bool:
    import jax
    return jax.process_count() > 1


def put_global(x, sharding):
    """device_put that works under multi-process.

    Single-process: plain ``jax.device_put``.  Multi-process: every
    process passes the same full host value (replicated inputs —
    queries, graph matrices, centroid buffers) and each places only its
    addressable shards (``jax.make_array_from_callback``).  A global
    jax.Array that is not fully addressable passes through untouched —
    it is already placed (re-sharding a global array is the caller's
    explicit job, not an implicit transfer)."""
    import jax
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        return x
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def ensure_global(x, sharding):
    """Alias of put_global for corpus-sized operands, kept separate so
    call sites document intent: the multi-process caller is expected to
    pass an already-global array (from make_sharded_corpus); host
    values only make sense single-process or in tests."""
    return put_global(x, sharding)


def local_row_range(sharding, n_global: int) -> Tuple[int, int]:
    """The contiguous [lo, hi) row range of an (n_global, …) array this
    process must load under ``sharding`` (the per-host ingestion
    contract).  Asserts the addressable rows ARE contiguous — true for
    the 1-D items mesh and the (dcn, ici) mesh built over
    ``jax.devices()``, whose device order is process-major."""
    import jax
    index_map = sharding.addressable_devices_indices_map(
        (n_global,) + (1,) * 0)
    starts, stops = [], []
    for idx in index_map.values():
        sl = idx[0]
        starts.append(0 if sl.start is None else sl.start)
        stops.append(n_global if sl.stop is None else sl.stop)
    lo, hi = min(starts), max(stops)
    span = sorted(zip(starts, stops))
    cover = lo
    for s, e in span:
        assert s <= cover, (
            f"non-contiguous addressable rows under {sharding}: "
            f"gap before {s}")
        cover = max(cover, e)
    assert cover == hi
    del jax
    return int(lo), int(hi)


def make_sharded_corpus(local_rows: np.ndarray, mesh,
                        n_global: int):
    """Assemble the global (n_global, F) corpus array from THIS host's
    row slice (see local_row_range).  Every process calls this with its
    own slice; no process ever holds the full corpus."""
    import jax

    from .mesh import items_sharding
    sharding = items_sharding(mesh)
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_rows),
        (n_global, local_rows.shape[1]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cpu_multiprocess_dryrun(num_processes: int = 2,
                                local_devices: int = 4,
                                n_rows: int = 131072, f: int = 64,
                                timeout: float = 1500.0) -> dict:
    """Launch ``num_processes`` localhost worker processes (each with
    ``local_devices`` virtual CPU devices, gloo collectives) running
    the full per-host-ingested sharded build→query→serve dryrun
    (parallel/mp_worker.py) and return process 0's parsed result dict.

    Raises RuntimeError with both workers' tails on failure."""
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}")
    # the worker forces the cpu platform itself; drop variables that
    # could re-route it
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for pid in range(num_processes):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "arrowspace_tpu.parallel.mp_worker",
             "--pid", str(pid), "--nproc", str(num_processes),
             "--port", str(port), "--n", str(n_rows), "--f", str(f)],
            cwd=repo_root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(
            "multi-process dryrun timed out; partial output:\n"
            + "\n".join(o[-2000:] if o else "" for o in outs))
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(
            "multi-process dryrun failed in process(es) "
            f"{bad}:\n" + "\n---\n".join(
                f"[p{i}] …{outs[i][-3000:]}" for i in range(len(outs))))
    import json
    for line in outs[0].splitlines():
        if line.startswith("MP_DRYRUN_RESULT "):
            return json.loads(line[len("MP_DRYRUN_RESULT "):])
    raise RuntimeError(
        "worker 0 produced no MP_DRYRUN_RESULT line:\n" + outs[0][-3000:])
