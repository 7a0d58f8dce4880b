"""Device-mesh helpers.

The reference's only parallelism is rayon shared-memory fan-out inside one
process (SURVEY.md §2).  Its replacement here is a 1-D device mesh with
the corpus axis N sharded across devices: build tiles, the λτ batch and query
scoring are data-parallel over N, and only the query top-k merge needs a
collective (all_gather of per-shard candidates — the analogue of the
reference's per-thread-heap merge at core.rs:865-888).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ITEMS_AXIS = "items"

__all__ = ["ITEMS_AXIS", "make_mesh", "items_sharding",
           "replicated_sharding"]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_name: str = ITEMS_AXIS) -> Mesh:
    """1-D mesh over the corpus axis.  Multi-host configs reshape this to
    ("dcn", "ici") axes — across hosts, within a host; one host stays
    1-D (its devices reach each other at one rate)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np
    return Mesh(np.asarray(devices), (axis_name,))


def items_sharding(mesh: Mesh, axis_name: str = ITEMS_AXIS,
                   ndim: int = 2) -> NamedSharding:
    """Shard dim 0 (the N items axis) across the mesh; trailing dims
    replicated."""
    spec = P(axis_name, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def make_mesh_2d(dcn: int, ici: int,
                 devices: Optional[Sequence] = None) -> Mesh:
    """("dcn", "ici") mesh for multi-host corpora (the 100M×768 config in
    BASELINE.json): the outer axis spans hosts, the inner one a host's
    devices; the items axis is sharded over BOTH, and collectives are
    issued hierarchically so only k candidates per inner group ever
    cross hosts."""
    if devices is None:
        devices = jax.devices()
    assert len(devices) >= dcn * ici, (
        f"need {dcn * ici} devices, have {len(devices)}")
    import numpy as np
    grid = np.asarray(devices[: dcn * ici]).reshape(dcn, ici)
    return Mesh(grid, ("dcn", "ici"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
