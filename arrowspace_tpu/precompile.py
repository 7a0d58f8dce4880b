"""AOT pre-compilation of the build/serve device programs.

A fresh process (or a fresh machine) pays one XLA compile per program
shape.  The framework already buckets every data-dependent shape
(clustering._bucket_centroid_cap for the centroid cap), so the set of
programs a build + serving deployment will need is fully determined by
(n_items, n_features, batch sizes, k) — this module compiles them ahead
of time, by shape alone, with no corpus upload and no host clustering
work.

Combined with ``config.setup_cache()`` (persist *every* program, not just
slow-to-compile ones) a deployment warms the machine once; every
subsequent process starts at steady-state build/serve latency.

Usage:
    python -m arrowspace_tpu.precompile --n 1000000 --f 128
or:
    from arrowspace_tpu.precompile import warm
    warm(1_000_000, 128, batch_sizes=(256, 2048), k=10)

The reference has no analogue (rustc compiles arrowspace-rs ahead of
time by construction); this is the equivalent of shipping a compiled
binary.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Iterable, Optional

import numpy as np

from .utils.log import get_logger

logger = get_logger("arrowspace.precompile")

__all__ = ["warm", "warm_energy", "centroid_cap_buckets"]


def _aot(timings: Dict[str, float], name: str, jitted, *args, **kwargs):
    """Lower+compile one jitted program by shape, recording the compile
    time (negative on failure — keep warming the rest)."""
    t0 = time.perf_counter()
    try:
        jitted.lower(*args, **kwargs).compile()
        timings[name] = time.perf_counter() - t0
        logger.info("precompiled %s in %.2fs", name, timings[name])
    except Exception as e:  # pragma: no cover — keep warming the rest
        timings[name] = -1.0
        logger.warning("precompile of %s failed: %r", name, e)


def centroid_cap_buckets(n: int, f: int) -> list:
    """All 128-bucketed centroid caps the optimal-K sweep can land on for
    an (n, f) corpus — data-independent bounds from clustering.rs:75-98:
    k_min = ceil(sqrt(n/10)); k_max = min(max(min(f, n//10, 5*ID, sqrt(n)),
    k_min+1), n//2) with ID in [1, f]."""
    from .clustering import _bucket_centroid_cap

    k_min = max(math.ceil(math.sqrt(n / 10.0)), 2)
    k_lo = k_min
    # widest possible k_max over ID in [1, f]
    k_hi = max(min(f, n // 10, 5 * f, int(n ** 0.5)), k_min + 1)
    k_hi = min(k_hi, n // 2)
    lo = _bucket_centroid_cap(k_lo)
    hi = _bucket_centroid_cap(max(k_hi, k_lo))
    return list(range(lo, hi + 1, 128))


def warm(
    n_items: int,
    n_features: int,
    *,
    batch_sizes: Iterable[int] = (256,),
    k: int = 10,
    alpha: float = 0.9,
    precisions: Iterable[str] = ("f32",),
    taumode=None,
    graph_nodes: Optional[int] = None,
    dtype=None,
    cache_path: Optional[str] = None,
) -> Dict[str, float]:
    """Compile (by shape, no data) every device program a standard
    unseeded build + serving session needs for an (n_items, n_features)
    corpus.  Returns {program: compile_seconds}.  Programs that are
    already in the in-process or persistent cache return in milliseconds.
    """
    import jax
    import jax.numpy as jnp

    from . import clustering
    from .config import setup_cache
    from .index import _session_step_jit
    from .taumode import TauMode

    if cache_path is not None:
        setup_cache(cache_path)
    elif jax.config.jax_compilation_cache_dir is None:
        setup_cache()

    if taumode is None:
        taumode = TauMode.median()
    dt = jnp.dtype(dtype) if dtype is not None else (
        jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    n, f = int(n_items), int(n_features)
    n_graph = int(graph_nodes) if graph_nodes is not None else f

    timings: Dict[str, float] = {}

    def aot(name, jitted, *args, **kwargs):
        _aot(timings, name, jitted, *args, **kwargs)

    S = jax.ShapeDtypeStruct
    corpus = S((n, f), dt)
    i32 = np.dtype(np.int32)

    # --- build stage 1: Two-NN intrinsic-dimension tiles ------------------
    if n * f >= clustering.DEVICE_CLUSTERING_MIN_ELEMS:
        aot("twonn_tile", clustering._twonn_tile_jit(),
            corpus, S((clustering.TWONN_CHUNK,), i32))

        # --- build stage 1b: unseeded chunked-scan snapshot distances -----
        chunk = clustering._device_chunk_for(n)
        for cap in centroid_cap_buckets(n, f):
            aot(f"chunk_dist_cap{cap}", clustering._chunk_dist_jit(),
                corpus, S((), i32), S((cap, f), dt), S((), i32),
                chunk=chunk)
            aot(f"chunk_segsum_cap{cap}", clustering._chunk_segsum_jit(),
                corpus, S((), i32), S((chunk,), i32),
                chunk=chunk, cap=cap)
            # at-cap one-dispatch TAIL program (the whole post-saturation
            # remainder of the scan); n_steps is shape-derived so one
            # program per (corpus, cap, kind).  "simple" covers the
            # builder default sampler, "none" the sampling-disabled build
            n_steps = (n + chunk - 1) // chunk
            for kind in ("simple", "none"):
                draws_shape = (n_steps, chunk) if kind != "none" \
                    else (n_steps, 1)
                aot(f"chunk_tail_cap{cap}_{kind}",
                    clustering._chunk_decide_tail_jit(),
                    corpus, S((), i32), S((cap, f), dt), S((cap,), i32),
                    S((), i32), S((), dt), S(draws_shape, dt),
                    S((), dt), S((), dt),
                    chunk=chunk, cap=cap, sampler_kind=kind,
                    n_steps=n_steps)

    # --- serving: fused prep+score+top-k session step --------------------
    k_eff = min(int(k), n)
    for bsz in batch_sizes:
        for prec in precisions:
            aot(f"session_step_b{bsz}_{prec}", _session_step_jit(),
                S((int(bsz), f), dt), corpus, S((n,), dt),
                S((n_graph, n_graph), dt), S((1, 1), dt),
                taumode=taumode, alpha=float(alpha), k=k_eff,
                has_proj=False, pad_tall=False, use_bf16=prec == "bf16")

    return timings


def warm_energy(
    n_items: int,
    z_width: int,
    *,
    batch_sizes: Iterable[int] = (256,),
    k: int = 10,
    dtype=None,
    taumode=None,
    cache_path: Optional[str] = None,
) -> Dict[str, float]:
    """Compile the energy-serving programs
    (energymaps.search_energy_batch past the in-memory ceiling) for a
    corpus whose z-space plane is (n_items, z_width): the z-space scorer
    (energymaps._energy_score_topk_chunked) and the fused
    EnergySearchSession step at the no-projection/no-signals geometry
    (richer geometries compile via EnergySearchSession.warmup).
    ``z_width`` is the signals-graph row count G when signals are
    present (energymaps._energy_z_items), else the projected feature
    width F'.  Reference serving semantics: energymaps.rs:368-407."""
    import jax
    import jax.numpy as jnp

    from .config import setup_cache
    from .energymaps import _energy_score_topk_chunked
    from .index import _energy_step_jit
    from .taumode import TauMode

    if cache_path is not None:
        setup_cache(cache_path)
    elif jax.config.jax_compilation_cache_dir is None:
        setup_cache()

    if taumode is None:
        taumode = TauMode.median()
    dt = jnp.dtype(dtype) if dtype is not None else (
        jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    n, g = int(n_items), int(z_width)
    k_eff = min(int(k), n)
    timings: Dict[str, float] = {}
    S = jax.ShapeDtypeStruct
    items, lam, w = S((n, g), dt), S((n,), dt), S((), dt)
    for bsz in batch_sizes:
        b = int(bsz)
        _aot(timings, f"energy_chunked_b{b}", _energy_score_topk_chunked,
             S((b, g), dt), S((b,), dt), items, lam, w, w, k=k_eff)
        _aot(timings, f"energy_session_b{b}", _energy_step_jit(),
             S((b, g), dt), items, lam, S((g, g), dt),
             S((1, 1), dt), S((1, 1), dt), w, w,
             taumode=taumode, k=k_eff, has_proj=False, has_signals=False,
             pad_tall=False)
    return timings


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="AOT-compile arrowspace-tpu device programs for a "
                    "corpus shape")
    p.add_argument("--n", type=int, required=True, help="corpus rows")
    p.add_argument("--f", type=int, required=True, help="feature dim")
    p.add_argument("--batch", type=int, nargs="*", default=[256],
                   help="serving batch sizes")
    p.add_argument("--k", type=int, default=10, help="serving top-k")
    p.add_argument("--precision", nargs="*", default=["f32"],
                   choices=["f32", "bf16"],
                   help="serving session precisions to warm")
    p.add_argument("--energy-g", type=int, default=None,
                   help="also warm the energy-serving programs for this "
                        "z-space width (signals rows G, or F' when no "
                        "signals graph)")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    timings = warm(args.n, args.f, batch_sizes=args.batch, k=args.k,
                   precisions=tuple(args.precision))
    if args.energy_g is not None:
        timings.update(warm_energy(args.n, args.energy_g,
                                   batch_sizes=tuple(args.batch), k=args.k))
    total = time.perf_counter() - t0
    for name, secs in timings.items():
        print(f"{name}: {'FAILED' if secs < 0 else f'{secs:.2f}s'}")
    print(f"total: {total:.2f}s")


if __name__ == "__main__":
    main()
