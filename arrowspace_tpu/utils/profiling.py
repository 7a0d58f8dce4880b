"""Profiling hooks.

The reference instruments stage boundaries with std::time::Instant spans
and ASCII-box statistics (taumode.rs:184-311, builder.rs:252).  Here the
same wall-clock spans come from utils.log.stage_timer, and device-side
profiles come from jax.profiler traces (viewable in XProf/TensorBoard).
"""

from __future__ import annotations

import contextlib
import os

import jax
import numpy as np

from .log import get_logger

logger = get_logger("arrowspace.profiling")

__all__ = ["device_trace", "annotate", "log_lambda_statistics"]


@contextlib.contextmanager
def device_trace(logdir: str = "/tmp/arrowspace_trace"):
    """Capture a jax.profiler trace around a block (device timeline, HLO
    cost breakdown).  Inspect with `xprof --logdir=...`."""
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
        logger.info("device trace written to %s", logdir)


def annotate(name: str):
    """Named sub-span inside a device trace (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


def log_lambda_statistics(lambdas) -> dict:
    """λ distribution summary at stage boundaries, mirroring the
    reference's post-computation statistics block (taumode.rs:286-308)."""
    lam = np.asarray(lambdas)
    stats = {
        "min": float(lam.min()),
        "max": float(lam.max()),
        "mean": float(lam.mean()),
        "std": float(lam.std()),
        "range": float(lam.max() - lam.min()),
    }
    logger.info(
        "Lambda Statistics: min=%.6f max=%.6f mean=%.6f std=%.6f range=%.6f",
        stats["min"], stats["max"], stats["mean"], stats["std"],
        stats["range"])
    return stats
