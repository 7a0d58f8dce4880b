"""Global configuration for arrowspace-tpu.

The reference implementation (arrowspace-rs) computes everything in f64 on
CPU.  On the accelerator the working dtype is configurable:

- when JAX x64 is enabled (CPU oracle / parity tests) the default dtype is
  float64, matching the reference bit-for-bit semantics;
- otherwise the default is float32, with every score and λ dot pinned to
  ``lax.Precision.HIGHEST`` (never TF32), which meets the 1e-5 relative-
  error budget of BASELINE.json for unit-scale embedding data.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp

# Floor applied to every selected tau (reference: taumode.rs:84).
TAU_FLOOR = 1e-10

# Guard for near-zero Rayleigh denominators (reference: taumode.rs:597).
DENOM_EPS = 1e-12

# Matmul precision of every f32 dot in the package.  On tensor-core GPUs
# the default lets an f32 matmul run in TF32 (~3 decimal digits; measured
# 3e-4 relative error on an H100); HIGHEST keeps true f32.  Only the
# explicit bf16 serving option trades accuracy for speed.
HIGHEST = jax.lax.Precision.HIGHEST

# Corpora whose item matrix exceeds this many bytes compute λτ in fixed
# row windows over the resident array: the single-shot path otherwise
# holds several window-sized temporaries (the x², x³, x⁴ powers and the
# (rows, n) graph products) next to the corpus.  2 GiB windows bound that
# transient at ~16 GiB, a fifth of an 80 GB card, at any N.
TAUMODE_WINDOW_BYTES = 2 << 30

# Largest (B, N) f32 score plane a full-scan step materialises.  Past it,
# ops.search.lambda_topk scans the corpus in row chunks with a running
# top-k, so a B=2048 batch over 10M rows (an 84 GB plane) streams in
# ~1 GiB pieces instead of failing for want of memory.
SCORE_PLANE_BYTES = 1 << 30

# The compile cache directory used when JAX_COMPILATION_CACHE_DIR is not
# set: one fixed directory inside the checkout (listed in .gitignore).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def default_dtype():
    """Working dtype: float64 under x64 (parity/oracle), else float32."""
    env = os.environ.get("ARROWSPACE_DTYPE")
    if env:
        return jnp.dtype(env)
    if jax.config.jax_enable_x64:
        return jnp.dtype(jnp.float64)
    return jnp.dtype(jnp.float32)


def bucket_rows(n: int, floor: int = 1024) -> int:
    """Round a row count up to a coarse bucket so a capacity-padded
    program (the live sessions) compiles once per bucket instead of once
    per corpus size.

    Schedule: identity up to `floor`; next power of two up to 262144;
    above that, multiples of an eighth of the next power of two — since
    n > p2/2, the padding is at most (p2/8)/(p2/2) = 25%, with
    logarithmically many buckets per octave.
    """
    if n <= floor:
        return n
    p2 = 1 << (n - 1).bit_length()
    if p2 <= 262144:
        return p2
    q = p2 // 8
    return ((n + q - 1) // q) * q


def setup_cache(path: Optional[str] = None) -> str:
    """Enable the persistent XLA compilation cache and return its
    directory.

    The directory is `path` when given; else JAX_COMPILATION_CACHE_DIR
    when that variable is set (JAX reads it itself, so no directory is
    set here); else DEFAULT_CACHE_DIR.  JAX's defaults skip persisting
    programs that compiled in under one second; a full build and serve
    compiles dozens of those, so everything is persisted and a fresh
    process starts at steady-state latency.  Call once at startup.
    """
    if path is None and os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = os.environ["JAX_COMPILATION_CACHE_DIR"]
    else:
        path = path or DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    # the cache singleton latches its directory on first use; reset so a
    # setup_cache() after earlier compiles still takes effect
    from jax._src import compilation_cache as _cc
    _cc.reset_cache()
    return path


def is_test_mode() -> bool:
    """Mirrors the reference's #[cfg(test)] gates (e.g. the sampling-ratio
    runtime assert in clustering.rs:896-900 is disabled in test builds)."""
    return os.environ.get("ARROWSPACE_TEST_MODE", "0") not in ("0", "", "false")
