"""AOT precompilation (precompile.py): the warmed programs must be the
SAME executables the runtime paths dispatch to — otherwise warming is
waste.  Proven here via the persistent compilation cache: after warm(),
running the real code paths at the same shapes must add no new cache
entries for the warmed program names.

(The reference needs no analogue — rustc AOT-compiles arrowspace-rs.
This suite pins the equivalent here: deploy-time compile, serve-time
dispatch-only.)
"""

import glob
import os

import jax
import numpy as np
import pytest

from arrowspace_tpu import clustering
from arrowspace_tpu.precompile import centroid_cap_buckets, warm


def _entries(cache_dir, names):
    out = set()
    for n in names:
        out |= set(os.path.basename(p)
                   for p in glob.glob(os.path.join(cache_dir, f"jit_{n}-*")))
    return out


@pytest.fixture()
def cache_dir(tmp_path):
    """Point the persistent cache at a fresh dir for the test, restoring
    the previous configuration afterwards.  The cache singleton latches
    its directory on first use, so reset it around the redirect."""
    from jax._src import compilation_cache as cc

    prev_dir = jax.config.jax_compilation_cache_dir
    prev_min_t = jax.config.jax_persistent_cache_min_compile_time_secs
    prev_min_b = jax.config.jax_persistent_cache_min_entry_size_bytes
    cc.reset_cache()
    yield str(tmp_path)
    jax.config.update("jax_compilation_cache_dir", prev_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", prev_min_t)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", prev_min_b)
    cc.reset_cache()


def test_centroid_cap_buckets_cover_sweep_outcomes():
    # 1M x 128: k_min = 317, k_max = 318 -> single 384 bucket (the value
    # the real 1M benchmark build lands on: 317 clusters)
    assert centroid_cap_buckets(1_000_000, 128) == [384]
    # every bucket is a 128 multiple and covers [k_min, k_max_possible]
    caps = centroid_cap_buckets(20_000, 512)
    assert all(c % 128 == 0 for c in caps)
    k_min = int(np.ceil(np.sqrt(20_000 / 10.0)))
    assert caps[0] >= ((k_min + 127) // 128) * 128 - 128 + 1
    assert caps[-1] >= min(max(min(512, 2000, int(20_000 ** 0.5)),
                               k_min + 1), 10_000)


def test_warm_returns_no_failures(cache_dir):
    t = warm(4096, 32, batch_sizes=(8,), k=3, cache_path=cache_dir)
    assert t, "expected at least the session-step program"
    assert all(v >= 0 for v in t.values()), f"precompile failures: {t}"


def test_aot_matches_runtime_build_programs(cache_dir):
    """warm() then the REAL clustering device paths: no new cache entries
    for the warmed program names => identical executables (key match)."""
    n, f = 9_000, 1_024  # above DEVICE_CLUSTERING_MIN_ELEMS
    assert n * f >= clustering.DEVICE_CLUSTERING_MIN_ELEMS
    warm(n, f, batch_sizes=(), cache_path=cache_dir)
    names = ("tile", "_dist", "_segsum", "_tail")
    before = _entries(cache_dir, names)
    assert before, "warm() wrote no build-program cache entries"

    import jax.numpy as jnp
    corpus = jnp.zeros((n, f))

    # Two-NN device tiles (indices len 500 pads to 2 tiles of 256)
    rng = np.random.default_rng(0)
    clustering._twonn_two_smallest_device(corpus, rng.permutation(n)[:500])

    # chunked-scan snapshot distances + grouped sums at every cap bucket
    # the sweep allows
    for cap_k in centroid_cap_buckets(n, f):
        eng = clustering._DeviceChunkDistances(
            corpus, cap_k, clustering._device_chunk_for(n))
        cent = np.zeros((cap_k, f))
        eng(0, cent, 1)
        tgt = np.full(min(eng.chunk, n), -1, dtype=np.int32)
        tgt[:16] = 0
        eng.segment_sums(0, tgt)

        # at-cap tail program, both warmed sampler kinds
        from arrowspace_tpu.builder import SamplerType
        s = SamplerType.simple(0.6).make(seed=1)
        cnt = np.ones(cap_k, dtype=np.int64)
        eng.decide_tail(0, cent, cnt, cap_k, 0.5, s, True, cap_k)   # "simple"
        eng.decide_tail(0, cent, cnt, cap_k, 0.5, s, False, cap_k)  # "none"

    after = _entries(cache_dir, names)
    assert after == before, (
        f"runtime compiled programs the AOT warm missed: {after - before}")


def test_warm_energy_matches_runtime_chunked(cache_dir):
    """warm_energy() then the REAL chunked energy scorer at the same
    shapes: no new cache entries => identical executable."""
    from arrowspace_tpu.energymaps import _energy_score_topk_chunked
    from arrowspace_tpu.precompile import warm_energy

    n, g, b, k = 70_000, 16, 8, 3
    t = warm_energy(n, g, batch_sizes=(b,), k=k, cache_path=cache_dir)
    assert f"energy_chunked_b{b}" in t
    assert f"energy_session_b{b}" in t  # fused EnergySearchSession step
    assert all(v >= 0 for v in t.values()), f"precompile failures: {t}"
    before = _entries(cache_dir, ("energy_topk",))
    assert before, "warm_energy() wrote no chunked-program cache entry"

    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    z = jnp.asarray(rng.normal(size=(n, g)))
    lam = jnp.asarray(rng.uniform(0, 1, n))
    zq = jnp.asarray(rng.normal(size=(b, g)))
    qlam = jnp.asarray(rng.uniform(0, 1, b))
    w = jnp.asarray(1.0, z.dtype)
    s, i = _energy_score_topk_chunked(zq, qlam, z, lam, w, w, k=k)
    assert np.asarray(s).shape == (b, k) and np.asarray(i).shape == (b, k)

    after = _entries(cache_dir, ("energy_topk",))
    assert after == before, (
        f"runtime compiled a chunked program the AOT warm missed: "
        f"{after - before}")


def test_aot_matches_runtime_session_step(cache_dir):
    """warm() then a real SearchSession.warmup() at the same shapes: the
    serving step program must already be cached."""
    from arrowspace_tpu.index import ArrowIndex

    rng = np.random.default_rng(1)
    rows = rng.uniform(0.1, 1.0, (200, 16))
    index = ArrowIndex.build(rows, eps=0.5, k=6, topk=3, seed=42,
                             sampling=None)
    # warm AFTER the build so only the serving step is at stake
    warm(200, 16, batch_sizes=(8,), k=3, cache_path=cache_dir)
    before = _entries(cache_dir, ("step",))
    assert before, "warm() wrote no session-step cache entry"

    sess = index.make_search_session(batch_size=8, k=3, alpha=0.9)
    sess.warmup()
    out = list(sess.search_stream([rows[:5]]))
    assert len(out) == 1 and out[0][1].shape == (5, 3)

    after = _entries(cache_dir, ("step",))
    assert after == before, (
        f"real session compiled a step the AOT warm missed: "
        f"{after - before}")


def test_warm_bf16_session_step(cache_dir):
    """bf16 is a real session precision on every backend: warm compiles
    a bf16 step beside the f32 one."""
    t = warm(4096, 32, batch_sizes=(8,), k=3, cache_path=cache_dir,
             precisions=("f32", "bf16"))
    assert "session_step_b8_f32" in t and "session_step_b8_bf16" in t
    assert all(v >= 0 for v in t.values()), f"precompile failures: {t}"
