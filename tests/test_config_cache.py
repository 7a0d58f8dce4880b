"""Compile-cache placement (config.setup_cache and tests/conftest.py):
JAX_COMPILATION_CACHE_DIR when set — with no directory set in code —
else one fixed directory inside the checkout, listed in .gitignore."""

import os
import pathlib

import jax
import pytest

from arrowspace_tpu import config

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture()
def restore_cache_config():
    from jax._src import compilation_cache as cc
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    prev = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in prev.items():
        jax.config.update(k, v)
    cc.reset_cache()


def test_setup_cache_honours_env_var(monkeypatch, tmp_path,
                                     restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert config.setup_cache() == str(tmp_path)
    # no directory is set in code: JAX itself reads the variable
    assert jax.config.jax_compilation_cache_dir == before
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_setup_cache_default_dir_inside_checkout(monkeypatch,
                                                restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.setup_cache()
    assert path == config.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert pathlib.Path(path).parent == REPO
    ignored = (REPO / ".gitignore").read_text().split()
    assert pathlib.Path(path).name + "/" in ignored


def test_setup_cache_explicit_path(monkeypatch, tmp_path,
                                   restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent")
    assert config.setup_cache(str(tmp_path)) == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_conftest_follows_the_cache_rule():
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        assert jax.config.jax_compilation_cache_dir in (env, None)
    else:
        assert jax.config.jax_compilation_cache_dir == \
            config.DEFAULT_CACHE_DIR
