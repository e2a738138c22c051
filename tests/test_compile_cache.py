"""The persistent compile cache rule (utils/compile_cache.py)."""

from pathlib import Path

import jax

from jetracer_orbslam2_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def test_env_var_wins():
    env = {"JAX_COMPILATION_CACHE_DIR": "/data/jax-cache"}
    assert compile_cache.cache_dir(env) == ("/data/jax-cache", True)


def test_default_is_fixed_dir_in_checkout():
    path, from_env = compile_cache.cache_dir({})
    assert not from_env
    assert Path(path) == REPO / ".jax_cache"
    # the same path every time: no pid, time or temporary name in it
    assert compile_cache.cache_dir({}) == (path, False)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_configure_sets_nothing_when_env_is_set(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/data/jax-cache")
    try:
        assert compile_cache.configure_compile_cache() == "/data/jax-cache"
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_configure_points_jax_at_checkout_cache(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.configure_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
