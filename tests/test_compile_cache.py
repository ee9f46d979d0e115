"""The persistent compile cache's location (utils/compile_cache.py):
JAX_COMPILATION_CACHE_DIR when set, else a fixed path in the checkout."""
import os

import jax

from libpll2_jax.utils import compile_cache


def test_cache_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(checkout, ".jax_cache")
    try:
        # the same path whatever the working directory
        monkeypatch.chdir("/")
        assert compile_cache.cache_dir() == want
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
