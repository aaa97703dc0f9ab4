"""Compile-cache directory rule (texturefusion_tpu/utils/cache.py)."""

import os

from texturefusion_tpu.utils import cache


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(checkout, ".jax_cache")


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compilation_cache() == str(tmp_path / "jc")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "jc")
        assert os.path.isdir(tmp_path / "jc")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
