"""Compile-cache placement (so_jax.runtime.enable_compile_cache)."""

import os

import jax
import pytest

from so_jax import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore the process's compile-cache setting after the test: a
    cached CPU process would mis-read its own entries (runtime docstring)."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_env_var_wins(monkeypatch, tmp_path, cache_config):
    """JAX_COMPILATION_CACHE_DIR set: that is the cache, and the helper
    sets no directory of its own, on any backend."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_checkout(monkeypatch, cache_config):
    """Unset on an accelerator: <checkout>/.jax_cache, which .gitignore
    lists, and never a path under /tmp."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    got = runtime.enable_compile_cache()
    assert got == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    with open(os.path.join(ROOT, ".gitignore")) as fp:
        assert ".jax_cache/" in fp.read().split()


def test_cache_off_on_cpu(monkeypatch, cache_config):
    """Unset on the CPU backend: no cache at all."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert jax.default_backend() == "cpu"
    assert runtime.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
