"""Process-level runtime settings shared by every entry point."""

from __future__ import annotations

import os

# <checkout>/.jax_cache: a fixed path beside the package (the path is part
# of the cache key, so a directory that moves never hits); .gitignore
# lists it
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compilation cache for accelerator runs and
    return its directory (None when off).

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this sets
    no other directory. Otherwise accelerator backends cache under
    DEFAULT_CACHE_DIR. The CPU backend stays uncached: its AOT loader
    rejects its own cache entries with machine-feature mismatch errors.
    Call after jax.distributed.initialize (this queries the backend)."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.default_backend() == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
