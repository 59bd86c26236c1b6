"""Persistent XLA compilation cache.

Index builds and searches compile one program per padded shape bucket
(index/device_packed.py), and a serving process should pay each of
those once per machine, not once per process.  Every entry point that
jits scale-path code calls :func:`enable_persistent_cache`.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set
(it wins over any path argument, so a deployment can move the cache
without touching code), else the ``path`` argument, else the fixed
``<repo>/.cache/jax``.  The directory is part of the cache key, so it
must not move between runs.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".cache", "jax")

_enabled = False


def cache_dir(path: str | None = None) -> str:
    """The directory :func:`enable_persistent_cache` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or path \
        or DEFAULT_DIR


def enable_persistent_cache(path: str | None = None) -> str:
    """Idempotently point JAX's persistent compilation cache at
    :func:`cache_dir`.  Safe to call before or after backend
    initialization."""
    global _enabled
    d = cache_dir(path)
    if _enabled:
        return d
    import jax
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _enabled = True
    return d
