"""Persistent XLA compilation cache setup.

A search compiles one sweep program per chunk-shape group, and a cold
process pays those compiles again; JAX's persistent compilation cache turns
a repeat compile into a disk load. Enabled automatically by
SearchEngine/api unless LIBSSA_NO_COMPILE_CACHE is set.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and no directory
  is set in code.
* Otherwise: ``<checkout>/.jax_cache``, a fixed path inside the checkout
  (listed in ``.gitignore``). The path is part of the cache key, so it must
  not move between runs; a checkout that is not writable gets no cache.

The cache is skipped on the CPU backend. XLA:CPU entries are
ahead-of-time machine code for the WRITER's exact CPU feature set; loading
an entry written on another host warns of unsupported target features that
can SIGILL, and XLA:CPU executable serialization itself segfaulted
mid-suite on some hosts. CPU compiles are local and fast, so the cache buys
nothing there. GPU executables are compiled for the card, not the host.
"""
from __future__ import annotations

import os

_done = False


def cache_dir() -> str:
    """The in-checkout cache path used when no env var names one."""
    here = os.path.dirname(os.path.abspath(__file__))  # libssa_tpu/util
    return os.path.join(os.path.dirname(os.path.dirname(here)), ".jax_cache")


def enable_compilation_cache() -> None:
    global _done
    if _done or os.environ.get("LIBSSA_NO_COMPILE_CACHE"):
        return
    import jax

    if jax.default_backend() == "cpu":
        _done = True
        return  # see module docstring: CPU AOT caching is unsafe here
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = cache_dir()
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            _done = True
            return  # read-only checkout: run uncached
        if not os.access(path, os.W_OK):
            _done = True
            return
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _done = True
