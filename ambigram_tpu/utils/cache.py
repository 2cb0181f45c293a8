"""Persistent XLA compilation cache.

The device search compiles one program per (padded-vars, padded-rows)
bucket, and each cold compile costs seconds. JAX's persistent cache
makes that once per checkout instead of once per process. Where
`JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing here
overrides it; otherwise the cache lives at one fixed path inside the
checkout. The path is part of every entry's lookup, so it must never be
derived from a temp name, a PID or a time: a moving directory never
hits.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return the
    directory in use ("" when the checkout is read-only)."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env_dir:
        try:
            os.makedirs(CACHE_DIR, exist_ok=True)
        except OSError:
            return ""
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # only executables that took real time to build are worth disk
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return env_dir or CACHE_DIR
