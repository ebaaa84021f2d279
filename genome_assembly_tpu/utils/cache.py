"""Persistent XLA compilation cache setup.

K/M/shape combinations are static arguments to the jitted kernels, so every
new configuration triggers a compile; caching them on disk makes repeat runs
(tests, CLI invocations) start in milliseconds instead of tens of seconds.

The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads
it itself, so nothing here overrides it); otherwise one fixed directory
inside the checkout, ``.jax_cache/`` (gitignored).  The path is part of a
cache entry's identity, so it never varies between runs.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> pathlib.Path:
    """The compile-cache directory this process uses."""
    env = os.environ.get(ENV_VAR)
    return pathlib.Path(env) if env else CHECKOUT_CACHE


def enable_compilation_cache() -> None:
    """Idempotently point JAX at the persistent compilation cache."""
    import jax

    if not os.environ.get(ENV_VAR):
        CHECKOUT_CACHE.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
