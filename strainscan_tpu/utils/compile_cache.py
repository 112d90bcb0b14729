"""Persistent XLA compilation cache setup (shared by the CLI and the
library entry points).

Repeat identify runs skip the one-time jit compiles by pointing JAX at a
persistent on-disk cache.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing here overrides it; otherwise the cache lives
at one fixed directory inside the checkout (:data:`DEFAULT_DIR`, listed
in ``.gitignore``).  A fixed path matters: the directory is part of what
a later process must find again.
"""

from __future__ import annotations

import logging
import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_DONE = False


def cache_dir() -> str | None:
    """The directory this module would configure, or None when the
    environment variable already names one."""
    return None if os.environ.get(ENV_VAR) else DEFAULT_DIR


def enable_compile_cache() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax

    loc = cache_dir()
    if loc is not None:
        try:
            os.makedirs(loc, exist_ok=True)
        except OSError as e:  # read-only checkout: run without the cache
            logging.warning("compilation cache disabled: %s", e)
            return
        jax.config.update("jax_compilation_cache_dir", loc)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
