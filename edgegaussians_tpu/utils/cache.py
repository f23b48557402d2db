"""Persistent XLA compilation cache setup.

Later processes reuse the compiled programs of earlier ones. Called by the
CLIs, ``bench.py`` and ``chip_smoke.py``.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory. Otherwise the cache lives at the fixed path
``<checkout>/.jax_cache`` (listed in ``.gitignore``): the path is part of
what makes a later process find the entries again, so it never depends on
the home directory, a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The cache directory in effect: the environment's, else the
    checkout's fixed default."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
