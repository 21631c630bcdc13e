"""Where the persistent XLA compile cache lives.

One rule for every entry point (tests, ``bench.py``, ``chip_smoke.py``,
``__graft_entry__``): when ``JAX_COMPILATION_CACHE_DIR`` is set, that
directory is the cache and nothing else is set in code; otherwise the cache
is ``<checkout>/.jax_cache``, derived from this package's own location. The
path is part of the cache key, so it never depends on a temporary name, a
process id or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir() -> str:
    """The directory the compile cache uses under the rule above."""
    return os.environ.get(ENV_VAR) or os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compile cache at ``cache_dir()``; returns it."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
