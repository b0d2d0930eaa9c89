"""Where entry-point scripts and the test suite keep JAX's persistent
compilation cache.

The library never sets a cache itself.  `chip_smoke.py`, `bench.py` and
`tests/conftest.py` call `enable()` before their first compile: the cache
goes to ``$JAX_COMPILATION_CACHE_DIR`` when that is set (and nowhere else),
otherwise to a fixed ``<repo>/.jax_cache`` (listed in .gitignore).  A fixed
path matters: the path is part of what makes a later run hit the cache.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(root: str, subdir: str = "") -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else
    ``<root>/.jax_cache[/<subdir>]``."""
    env = os.environ.get(ENV)
    if env:
        return env
    base = os.path.join(os.path.abspath(root), ".jax_cache")
    return os.path.join(base, subdir) if subdir else base


def enable(root: str, subdir: str = "") -> str:
    """Point JAX's persistent compilation cache at `cache_dir(root,
    subdir)` (created if missing) and return that directory."""
    import jax

    d = cache_dir(root, subdir)
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    return d
