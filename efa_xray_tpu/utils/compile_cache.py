"""Where JAX keeps its persistent compilation cache for this checkout.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
nothing here overrides it.  Otherwise the cache goes to ``.jax_cache`` at
the root of the checkout (listed in ``.gitignore``), a fixed path so that
later processes in the same checkout hit it.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable(checkout: str = CHECKOUT) -> str:
    """Turn the persistent cache on; return the directory it uses."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(checkout, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
