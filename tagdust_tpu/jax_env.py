"""JAX as the package uses it.

Every module that runs work on a device imports ``jax`` from here, so the
persistent compilation cache is configured before the first device is
used: ``$JAX_COMPILATION_CACHE_DIR`` when that is set, otherwise
``.jax_cache`` at the root of the checkout.  The path is part of the
cache's key, so it never moves with the working directory.
"""

import os

import jax

CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

__all__ = ["jax", "CACHE_DIR"]
