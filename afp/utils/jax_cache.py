"""Persistent compile cache placement for the program's entry points."""
from __future__ import annotations

import os

__all__ = ["enable_compile_cache"]

#: the checkout that holds the `afp` package
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Keep JAX's persistent compile cache where ``JAX_COMPILATION_CACHE_DIR``
    says (JAX reads that variable itself; nothing is set), or else in
    ``<checkout>/.jax_cache``.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
