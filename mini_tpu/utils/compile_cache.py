"""JAX's persistent compilation cache, shared by every entry-point script.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
nothing is set in code.  Otherwise the cache lives at one fixed path,
``<repo root>/.jax_cache`` (listed in ``.gitignore``).  The path is part
of the cache's key, so it never depends on the process, the time or a
temporary directory.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__
    )))),
    ".jax_cache",
)


def compile_cache_dir(environ=None) -> str:
    """The directory the cache uses under ``environ`` (default: the
    process environment)."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir` and return
    that directory.  Call before the first compilation."""
    import jax

    d = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", d)
    return d
