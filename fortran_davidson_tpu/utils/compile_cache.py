"""Persistent compilation cache for the program's entry points.

Large solver programs take tens of seconds to compile; JAX's persistent
cache keeps each compiled executable on disk so a later process with the
same program skips the compile. The cache is keyed by path, so it lives
at ONE fixed place: ``JAX_COMPILATION_CACHE_DIR`` when the environment
sets it (JAX reads that variable itself and no other directory is set),
otherwise ``.jax_cache/`` at the root of the checkout (git-ignored).

Called by the command-line entry points and ``chip_smoke.py`` /
``bench.py`` — never on library import.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir(environ=None) -> str:
    """The cache directory for this environment."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
