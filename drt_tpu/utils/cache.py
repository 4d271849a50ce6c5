"""JAX persistent compilation cache location.

Compiling the path kernel and the XLA steps takes tens of seconds; the
persistent cache keeps them across processes. JAX keys the cache on its
directory, so the default directory is one fixed path inside the
checkout, never one built from a temporary name, a process id or the
time.
"""

from __future__ import annotations

import os
import pathlib

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Use `$JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads it
    itself, and nothing is set here); otherwise `<checkout>/.jax_cache`.
    Returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
