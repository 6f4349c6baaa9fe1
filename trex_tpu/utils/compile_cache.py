"""Persistent XLA compile cache: one fixed place per checkout."""

from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compile cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself) and nothing else is set. Otherwise, on an accelerator, the
    cache lives at a fixed path inside the checkout (``.jax_cache/``,
    listed in ``.gitignore``): a moving directory would never hit. The CPU
    backend compiles quickly and gets no cache (None).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.default_backend() == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
