"""Persistent XLA compilation cache.

The reference's torch_xla stack re-traces and re-compiles its lazy-tensor
graphs on every process start (SURVEY §1 L0); the JAX rebuild compiles once
per jit signature, and this module makes those executables survive process
restarts: resumed/preempted runs (train/checkpoint.py's preemption path) skip
the first compile of the train and eval steps entirely.

Where the cache lives, in order:

1. ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself; no
   other directory is set),
2. the directory the caller names (``train.compilation_cache_dir``, the
   CLI's ``--compilation-cache``),
3. ``.xla_cache/`` at the checkout root.

The path is part of every entry's key, so it is fixed: never derived from
a temp name, a PID or the time. Local directories and gs:// paths both
work (the cache writes through jax's pluggable filesystem layer).
"""

from __future__ import annotations

import os
from typing import Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".xla_cache")


def cache_dir(explicit: Optional[str] = None) -> str:
    """The directory the cache uses: the env var, else ``explicit``, else
    :data:`DEFAULT_DIR`."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    if explicit:
        return (explicit if explicit.startswith("gs://")
                else os.path.abspath(os.path.expanduser(explicit)))
    return DEFAULT_DIR


def enable_compilation_cache(explicit: Optional[str] = None) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return that directory.

    Thresholds are set so every entry is cached — the train step is always
    worth keeping, and tiny helper jits are cheap to store. A process that
    already opened the cache at another directory is re-pointed (JAX opens
    its cache once, at the first compile after a directory is set).
    """
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc

    path = cache_dir(explicit)
    if not path.startswith("gs://"):
        os.makedirs(path, exist_ok=True)
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
        cc.reset_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
