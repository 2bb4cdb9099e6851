"""The on-disk cache of the port's compiled kernels (port of
``repro.common.cache``, which points JAX's persistent compilation cache
at a directory).

The port's only compiled artefacts are the ``nvcc`` libraries of
``repro_torch.kernels.build``, named by a hash of their source, headers
and flags.  By default they are built into ``build/kernels/`` at the
repository root, at first use.  ``enable_compilation_cache()`` points the
build at ``$REPRO_CACHE_DIR/cuda_kernels`` (default
``.cache/cuda_kernels``, the root ``repro_torch.core.sweep`` persists its
calibrations under), so processes, and runs that keep the directory,
load a library built once; ``REPRO_COMPILATION_CACHE=0`` turns it off.
"""
from __future__ import annotations

import os
from pathlib import Path


def default_cache_dir() -> str:
    return os.path.join(os.environ.get("REPRO_CACHE_DIR", ".cache"),
                        "cuda_kernels")


def enable_compilation_cache(cache_dir: str | None = None) -> str | None:
    """Build and load the kernels' libraries under ``cache_dir`` (default
    ``default_cache_dir()``).  Returns the directory in use, or None when
    disabled (``REPRO_COMPILATION_CACHE=0``) or unwritable.  Safe to call
    more than once; the last directory wins."""
    if os.environ.get("REPRO_COMPILATION_CACHE", "1") == "0":
        return None
    from repro_torch.kernels import build
    cache_dir = cache_dir or default_cache_dir()
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None
    build.BUILD_DIR = Path(cache_dir)
    return cache_dir


def compilation_cache_entries(cache_dir: str | None = None) -> int:
    """The number of built kernel libraries in the cache directory."""
    cache_dir = cache_dir or default_cache_dir()
    try:
        return sum(1 for n in os.listdir(cache_dir)
                   if n.startswith("lib") and n.endswith(".so"))
    except OSError:
        return 0
