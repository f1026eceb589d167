"""Persistent kernel-build directory: the port's stand-in for the JAX
package's persistent XLA compilation cache (``oscillink_tpu/utils/
compile_cache.py``).

The port compiles each CUDA source with ``nvcc`` at first use and keeps
the library under `ops.kernels.build.BUILD_DIR`, keyed by a hash of the
source and the flags (``ops/kernels/build.py``).  A fresh serving process
that finds a library of the same hash there loads it and runs no ``nvcc``,
which is what the persistent cache does for the JAX service.  This module
wires that directory from the same environment variable:

  OSCILLINK_COMPILE_CACHE_DIR   directory for the built kernels.
                                Empty/unset -> the build directory stays
                                `build.BUILD_DIR`'s default (the checkout's
                                ``build/oscillink_tpu_torch/``, or the
                                user's cache directory for an installed
                                copy).

``OSCILLINK_COMPILE_CACHE_MIN_S`` and ``JAX_COMPILATION_CACHE_DIR`` tune
XLA's cache and have no counterpart here: every library is kept.

`configure_compile_cache()` is idempotent.  It must run before the first
kernel library is loaded, since a loaded library stays loaded: the service
entry points (`service.api.create_state`, `service.warmup.run_warmup`) call
it before they build any lattice.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

__all__ = ["configure_compile_cache"]

_configured: Optional[str] = None


def configure_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Point the kernel build directory at ``cache_dir`` or
    ``OSCILLINK_COMPILE_CACHE_DIR``; returns the directory, or None when
    neither is set or the directory cannot be created (the build directory
    is then left as it was)."""
    global _configured
    resolved = cache_dir or os.getenv("OSCILLINK_COMPILE_CACHE_DIR", "").strip() or None
    if resolved is None:
        return None
    if _configured == resolved:
        return resolved
    try:
        os.makedirs(resolved, exist_ok=True)
    except OSError as e:
        # an unwritable cache dir must degrade to "no cache", never crash
        # service startup (a read-only rootfs or a non-root user)
        logging.getLogger("oscillink.compile_cache").warning(
            "compile cache disabled: cannot create %s (%s)", resolved, e
        )
        return None
    from ..ops.kernels import build

    build.BUILD_DIR = Path(resolved)
    _configured = resolved
    return resolved
