"""Service warmup: pay the first request's one-time costs at startup.

The first lattice of a process builds the kernels with ``nvcc`` (or loads
them from the build directory, `utils.compile_cache`) and initializes
CUDA, cuBLAS and the caching allocator; the JAX service's counterpart
compiles its shape-keyed XLA executables (SURVEY.md §7 hard part 5).  At
startup the service runs one settle + full receipt per configured shape
so the first real request pays none of it.

  OSCILLINK_WARM_SHAPES="1024x128x6,2048x256x8"   (NxDxk, comma-separated)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

__all__ = ["warm_shapes", "run_warmup"]


def warm_shapes() -> list[tuple[int, int, int]]:
    raw = os.getenv("OSCILLINK_WARM_SHAPES", "").strip()
    shapes = []
    for part in raw.split(","):
        part = part.strip().lower()
        if not part:
            continue
        try:
            n, d, k = (int(x) for x in part.split("x"))
            shapes.append((n, d, k))
        except ValueError:
            print(f"warmup: ignoring malformed shape {part!r}", file=sys.stderr)
    return shapes


def run_warmup(verbose: bool = True, device=None) -> int:
    """Prime each configured shape on ``device`` (``cuda`` unless given);
    returns the number warmed."""
    from ..utils.compile_cache import configure_compile_cache

    configure_compile_cache()  # before the first kernel load so builds persist
    shapes = warm_shapes()
    if not shapes:
        return 0
    from ..core.lattice import OscillinkLattice

    rng = np.random.default_rng(0)
    warmed = 0
    for n, d, k in shapes:
        t0 = time.perf_counter()
        try:
            Y = rng.standard_normal((n, d)).astype(np.float32)
            lat = OscillinkLattice(Y, kneighbors=k, device=device)
            lat.set_query(rng.standard_normal(d).astype(np.float32))
            lat.settle(max_iters=2, tol=1e-2)
            # service requests default to FULL receipts — warming only the
            # light path would leave the full receipt's first-call costs for
            # the first real request
            lat.receipt()
            warmed += 1
        except Exception as e:  # best-effort priming: never abort startup
            print(f"warmup: shape {n}x{d}x{k} failed: {e}", file=sys.stderr)
            continue
        if verbose:
            print(
                f"warmup: N={n} D={d} k={k} warmed in "
                f"{time.perf_counter() - t0:.1f}s",
                file=sys.stderr,
                flush=True,
            )
    return warmed
