"""Profiling and timing helpers (port of ``oscillink_tpu/utils/profiling.py``).

`trace` wraps `torch.profiler` (CPU and, when the card is in use, CUDA
activities) and writes a Chrome trace, viewable in Perfetto, where the JAX
package writes an XProf trace.  `time_fn` times a call with the card
synchronised after each call.  `device_memory_stats` reads the CUDA caching
allocator's counters.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch

from .device import DeviceLike

__all__ = ["trace", "time_fn", "device_memory_stats"]


@contextlib.contextmanager
def trace(log_dir: str, host_profile: bool = True) -> Iterator[str]:
    """Profile the block and write ``trace.json`` (Chrome trace format) into
    ``log_dir``: ``with trace(d): lat.settle()``.  Records CPU activity
    when ``host_profile`` (the JAX function's host tracer), and the card's
    kernels when CUDA is available.  Yields ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU] if host_profile else []
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(
    fn: Callable,
    *args,
    repeats: int = 10,
    warmup: int = 2,
    **kwargs,
) -> dict:
    """Median, min and max milliseconds of ``fn(*args, **kwargs)`` over
    ``repeats`` calls after ``warmup`` calls, with the card synchronised
    after each call when CUDA is in use (an eager call returns before the
    card finishes)."""
    def sync() -> None:
        # checked at each call: the timed function may be what starts CUDA
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn(*args, **kwargs)
        sync()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        sync()
        ts.append(1000.0 * (time.perf_counter() - t0))
    ts.sort()
    return {
        "median_ms": ts[len(ts) // 2],
        "min_ms": ts[0],
        "max_ms": ts[-1],
        "repeats": repeats,
    }


def device_memory_stats(device: DeviceLike = None) -> Optional[dict]:
    """Live and peak bytes the caching allocator holds on a CUDA device and
    the device's total memory; None on the CPU (and without CUDA), as the
    JAX function returns None when a backend reports nothing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }
