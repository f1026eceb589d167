"""Profiling and timing helpers (port of ``oscillink_tpu/utils/profiling.py``).

`trace` wraps `torch.profiler` (CPU and, when the card is in use, CUDA
activities) and writes a Chrome trace, viewable in Perfetto, where the JAX
package writes an XProf trace.  `time_fn` times a call with the card
synchronised after each call.  `device_memory_stats` reads the CUDA caching
allocator's counters.

The program's spans.  `span(name)` marks a stretch of the program's host
work (the names are `SPANS`); `recording()` keeps the spans of its block in
a `SpanRecorder`.  Each span holds its name, its start and end on
``time.perf_counter_ns()``, its parent (the span open on the same thread
when it began) and a trace id that every span under one root shares (a
service request's is its ``X-Request-ID``).  While a `torch.profiler`
session runs, a recorded span also enters ``record_function(name)``, so it
sits on the profiler's host timeline, on the clock of the device's
kernels.  `trace` records for its block, so its Chrome trace shows the
spans.  Outside `recording()`, `span` returns one shared no-op context
after one check: no string, no allocation, no profiler call.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, Iterator, Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from .device import DeviceLike

__all__ = ["trace", "time_fn", "device_memory_stats", "span", "recording", "SpanRecorder",
           "Span", "SPANS", "SPAN_CAPACITY"]

# The program's span names, by layer.  `lattice.ustar`, `lattice.settle`
# and `lattice.ustar_batch` cover the intervals of
# ``last_ustar["solve_ms"]``, ``last["t_ms"]`` and
# ``last_ustar_batch["solve_ms"]``; `bundle.scores` and `bundle.mmr` sit
# under `lattice.bundle` and `lattice.bundle_batch` alike; `cg.wait` is
# each CG iteration's one host read of its residual; `lattice.graph` is a
# lattice's graph build, the IVF stages and `graph.topk` (the exact or fast
# scan's top-k, whichever route `ops.graph.build_graph` takes) under it.
SPANS = (
    "lattice.set_query", "lattice.signature", "lattice.ustar", "lattice.settle",
    "lattice.receipt", "receipt.energy", "receipt.nulls",
    "lattice.bundle", "bundle.scores", "bundle.mmr",
    "lattice.bundle_batch", "lattice.ustar_batch",
    "lattice.graph", "graph.topk", "ivf.pregate", "ivf.kmeans", "ivf.scan", "ivf.quality",
    "cg.wait",
    "service.request", "service.decode", "service.validate", "service.arrays",
    "service.build", "service.settle", "service.bundle",
)

# Spans a recorder keeps; beyond it the oldest are dropped and counted.
SPAN_CAPACITY = 1 << 16


class Span:
    """One finished span: ``name``, ``span_id``, ``parent`` (the enclosing
    span's id or None), ``trace_id`` and ``start_ns`` / ``end_ns``
    (``time.perf_counter_ns()``)."""

    __slots__ = ("name", "span_id", "parent", "trace_id", "start_ns", "end_ns")

    def __init__(self, name: str, span_id: int, parent: Optional[int], trace_id) -> None:
        self.name, self.span_id, self.parent, self.trace_id = name, span_id, parent, trace_id
        self.start_ns = self.end_ns = 0

    @property
    def ms(self) -> float:
        return 1e-6 * (self.end_ns - self.start_ns)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Span({self.name!r}, id={self.span_id}, parent={self.parent}, "
                f"trace={self.trace_id!r}, {self.ms:.3f} ms)")


class SpanRecorder:
    """The finished spans of a `recording()` block, oldest first, at most
    `SPAN_CAPACITY` of them; ``dropped`` counts the older ones let go."""

    def __init__(self) -> None:
        self._done: deque = deque(maxlen=SPAN_CAPACITY)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()  # each thread's stack of open spans
        self.dropped = 0

    @property
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._done)

    def clear(self) -> None:
        with self._lock:
            self._done.clear()
            self.dropped = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _finish(self, s: Span) -> None:
        with self._lock:
            if len(self._done) == SPAN_CAPACITY:
                self.dropped += 1
            self._done.append(s)


class _Open:
    """A recorded span, from its entry to its exit."""

    __slots__ = ("rec", "name", "trace_id", "span", "rf")

    def __init__(self, rec: SpanRecorder, name: str, trace_id) -> None:
        self.rec, self.name, self.trace_id = rec, name, trace_id
        self.span = self.rf = None

    def __enter__(self) -> Span:
        stack = self.rec._stack()
        top = stack[-1] if stack else None
        sid = next(self.rec._ids)
        trace_id = self.trace_id
        if trace_id is None:
            trace_id = sid if top is None else top.trace_id
        s = self.span = Span(self.name, sid, None if top is None else top.span_id, trace_id)
        stack.append(s)
        if _profiler_enabled():
            self.rf = record_function(s.name)
            self.rf.__enter__()
        s.start_ns = time.perf_counter_ns()
        return s

    def __exit__(self, *exc) -> None:
        s = self.span
        s.end_ns = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._stack().pop()
        self.rec._finish(s)


_NOOP = contextlib.nullcontext()
_recorder: Optional[SpanRecorder] = None


def span(name: str, trace_id=None):
    """A context that records the span ``name`` while `recording()` is on,
    else the shared no-op.  ``trace_id`` names the trace of this span and
    those under it (a root span without one takes its own id)."""
    rec = _recorder
    if rec is None:
        return _NOOP
    return _Open(rec, name, trace_id)


@contextlib.contextmanager
def recording() -> Iterator[SpanRecorder]:
    """Record the block's spans, those of every thread; yields the recorder.
    Inside a block that already records, yields that block's recorder.
    Enter and leave it from one thread at a time."""
    global _recorder
    if _recorder is not None:
        yield _recorder
        return
    _recorder = SpanRecorder()
    try:
        yield _recorder
    finally:
        _recorder = None


@contextlib.contextmanager
def trace(log_dir: str, host_profile: bool = True) -> Iterator[str]:
    """Profile the block and write ``trace.json`` (Chrome trace format) into
    ``log_dir``: ``with trace(d): lat.settle()``.  Records CPU activity
    when ``host_profile`` (the JAX function's host tracer), and the card's
    kernels when CUDA is available; the program's spans are recorded
    (`recording`) and appear in it by name.  Yields ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU] if host_profile else []
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with recording():
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
