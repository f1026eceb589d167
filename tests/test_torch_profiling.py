"""The port's profiling helpers (`utils/profiling.py`) against the JAX
package's (``tests/test_warmup_profiling.py``'s ``time_fn`` and
``device_memory_stats`` cases), and its trace context."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu.utils import profiling as jax_profiling  # noqa: E402
from oscillink_tpu_torch import OscillinkLattice  # noqa: E402
from oscillink_tpu_torch.utils.profiling import device_memory_stats, time_fn, trace  # noqa: E402


def test_time_fn():
    x = torch.ones((64, 64), dtype=torch.float32)
    out = time_fn(lambda a: a @ a, x, repeats=3, warmup=1)
    assert out["median_ms"] >= 0.0
    assert out["repeats"] == 3
    ref = jax_profiling.time_fn(lambda a: a @ a, np.ones((64, 64), np.float32), repeats=3,
                                warmup=1)
    assert out.keys() == ref.keys()
    assert out["min_ms"] <= out["median_ms"] <= out["max_ms"]


def test_time_fn_calls_warmup_plus_repeats():
    calls = []
    time_fn(lambda: calls.append(1), repeats=4, warmup=2)
    assert len(calls) == 6


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    assert stats is None or "bytes_in_use" in stats
    # the CPU reports nothing, as a JAX backend without memory stats does
    assert device_memory_stats("cpu") is None
    ref = jax_profiling.device_memory_stats()
    assert ref is None or set(ref) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}


def test_trace_writes_a_chrome_trace_of_a_settle(tmp_path):
    rng = np.random.default_rng(0)
    lat = OscillinkLattice(rng.standard_normal((64, 16)).astype(np.float32), kneighbors=4,
                           device="cpu")
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as d:
        assert d == log_dir
        lat.settle()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the CPU plain version of K1 gathers rows with index_select
    assert any("index_select" in n for n in names), sorted(names)[:20]
    # the trace records the program's spans, by name
    assert {"lattice.settle", "cg.wait"} <= names
