"""service.p90_ms: the 90th percentile (nearest rank) of the host-clock
latency of every request issued in the window, a failed one counting as
infinite, read as ``p90_ms`` reads it: the service's tail, which spreads
too widely on its host-bound path to share a bound with the corpus cells'
``p90_ms`` (PERF.md section 2)."""

from portbench.harness import BENCH_DIR, load_module

read = load_module(BENCH_DIR / "metrics" / "p90_ms.py").read
