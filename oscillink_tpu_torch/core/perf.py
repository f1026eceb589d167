"""Benchmark aggregate comparator (behavioral counterpart of the reference's
core/perf.py:6-26): flags metrics whose mean regressed past a tolerance.
The port's own copy of ``oscillink_tpu/core/perf.py``: the same dicts for
the same reports.

Input objects carry ``{"aggregates": {<metric>: {"mean": <float>}}}`` — the
shape produced by scripts/benchmark.py and scripts/perf_snapshot.py.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

__all__ = ["compare_perf", "DEFAULT_METRICS"]

DEFAULT_METRICS: tuple[str, ...] = ("build_ms", "settle_ms", "receipt_ms")


def _mean_of(report: Dict[str, Any], metric: str) -> float:
    return float(report["aggregates"][metric]["mean"])


def compare_perf(
    baseline: Dict[str, Any],
    current: Dict[str, Any],
    metrics: Optional[Sequence[str]] = None,
    tolerance_pct: float = 20.0,
) -> Dict[str, Any]:
    """Percentage deviation per metric + the list that breached tolerance.

    Non-positive baseline means are skipped (uninitialized placeholders).
    A positive deviation means "slower than baseline".
    """
    selected = tuple(metrics) if metrics is not None else DEFAULT_METRICS

    deviations: Dict[str, float] = {}
    for metric in selected:
        base_mean = _mean_of(baseline, metric)
        if base_mean <= 0:
            continue
        deviations[metric] = 100.0 * (_mean_of(current, metric) - base_mean) / base_mean

    failures = [
        {
            "metric": metric,
            "pct": pct,
            "baseline": _mean_of(baseline, metric),
            "current": _mean_of(current, metric),
        }
        for metric, pct in deviations.items()
        if pct > tolerance_pct
    ]
    return {
        "deviations": deviations,
        "failures": failures,
        "tolerance_pct": tolerance_pct,
    }
