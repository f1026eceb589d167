"""Prometheus metrics with reload-safe registration (reference main.py:97-175).

Re-registration after module reload (tests reload the app to re-read env)
must not raise — collectors are looked up in the default registry first.
"""

from __future__ import annotations

from typing import Optional

try:  # pragma: no cover — optional dependency
    from prometheus_client import (
        REGISTRY,
        Counter,
        Gauge,
        Histogram,
        generate_latest,
    )

    HAVE_PROMETHEUS = True
except Exception:  # pragma: no cover
    HAVE_PROMETHEUS = False


def _get_or_create(cls, name: str, doc: str, **kwargs):
    if not HAVE_PROMETHEUS:
        return _Noop()
    try:
        return cls(name, doc, **kwargs)
    except ValueError:
        # already registered (module reload) — find the existing collector
        for collector in list(REGISTRY._names_to_collectors.values()):
            # removesuffix, NOT rstrip: rstrip strips a character SET, so
            # e.g. 'slot_total' would become 'slot' -> 's' and the metric
            # silently degrades to a no-op after reload
            if getattr(collector, "_name", None) in (
                name,
                name.removesuffix("_total"),
            ):
                return collector
        return _Noop()


class _Noop:
    def labels(self, *a, **k):
        return self

    def inc(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass


class Metrics:
    def __init__(self) -> None:
        self.settle_counter = _get_or_create(
            Counter if HAVE_PROMETHEUS else None,
            "oscillink_settle_requests_total",
            "settle requests",
            labelnames=("status",),
        )
        self.settle_latency = _get_or_create(
            Histogram if HAVE_PROMETHEUS else None,
            "oscillink_settle_latency_seconds",
            "settle latency",
        )
        self.n_gauge = _get_or_create(
            Gauge if HAVE_PROMETHEUS else None,
            "oscillink_settle_last_n",
            "last settle N",
        )
        self.d_gauge = _get_or_create(
            Gauge if HAVE_PROMETHEUS else None,
            "oscillink_settle_last_d",
            "last settle D",
        )
        self.usage_nodes = _get_or_create(
            Counter if HAVE_PROMETHEUS else None,
            "oscillink_usage_nodes_total",
            "total nodes processed",
        )
        self.usage_units = _get_or_create(
            Counter if HAVE_PROMETHEUS else None,
            "oscillink_usage_node_dim_units_total",
            "total N*D units processed",
        )
        self.job_queue_depth = _get_or_create(
            Gauge if HAVE_PROMETHEUS else None,
            "oscillink_jobs_queue_depth",
            "queued/running jobs",
        )
        self.webhook_events = _get_or_create(
            Counter if HAVE_PROMETHEUS else None,
            "oscillink_stripe_webhook_events_total",
            "stripe webhook events",
            labelnames=("outcome",),
        )
        # governance rejections (reference PROD_READINESS checklist item:
        # "Prometheus counters for quota/monthly cap rejections" — never
        # implemented upstream); kind: quota_window / monthly_cap /
        # rate_limit / payload
        self.rejections = _get_or_create(
            Counter if HAVE_PROMETHEUS else None,
            "oscillink_governance_rejections_total",
            "requests rejected by governance checks",
            labelnames=("kind",),
        )
        # opt-in cross-request graph cache (service/graph_cache.py)
        self.graph_cache = _get_or_create(
            Counter if HAVE_PROMETHEUS else None,
            "oscillink_graph_cache_total",
            "graph cache lookups by outcome",
            labelnames=("status",),
        )

    @staticmethod
    def render() -> Optional[bytes]:
        if not HAVE_PROMETHEUS:
            return None
        return generate_latest()
