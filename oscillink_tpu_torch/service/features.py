"""Tier -> feature resolution (reference cloud/app/features.py:15-74).

Static tier defaults, overlaid by per-key metadata.features, overlaid by
OSCILLINK_FEAT_* environment flags (license-entitlement exports).
"""

from __future__ import annotations

import os
from typing import Optional

from .keystore import KeyMetadata

__all__ = ["TIER_FEATURES", "DEFAULT_TIER", "FeatureBundle", "resolve_features"]

TIER_FEATURES: dict[str, dict[str, bool]] = {
    "free": {
        "diffusion_gates": False,
        "async_jobs": True,
        "signed_usage": False,
        "priority_queue": False,
    },
    "beta": {
        "diffusion_gates": True,
        "async_jobs": True,
        "signed_usage": True,
        "priority_queue": False,
    },
    "pro": {
        "diffusion_gates": True,
        "async_jobs": True,
        "signed_usage": True,
        "priority_queue": False,
    },
    "enterprise": {
        "diffusion_gates": True,
        "async_jobs": True,
        "signed_usage": True,
        "priority_queue": True,
    },
}

DEFAULT_TIER = "free"

_TRUTHY = {"1", "true", "TRUE", "on", "On", "yes", "YES"}


class FeatureBundle(dict):
    @property
    def diffusion_allowed(self) -> bool:
        return bool(self.get("diffusion_gates"))


def resolve_features(meta: Optional[KeyMetadata]) -> FeatureBundle:
    tier = (meta.tier if meta and meta.tier else DEFAULT_TIER)
    base = dict(TIER_FEATURES.get(tier, TIER_FEATURES[DEFAULT_TIER]))
    if meta and meta.features:
        base.update(meta.features)
    for k in list(base.keys()):
        v = os.getenv(f"OSCILLINK_FEAT_{str(k).upper()}")
        if v is not None:
            base[k] = v in _TRUTHY
    fb = FeatureBundle(base)
    fb["tier"] = tier
    return fb
