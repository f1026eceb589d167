"""Tier catalog + Stripe price mapping (reference cloud/app/billing.py:37-130).

Monthly unit caps (units = N*D per request): free 5M / beta 25M / pro 50M /
enterprise unlimited.  Price->tier map comes from OSCILLINK_STRIPE_PRICE_MAP
(JSON or 'price_x:tier;price_y:tier' string) with sensible defaults.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

__all__ = ["TierInfo", "TIERS", "tier_info", "price_map", "resolve_tier_from_subscription"]


@dataclass(frozen=True)
class TierInfo:
    name: str
    monthly_unit_cap: int  # 0 = unlimited
    description: str = ""


TIERS: dict[str, TierInfo] = {
    "free": TierInfo("free", 5_000_000, "community tier"),
    "beta": TierInfo("beta", 25_000_000, "beta program"),
    "pro": TierInfo("pro", 50_000_000, "professional"),
    "enterprise": TierInfo("enterprise", 0, "enterprise (unlimited, priority)"),
}


def tier_info(name: Optional[str]) -> TierInfo:
    return TIERS.get((name or "free").lower(), TIERS["free"])


def price_map() -> dict[str, str]:
    """Stripe price-id -> tier name."""
    raw = os.getenv("OSCILLINK_STRIPE_PRICE_MAP", "").strip()
    out: dict[str, str] = {}
    if raw:
        try:
            if raw.startswith("{"):
                parsed = json.loads(raw)
                out = {str(k): str(v) for k, v in parsed.items()}
            else:
                for part in raw.split(";"):
                    if ":" in part:
                        pid, tier = part.split(":", 1)
                        out[pid.strip()] = tier.strip()
        except Exception:
            out = {}
    return out


def resolve_tier_from_subscription(subscription: dict, default: str = "free"):
    """Map a Stripe subscription object's price ids to a tier (first match).

    ``default`` is returned when no price id maps (reference semantics,
    billing.py:111-130).  Pass ``default=None`` to DETECT the unmapped
    case — the webhook uses that to keep a key's existing tier instead of
    silently downgrading a paying customer on a renewal event whose price
    id is missing from OSCILLINK_STRIPE_PRICE_MAP."""
    pm = price_map()
    try:
        items = subscription.get("items", {}).get("data", [])
        for item in items:
            pid = (item.get("price") or {}).get("id")
            if pid and pid in pm:
                return pm[pid]
    except Exception:
        pass
    return default
