"""Adaptive per-key parameter profiles (reference cloud/app/learners.py).

Behavioral contract:
  * overrides clipped to safe bounds — lamG [0.5, 2], lamC [0.1, 2.5],
    lamQ [1, 8], kneighbors [1, 64] (learners.py:96-102);
  * epsilon-greedy exploration with multiplicative jitter on lambdas and
    ±1 jitter on k (learners.py:148-192), exploration floor
    OSCILLINK_ADAPTIVE_EPS_FLOOR;
  * EMA score = -duration_ms - 100 * residual with promotion guardrails:
    min observations (default 500, heavy 5000 when k changes), minimum
    seconds between promotions (default 900) (learners.py:195-320).

Storage is a pluggable `ProfileStore`; in-memory by default (the reference
uses Firestore — same document shape, see `MemoryProfileStore.doc`).
"""

from __future__ import annotations

import os
import random
import time
from typing import Any, Dict, Optional, Tuple

__all__ = ["Learners", "MemoryProfileStore"]

_BOUNDS: dict[str, tuple[float, float]] = {
    "lamG": (0.5, 2.0),
    "lamC": (0.1, 2.5),
    "lamQ": (1.0, 8.0),
    "kneighbors": (1, 64),
}


def _flag(name: str) -> bool:
    return os.getenv(name, "0").lower() in {"1", "true", "on", "yes"}


def _fenv(name: str, default: float, lo: float = 0.0, hi: float = 1e18) -> float:
    try:
        return max(lo, min(hi, float(os.getenv(name, str(default)))))
    except Exception:
        return default


def _clip(name: str, val: Any) -> Any:
    if name not in _BOUNDS:
        return val
    lo, hi = _BOUNDS[name]
    try:
        if name == "kneighbors":
            return int(max(lo, min(hi, int(val))))
        return float(max(lo, min(hi, float(val))))
    except Exception:
        return None


class MemoryProfileStore:
    """Per-key learned-profile documents (same shape as the reference's
    Firestore docs: active_profile_id, learned_params, ema_score, obs_count,
    last_promoted_at, last_observation)."""

    def __init__(self) -> None:
        self._docs: Dict[str, dict] = {}

    def get(self, api_key: str) -> Optional[dict]:
        return self._docs.get(api_key)

    def set(self, api_key: str, doc: dict) -> None:
        self._docs[api_key] = doc


class Learners:
    def __init__(self, store: Optional[MemoryProfileStore] = None) -> None:
        if store is None:
            # Firestore when OSCILLINK_LEARNERS_COLLECTION is set and the
            # client lib is importable (reference learners.py:127-145);
            # silent memory fallback otherwise.
            from ._firestore_stores import make_profile_store

            store = make_profile_store()
        self.store = store or MemoryProfileStore()

    # -- config ----------------------------------------------------------

    @staticmethod
    def enabled() -> bool:
        return _flag("OSCILLINK_ADAPTIVE_PROFILES")

    @staticmethod
    def learn_enabled() -> bool:
        return _flag("OSCILLINK_ADAPTIVE_LEARN")

    # -- read path -------------------------------------------------------

    def get_active_profile(self, api_key: Optional[str]) -> Tuple[str, Dict[str, Any]]:
        if not self.enabled() or not api_key:
            return "baseline", {}
        doc = self.store.get(api_key)
        if not doc:
            return "baseline", {}
        prof_id = str(doc.get("active_profile_id") or "default")
        lp = doc.get("learned_params") or {}
        out: Dict[str, Any] = {}
        for k in ("lamG", "lamC", "lamQ", "kneighbors"):
            if k in lp:
                cv = _clip(k, lp[k])
                if cv is not None:
                    out[k] = cv
        return prof_id, out

    def propose_overrides(
        self, api_key: Optional[str], base: Optional[Dict[str, Any]] = None
    ) -> Tuple[str, Dict[str, Any]]:
        prof_id, overrides = self.get_active_profile(api_key)
        # exploration requires BOTH flags, like record_observation —
        # otherwise requests get randomly jittered (eps floor >= 2%)
        # while the write path never learns from it
        if not (self.enabled() and self.learn_enabled()) or not api_key:
            return prof_id, overrides
        working = {
            "lamG": overrides.get("lamG", (base or {}).get("lamG", 1.0)),
            "lamC": overrides.get("lamC", (base or {}).get("lamC", 0.5)),
            "lamQ": overrides.get("lamQ", (base or {}).get("lamQ", 4.0)),
            "kneighbors": overrides.get("kneighbors", (base or {}).get("kneighbors", 6)),
        }
        eps = max(
            _fenv("OSCILLINK_ADAPTIVE_EPS", 0.1, 0.0, 1.0),
            _fenv("OSCILLINK_ADAPTIVE_EPS_FLOOR", 0.02, 0.0, 1.0),
        )
        if random.random() < eps:
            jitter = lambda x, s=0.15: float(x) * max(  # noqa: E731
                0.5, min(2.0, 1.0 + random.uniform(-s, s))
            )
            return "explore", {
                "lamG": _clip("lamG", jitter(working["lamG"])),
                "lamC": _clip("lamC", jitter(working["lamC"])),
                "lamQ": _clip("lamQ", jitter(working["lamQ"])),
                "kneighbors": _clip(
                    "kneighbors", int(working["kneighbors"]) + random.choice([-1, 0, 1])
                ),
            }
        return prof_id, overrides

    # -- write path ------------------------------------------------------

    def record_observation(
        self,
        api_key: Optional[str],
        profile_id: str,
        overrides: Dict[str, Any],
        metrics: Dict[str, Any],
    ) -> None:
        """EMA-update the learned profile; promote only past guardrails."""
        if not (self.enabled() and self.learn_enabled()) or not api_key:
            return
        try:
            alpha = _fenv("OSCILLINK_ADAPTIVE_ALPHA", 0.2, 0.0, 1.0)
            # _fenv falls back on a malformed value; a bare float() here
            # raised into the blanket except and silently disabled ALL
            # learning when e.g. OSCILLINK_ADAPTIVE_MARGIN='5%'
            margin = _fenv("OSCILLINK_ADAPTIVE_MARGIN", 0.0, -1e18)
            min_obs = int(_fenv("OSCILLINK_ADAPTIVE_MIN_OBS", 500, 1))
            heavy_min_obs = int(
                _fenv("OSCILLINK_ADAPTIVE_HEAVY_PROMOTE_MIN_OBS", 5000, 1)
            )
            min_promote_sec = _fenv("OSCILLINK_ADAPTIVE_MIN_PROMOTE_SEC", 900.0, 0.0)

            score = -float(metrics.get("duration_ms", 0.0)) - 100.0 * float(
                metrics.get("residual", 0.0)
            )
            doc = self.store.get(api_key) or {
                "active_profile_id": "default",
                "learned_params": {},
                "ema_score": None,
                "obs_count": 0,
                "last_promoted_at": 0.0,
            }
            doc["obs_count"] = int(doc.get("obs_count", 0)) + 1
            doc["last_observation"] = {
                "ts": time.time(),
                "metrics": dict(metrics),
                "overrides": dict(overrides),
            }
            prev = doc.get("ema_score")
            ema = score if prev is None else (1 - alpha) * float(prev) + alpha * score
            doc["ema_score"] = ema

            # promotion: exploratory params adopted only when the observation
            # beats the EMA by `margin` AND guardrails pass.  "Heavy" means
            # the proposal CHANGES the effective k — comparing against
            # learned_params alone misfires for fresh profiles (k absent ->
            # every promotion counted heavy and min_obs was unreachable)
            current_k = (doc.get("learned_params") or {}).get("kneighbors", 6)
            heavy = (
                "kneighbors" in overrides
                and overrides.get("kneighbors") != current_k
            )
            need_obs = heavy_min_obs if heavy else min_obs
            can_promote = (
                profile_id == "explore"
                and doc["obs_count"] >= need_obs
                and (time.time() - float(doc.get("last_promoted_at", 0.0)))
                >= min_promote_sec
                and (prev is None or score > float(prev) + margin)
            )
            if can_promote:
                lp = dict(doc.get("learned_params") or {})
                for k, v in overrides.items():
                    cv = _clip(k, v)
                    if cv is not None:
                        lp[k] = cv
                doc["learned_params"] = lp
                doc["active_profile_id"] = f"p-{time.strftime('%Y-%m-%d')}"
                doc["last_promoted_at"] = time.time()
            doc["updated_at"] = time.time()
            self.store.set(api_key, doc)
        except Exception:
            pass  # learning must never break the request path
