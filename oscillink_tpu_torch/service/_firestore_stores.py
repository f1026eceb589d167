"""Firestore persistence adapters for learners, monthly caps, and webhook
events (reference contracts: cloud/app/learners.py:127-145 profile docs,
cloud/app/main.py:202-244 transactional monthly usage,
cloud/app/services/events.py:14-72 idempotent event store).

Like `_firestore.py` (keystore), these activate only when their collection
env var is set AND google-cloud-firestore is importable; every failure
degrades to the in-memory behavior (SURVEY.md §5.3 defensive degradation).
The adapters are exercised against an in-memory fake client in
tests/test_firestore_stores.py — the fake implements the exact subset of the
Firestore API used here (document get/set/create, transactions, streams).

Env vars (reference names):
  OSCILLINK_LEARNERS_COLLECTION        — adaptive profile docs, id = api key
  OSCILLINK_MONTHLY_USAGE_COLLECTION   — usage docs, id = "{api_key}:{period}"
  OSCILLINK_WEBHOOK_EVENTS_COLLECTION  — Stripe event docs, id = event id
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

__all__ = [
    "FirestoreProfileStore",
    "FirestoreMonthlyPersistence",
    "FirestoreEventStore",
    "make_profile_store",
    "make_monthly_persistence",
    "make_event_store",
]


def _client():
    from google.cloud import firestore  # type: ignore

    return firestore.Client()


class FirestoreProfileStore:
    """Adaptive-profile documents, same shape as `MemoryProfileStore`
    (active_profile_id, learned_params, ema_score, obs_count,
    last_promoted_at, last_observation) — reference learners.py:127-145."""

    def __init__(self, collection: Optional[str] = None) -> None:
        self._collection = collection or os.getenv(
            "OSCILLINK_LEARNERS_COLLECTION", ""
        ).strip()
        if not self._collection:
            raise ValueError("OSCILLINK_LEARNERS_COLLECTION not set")
        self._cl = _client()

    def get(self, api_key: str) -> Optional[dict]:
        try:
            snap = self._cl.collection(self._collection).document(api_key).get()
        except Exception:
            return None
        if not getattr(snap, "exists", False):
            return None
        return snap.to_dict() or None

    def set(self, api_key: str, doc: dict) -> None:
        try:
            self._cl.collection(self._collection).document(api_key).set(
                dict(doc), merge=False
            )
        except Exception:
            pass  # learning must never break the request path


class FirestoreMonthlyPersistence:
    """Cross-instance monthly-usage documents with optimistic transactions
    (reference main.py:202-244): doc id "{api_key}:{period}", transactional
    read-modify-write with a blind merge-set fallback."""

    def __init__(self, collection: Optional[str] = None) -> None:
        self._collection = collection or os.getenv(
            "OSCILLINK_MONTHLY_USAGE_COLLECTION", ""
        ).strip()
        if not self._collection:
            raise ValueError("OSCILLINK_MONTHLY_USAGE_COLLECTION not set")
        self._cl = _client()

    def _ref(self, api_key: str, period: str):
        return self._cl.collection(self._collection).document(f"{api_key}:{period}")

    def load(self, api_key: str, period: str) -> Optional[int]:
        """Return persisted `used` units for the key+period, or None."""
        try:
            snap = self._ref(api_key, period).get()
            if not getattr(snap, "exists", False):
                return None
            data = snap.to_dict() or {}
            return int(data.get("used", 0))
        except Exception:
            return None

    def add(self, api_key: str, period: str, units: int) -> Optional[int]:
        """Transactionally INCREMENT the stored `used` by ``units`` and
        return the new global total (authoritative across replicas), or
        None on failure.  Incrementing — not writing the caller's local
        total — is what makes concurrent replicas compose instead of
        last-write-wins clobbering each other's counters."""
        try:
            from google.cloud import firestore  # type: ignore

            ref = self._ref(api_key, period)

            @firestore.transactional
            def _tx_add(tx, ref):  # type: ignore
                snap = ref.get(transaction=tx)
                stored = (
                    int((snap.to_dict() or {}).get("used", 0))
                    if getattr(snap, "exists", False)
                    else 0
                )
                new_total = stored + int(units)
                tx.set(
                    ref,
                    {
                        "api_key": api_key,
                        "period": period,
                        "used": new_total,
                        "updated_at": time.time(),
                    },
                    merge=True,
                )
                return new_total

            try:
                return _tx_add(self._cl.transaction(), ref)
            except Exception:
                # degraded fallback: read + merge-set (racy only when the
                # transaction machinery itself is unavailable)
                stored = self.load(api_key, period)
                if stored is None:
                    # read error and missing-doc are indistinguishable:
                    # writing used=units on a read ERROR would SHRINK a
                    # larger persisted total — create() is atomic and
                    # raises when the doc exists, so it cannot clobber
                    ref.create(
                        {
                            "api_key": api_key,
                            "period": period,
                            "used": int(units),
                            "updated_at": time.time(),
                        }
                    )
                    return int(units)
                new_total = int(stored) + int(units)
                ref.set(
                    {
                        "api_key": api_key,
                        "period": period,
                        "used": new_total,
                        "updated_at": time.time(),
                    },
                    merge=True,
                )
                return new_total
        except Exception:
            return None  # best-effort: in-process record stays authoritative


class FirestoreEventStore:
    """Webhook event documents, create-only for idempotency (reference
    services/events.py:60-72: existing docs are never overwritten)."""

    def __init__(self, collection: Optional[str] = None) -> None:
        self._collection = collection or os.getenv(
            "OSCILLINK_WEBHOOK_EVENTS_COLLECTION", ""
        ).strip()
        if not self._collection:
            raise ValueError("OSCILLINK_WEBHOOK_EVENTS_COLLECTION not set")
        self._cl = _client()

    def get(self, event_id: str) -> Optional[dict]:
        try:
            snap = self._cl.collection(self._collection).document(event_id).get()
        except Exception:
            return None
        if not getattr(snap, "exists", False):
            return None
        return snap.to_dict() or None

    def put(self, event_id: str, record: dict[str, Any]) -> None:
        try:
            ref = self._cl.collection(self._collection).document(event_id)
            # atomic create (raises AlreadyExists on a concurrent duplicate)
            # — read-then-set let two replicas both see exists=False and the
            # later write clobber the earlier record, breaking the
            # create-only idempotency contract (reference events.py:14-72)
            ref.create(dict(record))
        except Exception:
            pass


# -- factories: env-gated, import-guarded, silent memory fallback ----------


def make_profile_store():
    if os.getenv("OSCILLINK_LEARNERS_COLLECTION", "").strip():
        try:
            return FirestoreProfileStore()
        except Exception:
            pass
    return None


def make_monthly_persistence():
    if os.getenv("OSCILLINK_MONTHLY_USAGE_COLLECTION", "").strip():
        try:
            return FirestoreMonthlyPersistence()
        except Exception:
            pass
    return None


def make_event_store():
    if os.getenv("OSCILLINK_WEBHOOK_EVENTS_COLLECTION", "").strip():
        try:
            return FirestoreEventStore()
        except Exception:
            pass
    return None
