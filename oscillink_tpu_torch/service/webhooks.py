"""Stripe webhook processing (reference cloud/app/billing_webhook.py:17-271).

  * signature verification of the `Stripe-Signature` header (HMAC-SHA256 of
    "{t}.{payload}" with the endpoint secret) with timestamp freshness;
  * OSCILLINK_ALLOW_UNVERIFIED_STRIPE=1 bypass for test harnesses;
  * idempotency via an event store keyed by event id (memory-backed here,
    pluggable for Redis/Firestore);
  * checkout.session.completed provisions an API key at the mapped tier and
    completes any pending CLI pairing session;
  * customer.subscription.updated/deleted re-tiers / revokes keys.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets
import time
from typing import Any, Dict, Optional

from .billing import resolve_tier_from_subscription
from .cli_sessions import CliSessionStore
from .governance import ApiError
from .keystore import KeyStore

__all__ = ["WebhookProcessor", "verify_stripe_signature"]


def _freshness_sec() -> float:
    try:
        return float(os.getenv("OSCILLINK_STRIPE_SIG_TOLERANCE", "300"))
    except ValueError:
        return 300.0


def verify_stripe_signature(payload: bytes, header: Optional[str], secret: str) -> bool:
    """Stripe v1 scheme: header 't=<ts>,v1=<hex>,...'; signed value is
    '{t}.{payload}'.  During endpoint-secret rotation Stripe sends MULTIPLE
    v1 entries (old + new secret) — any match accepts."""
    if not header:
        return False
    try:
        ts = None
        v1s: list[str] = []
        for p in header.split(","):
            if "=" not in p:
                continue
            k, v = p.strip().split("=", 1)
            if k == "t":
                ts = v
            elif k == "v1":
                v1s.append(v)
        if not ts or not v1s:
            return False
        if abs(time.time() - float(ts)) > _freshness_sec():
            return False
        signed = f"{ts}.".encode() + payload
        expected = hmac.new(secret.encode(), signed, hashlib.sha256).hexdigest()
        return any(hmac.compare_digest(expected, v1) for v1 in v1s)
    except Exception:
        return False


class WebhookProcessor:
    def __init__(self, keystore: KeyStore, cli_sessions: CliSessionStore) -> None:
        self.keystore = keystore
        self.cli_sessions = cli_sessions
        self._events: Dict[str, dict] = {}  # idempotency store
        self._sub_event_ts: Dict[str, float] = {}  # per-key newest sub event
        self._checkouts: Dict[str, dict] = {}  # checkout session -> key record
        from ._firestore_stores import make_event_store

        self._fs_events = make_event_store()

    # -- event store: memory first, then Redis, then Firestore — all
    # best-effort cross-instance idempotency (reference
    # billing_webhook.py:137-150 + services/events.py:14-72)

    def seen(self, event_id: str) -> Optional[dict]:
        rec = self._events.get(event_id)
        if rec is not None:
            return rec
        from .redis_backend import get_redis_state

        rs = get_redis_state()
        if rs is not None:
            raw = rs.get(f"oscillink:webhook:{event_id}")
            if raw:
                try:
                    rec = json.loads(raw)
                    self._events[event_id] = rec
                    return rec
                except Exception:
                    pass  # corrupt Redis payload: fall through to Firestore
        if self._fs_events is not None:
            rec = self._fs_events.get(event_id)
            if rec is not None:
                self._events[event_id] = rec
                return rec
        return None

    def record(self, event_id: str, rec: dict) -> None:
        self._events[event_id] = rec
        from .redis_backend import get_redis_state

        rs = get_redis_state()
        if rs is not None:
            try:
                rs.set_with_ttl(
                    f"oscillink:webhook:{event_id}", json.dumps(rec), 7 * 86400
                )
            except Exception:
                pass
        if self._fs_events is not None:
            self._fs_events.put(event_id, rec)

    def events(self) -> list[dict]:
        return list(self._events.values())

    # -- checkout-session -> provisioned-key map ---------------------------
    # The Payment Link flow redirects the buyer's browser to
    # /billing/success?session_id={CHECKOUT_SESSION_ID}; the success page
    # shows the key the webhook provisioned for that checkout (reference
    # docs/cloud/DEPLOY_STRIPE_CLOUD.md flow — the reference fetches the
    # session live from Stripe; with no egress here the webhook records the
    # mapping instead).  Same memory->Redis->Firestore tiering as events so
    # the redirect can land on a different replica than the webhook did.

    CHECKOUT_TTL = 86400.0  # browser gets 24 h to load the page
    MAX_CHECKOUTS = 10_000  # memory-tier bound (unauthenticated surface)

    def record_checkout(self, session_id: str, rec: dict) -> None:
        rec = {**rec, "ts": time.time()}
        if len(self._checkouts) >= self.MAX_CHECKOUTS:
            oldest = min(self._checkouts, key=lambda s: self._checkouts[s]["ts"])
            self._checkouts.pop(oldest, None)
        self._checkouts[session_id] = rec
        from .redis_backend import get_redis_state

        rs = get_redis_state()
        if rs is not None:
            try:
                rs.set_with_ttl(
                    f"oscillink:checkout:{session_id}",
                    json.dumps(rec),
                    int(self.CHECKOUT_TTL),
                )
            except Exception:
                pass
        if self._fs_events is not None:
            self._fs_events.put(f"checkout:{session_id}", rec)

    def lookup_checkout(self, session_id: str) -> Optional[dict]:
        rec = self._checkouts.get(session_id)
        if rec is None:
            from .redis_backend import get_redis_state

            rs = get_redis_state()
            if rs is not None:
                raw = rs.get(f"oscillink:checkout:{session_id}")
                if raw:
                    try:
                        rec = json.loads(raw)
                    except Exception:
                        rec = None
        if rec is None and self._fs_events is not None:
            rec = self._fs_events.get(f"checkout:{session_id}")
        if rec is not None and time.time() - float(rec.get("ts", 0.0)) > self.CHECKOUT_TTL:
            self._checkouts.pop(session_id, None)
            return None
        return rec

    # -- processing --------------------------------------------------------

    def process(self, payload: bytes, signature_header: Optional[str]) -> dict:
        secret = os.getenv("OSCILLINK_STRIPE_WEBHOOK_SECRET", "")
        allow_unverified = os.getenv("OSCILLINK_ALLOW_UNVERIFIED_STRIPE", "0") in {
            "1",
            "true",
        }
        if not allow_unverified:
            if not secret:
                raise ApiError(503, "stripe webhook secret not configured")
            if not verify_stripe_signature(payload, signature_header, secret):
                raise ApiError(400, "invalid stripe signature")

        try:
            event = json.loads(payload.decode("utf-8"))
        except Exception:
            raise ApiError(400, "invalid webhook payload") from None
        if not isinstance(event, dict):
            raise ApiError(400, "invalid webhook payload (not an object)")

        event_id = str(event.get("id") or hashlib.sha256(payload).hexdigest())
        prior = self.seen(event_id)
        if prior is not None:
            return {"status": "duplicate", "event_id": event_id, **prior}

        etype = str(event.get("type", ""))
        obj = (event.get("data") or {}).get("object") or {}
        created = float(event.get("created") or 0.0)
        outcome: dict[str, Any] = {"type": etype, "processed_at": time.time()}

        if etype == "checkout.session.completed":
            outcome.update(self._handle_checkout_completed(obj))
        elif etype in ("customer.subscription.updated", "customer.subscription.created"):
            outcome.update(self._handle_subscription_update(obj, created))
        elif etype == "customer.subscription.deleted":
            outcome.update(self._handle_subscription_deleted(obj, created))
        else:
            outcome["action"] = "ignored"

        rec = {
            "event_id": event_id,
            "payload_hash": hashlib.sha256(payload).hexdigest(),
            **outcome,
        }
        self.record(event_id, rec)
        return {"status": "ok", **rec}

    def _handle_checkout_completed(self, session: dict) -> dict:
        tier = "pro"
        sub = session.get("subscription")
        if isinstance(sub, dict):
            tier = resolve_tier_from_subscription(sub)
        meta = session.get("metadata") or {}
        if meta.get("tier"):
            tier = str(meta["tier"])
        api_key = meta.get("api_key") or f"ok_{secrets.token_urlsafe(24)}"
        pending = os.getenv("OSCILLINK_ENTERPRISE_PENDING", "1") in {"1", "true"}
        status = "pending" if (tier == "enterprise" and pending) else "active"
        self.keystore.update(api_key, create=True, tier=tier, status=status)
        session_id = session.get("id")
        cli_done = False
        if session_id:
            cli_done = self.cli_sessions.complete_by_session_id(str(session_id), api_key)
            self.record_checkout(
                str(session_id),
                {"api_key": api_key, "tier": tier, "key_status": status},
            )
        return {
            "action": "provisioned",
            "api_key": api_key,
            "tier": tier,
            "key_status": status,
            "cli_session_completed": cli_done,
        }

    # Stripe does not guarantee event ordering: a late `updated` arriving
    # after `deleted` must not resurrect the key.  Each handler checks the
    # event's `created` timestamp against the newest one applied per key.
    # (The reference unconditionally sets status="active" on update —
    # billing_webhook.py:167-183 — which both resurrects revoked keys and
    # activates past_due subscriptions; fixed here.)

    def _stale(self, api_key: str, created: float) -> bool:
        last = self._sub_event_ts.get(api_key, 0.0)
        if created and created < last:
            return True
        if created:
            self._sub_event_ts[api_key] = created
        return False

    @staticmethod
    def _status_for_subscription(subscription: dict) -> str:
        sstat = str(subscription.get("status") or "active")
        if sstat in ("active", "trialing"):
            return "active"
        if sstat == "canceled":
            return "revoked"
        return "suspended"  # past_due / unpaid / incomplete / paused

    def _handle_subscription_update(self, subscription: dict, created: float) -> dict:
        # default=None detects an UNMAPPED price id: keep the key's current
        # tier rather than downgrading a paying customer to free because a
        # renewal's price is missing from OSCILLINK_STRIPE_PRICE_MAP
        tier = resolve_tier_from_subscription(subscription, default=None)
        api_key = (subscription.get("metadata") or {}).get("api_key")
        if not api_key:
            return {"action": "no_key_metadata", "tier": tier or "unmapped"}
        if self._stale(api_key, created):
            return {"action": "stale_event_ignored", "api_key": api_key}
        status = self._status_for_subscription(subscription)
        existing = self.keystore.get(api_key)
        if tier is None:
            tier = existing.tier if existing else "free"
        self.keystore.update(api_key, create=True, tier=tier, status=status)
        return {
            "action": "retiered",
            "api_key": api_key,
            "tier": tier,
            "key_status": status,
        }

    def _handle_subscription_deleted(self, subscription: dict, created: float) -> dict:
        api_key = (subscription.get("metadata") or {}).get("api_key")
        if api_key and self.keystore.get(api_key):
            if self._stale(api_key, created):
                return {"action": "stale_event_ignored", "api_key": api_key}
            self.keystore.update(api_key, status="revoked")
            return {"action": "revoked", "api_key": api_key}
        return {"action": "no_key_metadata"}
