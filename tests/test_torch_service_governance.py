"""The port's service (``oscillink_tpu_torch.service``, ``device="cpu"``):
governance hardening, the cases of ``tests/test_governance_hardening.py``.

Governance/webhook/keystore hardening (round-3 self-review findings):
monthly peek-before-window-consume, mid-window limit changes, per-IP bucket
purge, thread-safe charging, rotation-safe Stripe signatures, out-of-order
subscription events, env hot-reload preserving provisioned keys, admin
override clearing."""

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from oscillink_tpu_torch.service.api import create_state  # noqa: E402

import hashlib
import hmac
import json
import threading
import time

import numpy as np

from oscillink_tpu_torch.service import LocalClient
from oscillink_tpu_torch.service.governance import ApiError, QuotaState, RateLimiter
from oscillink_tpu_torch.service.keystore import InMemoryKeyStore
from oscillink_tpu_torch.service.webhooks import verify_stripe_signature


def _payload(n=24, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "Y": rng.standard_normal((n, d)).astype(np.float32).tolist(),
        "psi": rng.standard_normal(d).astype(np.float32).tolist(),
        "options": {"max_iters": 6, "tol": 1e-3},
    }


def _client(monkeypatch, **env):
    for var in (
        "OSCILLINK_API_KEYS",
        "OSCILLINK_KEY_TIERS",
        "OSCILLINK_KEY_NODE_UNITS_LIMIT",
        "OSCILLINK_MONTHLY_CAP",
        "OSCILLINK_RATE_LIMIT",
        "OSCILLINK_IP_RATE_LIMIT",
    ):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return LocalClient(create_state(device="cpu"))


def test_window_429_does_not_burn_monthly_cap(monkeypatch):
    client = _client(
        monkeypatch,
        OSCILLINK_API_KEYS="mk",
        OSCILLINK_KEY_TIERS="mk:free",
        OSCILLINK_KEY_NODE_UNITS_LIMIT="200",
        OSCILLINK_MONTHLY_CAP="1000",
    )
    hdr = {"X-API-Key": "mk"}
    p = _payload(n=24, d=8)  # 192 units
    r1 = client.post("/v1/settle", json_body=p, headers=hdr)
    assert r1.status_code == 200
    assert int(r1.headers["X-Monthly-Remaining"]) == 1000 - 192
    for _ in range(4):  # window exhausted: 429s must not consume monthly
        r = client.post("/v1/settle", json_body=p, headers=hdr)
        assert r.status_code == 429
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_LIMIT", "100000")
    r2 = client.post("/v1/settle", json_body=p, headers=hdr)
    assert r2.status_code == 200
    assert int(r2.headers["X-Monthly-Remaining"]) == 1000 - 2 * 192


def test_quota_limit_change_keeps_consumption(monkeypatch):
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_LIMIT", "1000")
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_WINDOW", "3600")
    q = QuotaState()
    ks = InMemoryKeyStore()
    q.check_and_consume("k", 900, ks)
    # tightening the limit mid-window must NOT grant a fresh window
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_LIMIT", "950")
    try:
        q.check_and_consume("k", 100, ks)
        raise AssertionError("expected 429: used=900 of the new 950 limit")
    except ApiError as e:
        assert e.status == 429


def test_quota_thread_safety(monkeypatch):
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_LIMIT", "10000")
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_WINDOW", "3600")
    q = QuotaState()
    ks = InMemoryKeyStore()
    accepted = []

    def worker():
        for _ in range(200):  # 8x200x10 = 16000 units demanded of cap 10000
            try:
                q.check_and_consume("k", 10, ks)
                accepted.append(1)
            except ApiError:
                pass

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # exactly the cap's worth of units accepted — no lost-update overshoot
    assert len(accepted) == 1000


def test_per_ip_buckets_purge(monkeypatch):
    monkeypatch.setenv("OSCILLINK_IP_RATE_LIMIT", "100")
    monkeypatch.setenv("OSCILLINK_IP_RATE_WINDOW", "0")  # expire instantly
    rl = RateLimiter()
    rl._PURGE_EVERY = 64
    for i in range(256):
        rl.check_ip(f"10.0.{i // 250}.{i % 250}")
    assert len(rl._per_ip) < 256  # expired buckets were swept


def test_stripe_signature_accepts_any_v1_during_rotation():
    payload = b'{"id": "evt_1", "type": "x"}'
    secret = "whsec_new"
    ts = str(int(time.time()))
    good = hmac.new(
        secret.encode(), f"{ts}.".encode() + payload, hashlib.sha256
    ).hexdigest()
    stale = "0" * 64
    # Stripe sends old+new signatures while rotating the endpoint secret
    hdr = f"t={ts},v1={stale},v1={good}"
    assert verify_stripe_signature(payload, hdr, secret) is True
    assert verify_stripe_signature(payload, f"t={ts},v1={stale}", secret) is False


def test_webhook_rejects_non_object_payload(monkeypatch):
    client = _client(monkeypatch, OSCILLINK_ALLOW_UNVERIFIED_STRIPE="1")
    r = client.post("/stripe/webhook", json_body=[])
    assert r.status_code == 400


def test_late_subscription_update_does_not_resurrect(monkeypatch):
    client = _client(monkeypatch, OSCILLINK_ALLOW_UNVERIFIED_STRIPE="1")

    def event(eid, etype, created, status="active"):
        return {
            "id": eid,
            "type": etype,
            "created": created,
            "data": {
                "object": {
                    "status": status,
                    "metadata": {"api_key": "ok_sub1"},
                    "items": {"data": []},
                }
            },
        }

    now = time.time()
    r1 = client.post("/stripe/webhook", json_body=event("e1", "customer.subscription.created", now))
    assert r1.status_code == 200
    r2 = client.post(
        "/stripe/webhook",
        json_body=event("e2", "customer.subscription.deleted", now + 10),
    )
    assert r2.json()["action"] == "revoked"
    # the late update (older created ts) must be ignored, not resurrect
    r3 = client.post(
        "/stripe/webhook",
        json_body=event("e3", "customer.subscription.updated", now + 5),
    )
    assert r3.json()["action"] == "stale_event_ignored"
    p = _payload()
    monkeypatch.setenv("OSCILLINK_API_KEYS", "")  # keystore-only auth
    r4 = client.post("/v1/settle", json_body=p, headers={"X-API-Key": "ok_sub1"})
    assert r4.status_code == 401  # still revoked


def test_subscription_update_honors_stripe_status(monkeypatch):
    client = _client(monkeypatch, OSCILLINK_ALLOW_UNVERIFIED_STRIPE="1")
    ev = {
        "id": "e_pd",
        "type": "customer.subscription.updated",
        "created": time.time(),
        "data": {
            "object": {
                "status": "past_due",
                "metadata": {"api_key": "ok_pd"},
                "items": {"data": []},
            }
        },
    }
    r = client.post("/stripe/webhook", json_body=ev)
    assert r.json()["key_status"] == "suspended"


def test_hot_reload_preserves_provisioned_keys(monkeypatch):
    monkeypatch.setenv("OSCILLINK_API_KEYS", "envkey1")
    monkeypatch.delenv("OSCILLINK_KEY_TIERS", raising=False)
    ks = InMemoryKeyStore()
    ks.update("ok_customer", create=True, tier="pro", status="active")
    # operator edits the env list: provisioned customer keys must survive
    monkeypatch.setenv("OSCILLINK_API_KEYS", "envkey2")
    ks.maybe_hot_reload()
    assert ks.get("ok_customer") is not None
    assert ks.get("envkey1") is None and ks.get("envkey2") is not None


def test_admin_can_clear_quota_override(monkeypatch):
    client = _client(monkeypatch, OSCILLINK_ADMIN_SECRET="adm")
    hdr = {"X-Admin-Secret": "adm"}
    r1 = client.put(
        "/admin/keys/k1", json_body={"quota_limit_units": 1000}, headers=hdr
    )
    assert r1.json()["quota_limit_units"] == 1000
    # explicit null clears the override back to the global default
    r2 = client.put(
        "/admin/keys/k1", json_body={"quota_limit_units": None}, headers=hdr
    )
    assert r2.json()["quota_limit_units"] is None
    # omitted field leaves the value unchanged
    r3 = client.put(
        "/admin/keys/k1", json_body={"quota_limit_units": 500}, headers=hdr
    )
    r4 = client.put("/admin/keys/k1", json_body={"tier": "pro"}, headers=hdr)
    assert r4.json()["quota_limit_units"] == 500
