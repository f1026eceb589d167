"""The port's service (``oscillink_tpu_torch.service``, ``device="cpu"``):
the idempotent replay cache, the cases of ``tests/test_replay_cache.py``.

Idempotent replay cache (service/cache.py ReplayCache) — the reference
CLOUD_ARCH open question implemented: an exact retry within the TTL is
answered from cache without recompute, quota charge, or usage append."""

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from oscillink_tpu_torch.service.api import create_state  # noqa: E402

import numpy as np

from oscillink_tpu_torch.service.testing import LocalClient


def _payload(seed=0, n=24, d=16):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    psi = (Y[:4].mean(0) / (np.linalg.norm(Y[:4].mean(0)) + 1e-12)).astype(
        np.float32
    )
    return {"Y": Y.tolist(), "psi": psi.tolist()}


@pytest.fixture()
def client(monkeypatch):
    for var in (
        "OSCILLINK_API_KEYS",
        "OSCILLINK_KEY_TIERS",
        "OSCILLINK_KEY_NODE_UNITS_LIMIT",
        "OSCILLINK_MONTHLY_CAP",
        "OSCILLINK_RATE_LIMIT",
        "OSCILLINK_IP_RATE_LIMIT",
    ):
        monkeypatch.delenv(var, raising=False)
    return LocalClient(create_state(device="cpu"))


def test_replay_off_by_default(client):
    p = _payload()
    r1 = client.post("/v1/settle", json_body=p)
    r2 = client.post("/v1/settle", json_body=p)
    assert "X-Replay-Cache" not in r1.headers
    assert "X-Replay-Cache" not in r2.headers


def test_replay_hit_and_isolation(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_REPLAY_CACHE_TTL", "60")
    p = _payload(seed=2)
    r1 = client.post("/v1/settle", json_body=p,
                     headers={"X-Request-ID": "req-a"})
    assert r1.status_code == 200
    assert r1.headers.get("X-Replay-Cache") == "miss"

    r2 = client.post("/v1/settle", json_body=p,
                     headers={"X-Request-ID": "req-b"})
    assert r2.status_code == 200
    assert r2.headers.get("X-Replay-Cache") == "hit"
    b1, b2 = r1.json(), r2.json()
    assert b2["state_sig"] == b1["state_sig"]
    assert b2["receipt"]["deltaH_total"] == b1["receipt"]["deltaH_total"]
    # the replayed body carries the CURRENT request id, not the original
    assert b2["meta"]["request_id"] == "req-b"

    # a different body misses
    r3 = client.post("/v1/settle", json_body=_payload(seed=3))
    assert r3.headers.get("X-Replay-Cache") == "miss"

    # /v1/receipt is a distinct endpoint tag (include_receipt differs)
    r4 = client.post("/v1/receipt", json_body=p)
    assert r4.headers.get("X-Replay-Cache") == "miss"


def test_replay_does_not_consume_quota(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_REPLAY_CACHE_TTL", "60")
    # quota window sized for ~2 fresh requests of 24*16=384 units
    monkeypatch.setenv("OSCILLINK_API_KEYS", "kq")
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_LIMIT", "800")
    p = _payload(seed=4)
    h = {"X-API-Key": "kq"}
    r1 = client.post("/v1/settle", json_body=p, headers=h)
    assert r1.status_code == 200
    rem1 = int(r1.headers["X-Quota-Remaining"])
    # five replays: quota remaining must not move
    for _ in range(5):
        r = client.post("/v1/settle", json_body=p, headers=h)
        assert r.headers.get("X-Replay-Cache") == "hit"
        assert "X-Quota-Remaining" not in r.headers  # nothing charged
    r2 = client.post("/v1/settle", json_body=_payload(seed=5), headers=h)
    assert int(r2.headers["X-Quota-Remaining"]) == rem1 - 384


def test_replay_is_per_api_key(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_REPLAY_CACHE_TTL", "60")
    monkeypatch.setenv("OSCILLINK_API_KEYS", "ka,kb")
    p = _payload(seed=6)
    r1 = client.post("/v1/settle", json_body=p, headers={"X-API-Key": "ka"})
    assert r1.headers.get("X-Replay-Cache") == "miss"
    # same body under a DIFFERENT key must not replay another tenant's work
    r2 = client.post("/v1/settle", json_body=p, headers={"X-API-Key": "kb"})
    assert r2.headers.get("X-Replay-Cache") == "miss"


def test_replay_ttl_expires(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_REPLAY_CACHE_TTL", "60")
    p = _payload(seed=7)
    client.post("/v1/settle", json_body=p)
    # force expiry by rewinding the stored timestamp
    bucket = client.state.replay_cache._per_key["_anon_"]
    for rec in bucket.values():
        rec["ts"] -= 120.0
    r = client.post("/v1/settle", json_body=p)
    assert r.headers.get("X-Replay-Cache") == "miss"


def test_governance_rejections_counted(client, monkeypatch):
    """Reference PROD_READINESS checklist (unchecked upstream): Prometheus
    counters for quota/monthly-cap rejections."""
    from oscillink_tpu_torch.service.metrics import HAVE_PROMETHEUS

    if not HAVE_PROMETHEUS:
        pytest.skip("prometheus_client not installed")
    monkeypatch.setenv("OSCILLINK_API_KEYS", "kr")
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_LIMIT", "500")  # one 384-unit fit
    counter = client.state.metrics.rejections.labels(kind="quota_window")
    before = counter._value.get()
    assert client.post("/v1/settle", json_body=_payload(),
                       headers={"X-API-Key": "kr"}).status_code == 200
    r = client.post("/v1/settle", json_body=_payload(seed=9),
                    headers={"X-API-Key": "kr"})
    assert r.status_code == 429
    assert counter._value.get() == before + 1
    # an over-limit single request counts as a payload rejection
    pay = client.state.metrics.rejections.labels(kind="payload")
    pbefore = pay._value.get()
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_LIMIT", "100")
    r = client.post("/v1/settle", json_body=_payload(seed=10),
                    headers={"X-API-Key": "kr"})
    assert r.status_code == 413
    assert pay._value.get() == pbefore + 1
