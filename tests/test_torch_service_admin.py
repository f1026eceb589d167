"""The port's service (``oscillink_tpu_torch.service``, ``device="cpu"``):
admin webhook pagination and usage records, the cases of ``tests/test_admin_webhook_pagination.py``.

Admin webhook-event pagination/filtering (reference checklist item,
unchecked upstream) and a service fuzz property: malformed payloads never
500."""

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from oscillink_tpu_torch.service.api import create_state  # noqa: E402

import json

import numpy as np

from oscillink_tpu_torch.service.testing import LocalClient


@pytest.fixture()
def client(monkeypatch):
    monkeypatch.setenv("OSCILLINK_ALLOW_UNVERIFIED_STRIPE", "1")
    monkeypatch.setenv("OSCILLINK_ADMIN_SECRET", "adm")
    monkeypatch.delenv("OSCILLINK_API_KEYS", raising=False)
    monkeypatch.delenv("OSCILLINK_RATE_LIMIT", raising=False)
    monkeypatch.delenv("OSCILLINK_IP_RATE_LIMIT", raising=False)
    return LocalClient(create_state(device="cpu"))


def _post_event(client, i, etype="checkout.session.completed"):
    ev = {
        "id": f"evt_{i}",
        "type": etype,
        "created": 1700000000 + i,
        "data": {"object": {"id": f"cs_{i}", "metadata": {}}},
    }
    r = client.post("/stripe/webhook", data=json.dumps(ev).encode())
    assert r.status_code == 200


def test_pagination_and_filtering(client):
    for i in range(7):
        _post_event(client, i)
    for i in range(7, 10):
        _post_event(client, i, etype="customer.subscription.updated")

    h = {"X-Admin-Secret": "adm"}
    r = client.request("GET", "/admin/webhook/events", headers=h)
    body = r.json()
    assert body["total"] == 10 and len(body["events"]) == 10

    r = client.request("GET", "/admin/webhook/events", headers=h,
                       query={"limit": "4", "offset": "8"})
    body = r.json()
    assert body["total"] == 10 and len(body["events"]) == 2
    assert body["offset"] == 8 and body["limit"] == 4

    r = client.request("GET", "/admin/webhook/events", headers=h,
                       query={"type": "customer.subscription.updated"})
    body = r.json()
    assert body["total"] == 3
    assert all(e["type"] == "customer.subscription.updated"
               for e in body["events"])

    # since filter: everything was processed just now
    r = client.request("GET", "/admin/webhook/events", headers=h,
                       query={"since": "1"})
    assert r.json()["total"] == 10
    r = client.request("GET", "/admin/webhook/events", headers=h,
                       query={"since": "99999999999"})
    assert r.json()["total"] == 0

    # malformed query params are 422, not 500
    for q in ({"limit": "x"}, {"since": "not-a-ts"}):
        r = client.request("GET", "/admin/webhook/events", headers=h, query=q)
        assert r.status_code == 422


def test_fuzz_malformed_payloads_never_500(client):
    """Robustness property: random garbage to every POST endpoint maps to a
    4xx (validation), never a 500."""
    rng = np.random.default_rng(0)
    paths = ["/v1/settle", "/v1/receipt", "/v1/bundle", "/v1/chain/receipt",
             "/v1/settle/batch", "/v1/bundle/ragged", "/v1/autocorrect",
             "/v1/jobs/settle", "/v1/bench/competitor"]
    payloads = [
        b"", b"not json", b"[]", b'{"Y": "nope"}', b'{"Y": [[1e400]]}',
        b'{"Y": [[1,2],[3]]}', b'{"Y": [[1,2]], "psi": [1]}',
        b'{"Y": [[1,2]], "psi": [1,2], "options": {"bundle_k": -3}}',
        b'{"Y": [], "psi": []}', b'{"psi": [1,2]}',
        json.dumps({"Y": [[None, 2]], "psi": [1, 2]}).encode(),
        json.dumps({"Y": [[1, 2]], "psi": [1, 2],
                    "params": {"lamG": -1}}).encode(),
        json.dumps({"Y": [[1, 2]], "psi": [1, 2],
                    "chain": [0, 99]}).encode(),
    ]
    # plus some random byte soup
    for _ in range(5):
        payloads.append(bytes(rng.integers(32, 127, size=64, dtype=np.uint8)))

    for path in paths:
        for p in payloads:
            r = client.post(path, data=p)
            assert r.status_code < 500, (path, p[:40], r.status_code, r.json())
