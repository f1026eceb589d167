"""The port's service (``oscillink_tpu_torch.service``, ``device="cpu"``):
the aiohttp binding, the cases of ``tests/test_http_layer.py``.

Real HTTP layer tests: aiohttp binding, middleware behaviors."""

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from oscillink_tpu_torch.service.api import create_state  # noqa: E402

import asyncio
import json

import numpy as np

aiohttp = pytest.importorskip("aiohttp")

from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from oscillink_tpu_torch.service.http import create_app  # noqa: E402


def _run(coro):
    return asyncio.get_event_loop_policy().new_event_loop().run_until_complete(coro)


def _payload(n=16, d=6):
    rng = np.random.default_rng(0)
    return {
        "Y": rng.standard_normal((n, d)).astype(np.float32).tolist(),
        "psi": rng.standard_normal(d).astype(np.float32).tolist(),
        "options": {"max_iters": 6, "tol": 1e-2},
    }


def test_http_health_and_settle(monkeypatch):
    monkeypatch.delenv("OSCILLINK_API_KEYS", raising=False)
    monkeypatch.delenv("OSCILLINK_RATE_LIMIT", raising=False)

    async def go():
        app = create_app(create_state(device="cpu"))
        async with TestClient(TestServer(app)) as client:
            r = await client.get("/health")
            assert r.status == 200
            body = await r.json()
            assert body["status"] == "ok"
            assert "X-Request-ID" in r.headers
            assert r.headers.get("X-Content-Type-Options") == "nosniff"

            r2 = await client.post("/v1/settle", json=_payload())
            assert r2.status == 200
            out = await r2.json()
            assert out["receipt"]["deltaH_total"] is not None

            r3 = await client.post("/v1/settle", data=b"{nope")
            assert r3.status == 400

            r4 = await client.get("/nothing")
            assert r4.status == 404

    _run(go())


def test_http_body_size_guard(monkeypatch):
    monkeypatch.setenv("OSCILLINK_MAX_BODY_BYTES", "200")
    from oscillink_tpu_torch.service import config

    config.get_app_settings.cache_clear()

    async def go():
        app = create_app(create_state(device="cpu"))
        async with TestClient(TestServer(app)) as client:
            big = json.dumps(_payload(n=64, d=32)).encode()
            assert len(big) > 200
            r = await client.post(
                "/v1/settle", data=big, headers={"Content-Type": "application/json"}
            )
            assert r.status == 413

    try:
        _run(go())
    finally:
        monkeypatch.delenv("OSCILLINK_MAX_BODY_BYTES")
        config.get_app_settings.cache_clear()
