"""The service's small-N native route on the port (`service/native_path.py`):
the JAX package's 15 native-route tests (``tests/test_native_service_path.py``)
on the port's `LocalClient` (``device="cpu"`` for the device route), and
every native response held to the JAX service's native response on the
same request: equal bodies apart from timing fields (both engines are the
same source and flags, so the numbers are equal to the bit)."""

import random

import numpy as np
import pytest

pytest.importorskip("torch")

from oscillink_tpu.service import LocalClient as JaxClient  # noqa: E402
from oscillink_tpu.service import config as jax_config  # noqa: E402
from oscillink_tpu.service.api import create_state as jax_create_state  # noqa: E402
from oscillink_tpu_torch.native import native_available  # noqa: E402
from oscillink_tpu_torch.service import LocalClient, native_path  # noqa: E402
from oscillink_tpu_torch.service import config as port_config  # noqa: E402
from oscillink_tpu_torch.service.api import create_state  # noqa: E402

pytestmark = pytest.mark.skipif(not native_available(), reason="native build unavailable")

TIMING_KEYS = ("timings_ms", "t_ms", "last_settle_ms", "request_id")


def _payload(n=24, d=8, seed=0, **opts):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    return {
        "Y": Y.tolist(),
        "psi": psi.tolist(),
        "options": {"max_iters": 12, "tol": 1e-3, **opts},
    }


def _untimed(body):
    if isinstance(body, dict):
        return {k: _untimed(v) for k, v in body.items() if k not in TIMING_KEYS}
    if isinstance(body, list):
        return [_untimed(v) for v in body]
    return body


class Clients:
    """The port's service and the JAX service; `post` sends a request to the
    port, and `native` to both, holding a native answer to the JAX one."""

    def __init__(self):
        self.port = LocalClient(create_state(device="cpu"))
        self.jax = JaxClient(jax_create_state())

    def post(self, path, json_body):
        return self.port.post(path, json_body=json_body)

    def native(self, path, json_body):
        random.seed(0)
        rj = self.jax.post(path, json_body=json_body)
        random.seed(0)
        rp = self.port.post(path, json_body=json_body)
        assert rp.status_code == rj.status_code == 200, (rp.json(), rj.json())
        assert rp.json()["meta"]["backend"] == rj.json()["meta"]["backend"] == "native"
        assert _untimed(rp.json()) == _untimed(rj.json())
        return rp


@pytest.fixture()
def client(monkeypatch):
    for var in ("OSCILLINK_API_KEYS", "OSCILLINK_RECEIPT_SECRET", "OSCILLINK_NATIVE_SMALL_N",
                "OSCILLINK_NATIVE_DIFFUSION", "OSCILLINK_ADAPTIVE_PROFILES"):
        monkeypatch.delenv(var, raising=False)
    port_config.get_settings.cache_clear()
    jax_config.get_settings.cache_clear()
    yield Clients()
    port_config.get_settings.cache_clear()
    jax_config.get_settings.cache_clear()


def _close(a, b):
    return abs(a - b) <= max(1e-2, 5e-3 * abs(b))


def test_native_path_serves_small_requests(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    body = client.native("/v1/settle", _payload(n=24)).json()
    assert body["receipt"]["meta"]["backend"] == "native"
    assert np.isfinite(body["receipt"]["deltaH_total"])


def test_device_path_above_threshold(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "8")
    r = client.post("/v1/settle", _payload(n=24))
    assert r.status_code == 200
    assert r.json()["meta"]["backend"] == "device"


def test_chain_requests_serve_natively(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    p = {**_payload(n=24), "chain": [0, 1, 2], "params": {"lamP": 0.2}}
    body = client.native("/v1/settle", p).json()
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "0")
    rd = client.post("/v1/settle", p).json()
    assert _close(body["receipt"]["deltaH_total"], rd["receipt"]["deltaH_total"])


def test_native_and_device_agree(client, monkeypatch):
    p = _payload(n=32, d=10, seed=7)
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    rn = client.native("/v1/settle", p).json()
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "0")
    rd = client.post("/v1/settle", p).json()
    assert rn["state_sig"] == rd["state_sig"]
    assert _close(rn["receipt"]["deltaH_total"], rd["receipt"]["deltaH_total"])


def test_native_bundle_matches_device(client, monkeypatch):
    p = {**_payload(n=32, d=10, seed=9), "options": {"bundle_k": 5}}
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    bn = client.native("/v1/settle", p).json()["bundle"]
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "0")
    bd = client.post("/v1/settle", p).json()["bundle"]
    assert [e["id"] for e in bn] == [e["id"] for e in bd]


def test_native_rerank_bundle_matches_device(client, monkeypatch):
    p = {**_payload(n=32, d=10, seed=11), "options": {"bundle_k": 5, "bundle_diversify": False}}
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    rn = client.native("/v1/settle", p).json()
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "0")
    rd = client.post("/v1/settle", p).json()
    assert rd["meta"]["backend"] == "device"
    assert [e["id"] for e in rn["bundle"]] == [e["id"] for e in rd["bundle"]]


def test_diffusion_requests_stay_on_device_by_default(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    monkeypatch.setenv("OSCILLINK_FEAT_DIFFUSION_GATES", "1")
    payload = _payload(n=24, include_receipt=True)
    payload["diffusion"] = {"enable": True, "beta": 1.0, "gamma": 0.1}
    r = client.post("/v1/settle", payload)
    assert r.status_code == 200
    assert r.json()["meta"]["backend"] == "device"


def test_diffusion_requests_serve_natively_on_opt_in(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    monkeypatch.setenv("OSCILLINK_NATIVE_DIFFUSION", "1")
    monkeypatch.setenv("OSCILLINK_FEAT_DIFFUSION_GATES", "1")
    payload = _payload(n=24, include_receipt=True)
    payload["diffusion"] = {"enable": True, "beta": 1.0, "gamma": 0.1}
    meta = client.native("/v1/settle", payload).json()["receipt"]["meta"]
    assert meta["gates_uniform"] is False
    assert 0.0 <= meta["gates_min"] <= meta["gates_max"] <= 1.0


def test_diffusion_native_agrees_with_device(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_DIFFUSION", "1")
    monkeypatch.setenv("OSCILLINK_FEAT_DIFFUSION_GATES", "1")
    payload = _payload(n=24, include_receipt=True)
    payload["params"] = {"deterministic_k": True}
    payload["diffusion"] = {"enable": True, "beta": 1.0, "gamma": 0.1}
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    r_native = client.native("/v1/settle", payload)
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "0")
    r_device = client.post("/v1/settle", payload)
    assert r_device.json()["meta"]["backend"] == "device"
    dh_n = r_native.json()["receipt"]["deltaH_total"]
    dh_d = r_device.json()["receipt"]["deltaH_total"]
    assert abs(dh_n - dh_d) / (abs(dh_d) + 1e-9) < 5e-3


def test_bundle_endpoint_routes_native(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    p = {**_payload(n=32, d=10, seed=21), "bundle_k": 5, "alpha": 0.6}
    b1 = client.native("/v1/bundle", p).json()
    assert b1["meta"]["cache"] == "MISS"
    r2 = client.native("/v1/bundle", p)
    assert r2.json()["meta"]["cache"] == "HIT"
    assert r2.json()["bundle"] == b1["bundle"]
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "0")
    rd = client.post("/v1/bundle", p)
    assert rd.json()["meta"].get("backend", "device") != "native"
    assert [e["id"] for e in rd.json()["bundle"]] == [e["id"] for e in b1["bundle"]]
    assert rd.json()["state_sig"] == b1["state_sig"]


def test_bundle_endpoint_native_rerank_mode(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    p = {**_payload(n=32, d=10, seed=22), "bundle_k": 5, "diversify": False}
    rn = client.native("/v1/bundle", p)
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "0")
    rd = client.post("/v1/bundle", p)
    assert [e["id"] for e in rn.json()["bundle"]] == [e["id"] for e in rd.json()["bundle"]]


def test_chain_receipt_endpoint_routes_native(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    p = {**_payload(n=28, d=8, seed=31), "chain": [0, 3, 7, 11],
         "params": {"deterministic_k": True}}
    bn = client.native("/v1/chain/receipt", p).json()
    cr = bn["chain_receipt"]
    assert set(cr) >= {"verdict", "weakest_link", "coherence_gain", "edges"}
    assert len(cr["edges"]) == 3
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "0")
    rd = client.post("/v1/chain/receipt", p)
    cd = rd.json()["chain_receipt"]
    assert cr["verdict"] == cd["verdict"]
    assert bn["state_sig"] == rd.json()["state_sig"]
    for en, ed in zip(cr["edges"], cd["edges"]):
        assert abs(en["z_struct"] - ed["z_struct"]) <= max(2e-3, 2e-3 * abs(ed["z_struct"]))


def test_batch_endpoint_routes_native(client, monkeypatch):
    rng = np.random.default_rng(41)
    Y = rng.standard_normal((30, 8)).astype(np.float32)
    psis = rng.standard_normal((3, 8)).astype(np.float32)
    p = {"Y": Y.tolist(), "psis": psis.tolist(), "bundle_k": 4,
         "params": {"deterministic_k": True}}
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    bn = client.native("/v1/settle/batch", p).json()
    assert bn["queries"] == 3 and len(bn["bundles"]) == 3
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "0")
    bd = client.post("/v1/settle/batch", p).json()
    assert bd["meta"].get("backend") is None  # the device branch carries no tag
    for qn, qd in zip(bn["bundles"], bd["bundles"]):
        assert [e["id"] for e in qn] == [e["id"] for e in qd]


def test_batch_endpoint_native_diffusion(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    monkeypatch.setenv("OSCILLINK_NATIVE_DIFFUSION", "1")
    monkeypatch.setenv("OSCILLINK_FEAT_DIFFUSION_GATES", "1")
    rng = np.random.default_rng(43)
    Y = rng.standard_normal((24, 8)).astype(np.float32)
    psis = rng.standard_normal((2, 8)).astype(np.float32)
    p = {"Y": Y.tolist(), "psis": psis.tolist(), "bundle_k": 4,
         "diffusion": {"enable": True, "beta": 1.0, "gamma": 0.1}}
    b = client.native("/v1/settle/batch", p).json()
    assert b["meta"]["diffusion"] == {"beta": 1.0, "gamma": 0.1}
    assert len(b["bundles"]) == 2


def test_bundle_cache_hit_skips_native_settle(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    p = {**_payload(n=32, d=10, seed=31), "bundle_k": 5, "alpha": 0.6}
    r1 = client.post("/v1/bundle", p)
    assert r1.json()["meta"]["cache"] == "MISS"
    calls = []
    orig = native_path.native_settle

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(native_path, "native_settle", spy)
    r2 = client.post("/v1/bundle", p)
    assert r2.json()["meta"]["cache"] == "HIT"
    assert calls == []
    assert r2.json()["bundle"] == r1.json()["bundle"]


# -- routes the JAX file leaves to its device tests ---------------------------


def test_signed_native_receipts_match_the_jax_service(client, monkeypatch):
    """With a receipt secret set, both services sign the same minimal
    payload over the native receipt."""
    from oscillink_tpu_torch.core.receipts import verify_receipt

    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    monkeypatch.setenv("OSCILLINK_RECEIPT_SECRET", "native-secret")
    port_config.get_settings.cache_clear()
    jax_config.get_settings.cache_clear()
    rec = client.native("/v1/receipt", _payload(n=20, seed=5)).json()["receipt"]
    assert rec["meta"]["signature"]["payload"]["mode"] == "minimal"
    assert verify_receipt(rec, "native-secret")


def test_jobs_route_natively(client, monkeypatch):
    import time

    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    p = _payload(n=20, seed=6, include_receipt=True, bundle_k=3)
    r = client.post("/v1/jobs/settle", p)
    assert r.status_code == 202
    job_id = r.json()["job_id"]
    for _ in range(200):
        job = client.port.get(f"/v1/jobs/{job_id}").json()
        if job["status"] in ("done", "error"):
            break
        time.sleep(0.02)
    assert job["status"] == "done", job
    assert job["result"]["backend"] == "native"
    settle = client.native("/v1/settle", p).json()
    assert job["result"]["state_sig"] == settle["state_sig"]
    assert job["result"]["bundle"] == settle["bundle"]
