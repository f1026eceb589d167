"""The port's service (``oscillink_tpu_torch.service``, ``device="cpu"``)
against the JAX service on the same requests.

Every compute route runs through both `LocalClient`s on seeded numpy
inputs (N <= 64): the same status, and the same body apart from timings
and request ids — ``state_sig``, iterations, null points, bundle ids and
chain verdicts identical, ΔH within 1e-5 relative, other floats within
1e-4, ``meta.backend`` ``"device"``.  Signed receipts with the same secret
carry the same signature where the signed payload is byte-identical, and
each package's verify accepts the other's.  The governance, quota,
rate-limit, billing, webhook, admin and CLI-pairing cases of
``tests/test_service.py`` run on the port's service alone.
"""

import json
import random
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.core.receipts import verify_receipt as jax_verify  # noqa: E402
from oscillink_tpu.service import LocalClient as JaxClient  # noqa: E402
from oscillink_tpu.service import config as jax_config  # noqa: E402
from oscillink_tpu.service.api import create_state as jax_create_state  # noqa: E402
from oscillink_tpu_torch.core.receipts import canonical_json  # noqa: E402
from oscillink_tpu_torch.core.receipts import verify_receipt as port_verify  # noqa: E402
from oscillink_tpu_torch.service import LocalClient  # noqa: E402
from oscillink_tpu_torch.service import config as port_config  # noqa: E402
from oscillink_tpu_torch.service.api import create_state  # noqa: E402

SEED = 1234  # `random`'s seed before each request (adaptive exploration draws)
DH_REL = 1e-5
FLOAT_RTOL, FLOAT_ATOL = 1e-4, 1e-5
ENV = (
    "OSCILLINK_API_KEYS",
    "OSCILLINK_KEY_TIERS",
    "OSCILLINK_KEY_NODE_UNITS_LIMIT",
    "OSCILLINK_MONTHLY_CAP",
    "OSCILLINK_RATE_LIMIT",
    "OSCILLINK_IP_RATE_LIMIT",
    "OSCILLINK_ADMIN_SECRET",
    "OSCILLINK_RECEIPT_SECRET",
    "OSCILLINK_GRAPH_CACHE_SIZE",
    "OSCILLINK_REPLAY_CACHE_TTL",
    "OSCILLINK_NATIVE_SMALL_N",
    "OSCILLINK_SHARDED_MIN_N",
    "OSCILLINK_ADAPTIVE_PROFILES",
    "OSCILLINK_FEAT_DIFFUSION_GATES",
)


def _payload(n=24, d=8, seed=0, **opts):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    return {
        "Y": Y.tolist(),
        "psi": psi.tolist(),
        "options": {"max_iters": 8, "tol": 1e-3, **opts},
    }


def _skip_key(key: str) -> bool:
    return key in ("timings_ms", "request_id", "job_id", "ms") or key.endswith("_ms")


def assert_same(port, jax, path="body", skip=()):
    """The port's JSON body against the JAX service's: identical apart
    from timings and ids (and the keys in ``skip``); ``deltaH_total``
    within DH_REL, other floats within FLOAT_RTOL/FLOAT_ATOL; signatures
    checked by `_signatures`."""
    if isinstance(jax, dict):
        assert isinstance(port, dict), path
        assert set(port) == set(jax), (path, set(port) ^ set(jax))
        for key in jax:
            if _skip_key(key) or key == "signature" or key in skip:
                continue
            assert_same(port[key], jax[key], f"{path}.{key}", skip)
    elif isinstance(jax, list):
        assert isinstance(port, list) and len(port) == len(jax), path
        for i, (a, b) in enumerate(zip(port, jax)):
            assert_same(a, b, f"{path}[{i}]", skip)
    elif isinstance(jax, float) and not isinstance(jax, bool):
        assert isinstance(port, (int, float)) and not isinstance(port, bool), path
        if path.endswith("deltaH_total"):
            assert abs(port - jax) <= DH_REL * max(abs(jax), 1e-30), (path, port, jax)
        else:
            assert abs(port - jax) <= FLOAT_ATOL + FLOAT_RTOL * abs(jax), (path, port, jax)
    else:
        assert port == jax and type(port) is type(jax), (path, port, jax)


def _receipts(body):
    out = []
    if isinstance(body, dict):
        if "deltaH_total" in body and isinstance(body.get("meta"), dict):
            out.append(body)
        for val in body.values():
            out += _receipts(val)
    elif isinstance(body, list):
        for val in body:
            out += _receipts(val)
    return out


def _signatures(port, jax, secret):
    """Signed receipts: the same signature where the signed payload is
    byte-identical, and each package's verify accepts the other's."""
    pairs = list(zip(_receipts(port), _receipts(jax)))
    for rp, rj in pairs:
        sp, sj = rp["meta"].get("signature"), rj["meta"].get("signature")
        assert (sp is None) == (sj is None)
        if sp is None:
            continue
        if canonical_json(sp["payload"]) == canonical_json(sj["payload"]):
            assert sp["signature"] == sj["signature"]
        assert jax_verify(rp, secret) and port_verify(rj, secret)
    return len(pairs)


class Pair:
    """The port's service on the CPU and the JAX service side by side: each
    request goes to both, `random` seeded alike before each."""

    def __init__(self):
        self.port = LocalClient(create_state(device="cpu"))
        self.jax = JaxClient(jax_create_state())
        self.state = self.port.state

    def both(self, method, path, **kw):
        random.seed(SEED)
        rj = self.jax.request(method, path, **kw)
        random.seed(SEED)
        rp = self.port.request(method, path, **kw)
        return rp, rj

    def request(self, method, path, **kw):
        rp, rj = self.both(method, path, **kw)
        assert rp.status_code == rj.status_code, (rp.json(), rj.json())
        if rj.headers.get("X-Request-ID"):
            assert rp.headers.get("X-Request-ID")
        assert_same(rp.json(), rj.json())
        return rp

    def post(self, path, json_body=None, **kw):
        return self.request("POST", path, json_body=json_body, **kw)

    def get(self, path, **kw):
        return self.request("GET", path, **kw)


def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("OSCILLINK_DISABLE_ST", "1")  # hash embeddings, no download
    _clear_settings()


def _clear_settings():
    port_config.get_settings.cache_clear()
    jax_config.get_settings.cache_clear()


@pytest.fixture()
def pair(monkeypatch):
    _clean_env(monkeypatch)
    return Pair()


@pytest.fixture()
def client(monkeypatch):
    _clean_env(monkeypatch)
    return LocalClient(create_state(device="cpu"))


# -- compute routes: port against JAX ----------------------------------------


def test_settle_matches_jax(pair):
    r = pair.post("/v1/settle", json_body={**_payload(), "chain": [0, 3, 5]})
    body = r.json()
    assert r.status_code == 200 and body["receipt"]["deltaH_total"] is not None
    assert body["meta"]["backend"] == "device" and body["meta"]["N"] == 24


@pytest.mark.parametrize("diversify", [True, False])
def test_settle_with_bundle_matches_jax(pair, diversify):
    p = _payload(n=40, d=16, seed=7, bundle_k=6, bundle_diversify=diversify)
    r = pair.post("/v1/settle", json_body=p)
    assert len(r.json()["bundle"]) == 6


def test_receipt_endpoint_matches_jax(pair):
    r = pair.post("/v1/receipt", json_body={**_payload(seed=1), "options": {"include_receipt": False}})
    assert r.json()["receipt"] is not None  # /v1/receipt always includes it


@pytest.mark.parametrize("diversify,alpha", [(True, 0.5), (True, 0.0), (False, 0.5)])
def test_bundle_matches_jax(pair, diversify, alpha):
    p = {**_payload(n=48, d=16, seed=2), "bundle_k": 5, "alpha": alpha, "diversify": diversify}
    r1 = pair.post("/v1/bundle", json_body=p)
    assert r1.headers["X-Cache"] == "MISS" and len(r1.json()["bundle"]) == 5
    if not diversify:
        scores = [e["score"] for e in r1.json()["bundle"]]
        assert scores == sorted(scores, reverse=True)
    r2 = pair.post("/v1/bundle", json_body=p)
    assert r2.headers["X-Cache"] == "HIT" and r2.json()["bundle"] == r1.json()["bundle"]


def test_chain_receipt_matches_jax(pair):
    for chain in ([0, 1, 2, 3], [5, 17, 2, 30, 11]):
        p = {**_payload(n=36, d=8, seed=3), "chain": chain, "z_th": 1.5}
        body = pair.post("/v1/chain/receipt", json_body=p).json()
        assert "verdict" in body["chain_receipt"]
        assert len(body["chain_receipt"]["edges"]) == len(chain) - 1


def test_signed_receipts_cross_verify(pair, monkeypatch):
    monkeypatch.setenv("OSCILLINK_RECEIPT_SECRET", "shared-secret")
    _clear_settings()
    rp, rj = pair.both("POST", "/v1/settle", json_body=_payload(n=40, d=16, seed=4))
    assert rp.status_code == rj.status_code == 200
    assert_same(rp.json(), rj.json())
    assert _signatures(rp.json(), rj.json(), "shared-secret") == 1
    assert rp.json()["receipt"]["meta"]["signature"]["payload"]["state_sig"] == rp.json()["state_sig"]


def test_settle_batch_matches_jax(pair):
    rng = np.random.default_rng(11)
    Y = rng.standard_normal((32, 8)).astype(np.float32)
    psis = rng.standard_normal((3, 8)).astype(np.float32)
    r = pair.post("/v1/settle/batch", json_body={"Y": Y.tolist(), "psis": psis.tolist(), "bundle_k": 4})
    body = r.json()
    assert body["queries"] == 3 and len(body["bundles"]) == 3 and len(body["bundles"][0]) == 4
    single = pair.post("/v1/settle", json_body={
        "Y": Y.tolist(), "psi": psis[0].tolist(), "options": {"bundle_k": 4, "include_receipt": False},
    }).json()
    assert [e["id"] for e in body["bundles"][0]] == [e["id"] for e in single["bundle"]]


def test_bundle_ragged_matches_jax(pair):
    rng = np.random.default_rng(5)
    corpora = [rng.standard_normal((n, 8)).astype(np.float32) for n in (12, 30, 21)]
    psis = [c[:3].mean(0) for c in corpora]
    gates = [None, np.linspace(0.5, 1.0, 30).astype(np.float32).tolist(), None]
    r = pair.post("/v1/bundle/ragged", json_body={
        "corpora": [c.tolist() for c in corpora], "psis": [p.tolist() for p in psis],
        "gates": gates, "bundle_k": 4,
    })
    body = r.json()
    assert body["corpora"] == 3 and body["meta"]["Ns"] == [12, 30, 21]
    assert [len(x["bundle"]) for x in body["results"]] == [4, 4, 4]


def _poll(client, job_id):
    deadline = time.time() + 60
    while time.time() < deadline:
        jr = client.get(f"/v1/jobs/{job_id}")
        assert jr.status_code == 200
        if jr.json()["status"] in ("done", "error"):
            return jr.json()
        time.sleep(0.02)
    raise AssertionError("job did not finish")


def test_jobs_match_jax(pair):
    p = _payload(seed=4, bundle_k=3)
    random.seed(SEED)
    rj = pair.jax.post("/v1/jobs/settle", json_body=p)
    random.seed(SEED)
    rp = pair.port.post("/v1/jobs/settle", json_body=p)
    assert rp.status_code == rj.status_code == 202
    done_p, done_j = _poll(pair.port, rp.json()["job_id"]), _poll(pair.jax, rj.json()["job_id"])
    assert done_p["status"] == done_j["status"] == "done"
    assert_same(done_p["result"], done_j["result"])
    assert done_p["result"]["backend"] == "device"
    assert done_p["result"]["receipt"]["deltaH_total"] is not None


def _clustered(n=30, d=16, seed=3):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    Y[: n // 2] += 2.5
    psi = Y[: n // 2].mean(axis=0)
    return Y, (psi / (np.linalg.norm(psi) + 1e-12)).astype(np.float32)


def test_diffusion_settle_under_pro_key_matches_jax(pair, monkeypatch):
    """As tests/test_service.py::test_diffusion_tier_gate sets it up: a pro
    key may send gates and diffusion blocks, a free key may not."""
    monkeypatch.setenv("OSCILLINK_API_KEYS", "fk")
    monkeypatch.setenv("OSCILLINK_KEY_TIERS", "fk:free")
    Y, psi = _clustered()
    p = {"Y": Y.tolist(), "psi": psi.tolist(), "diffusion": {"beta": 1.0, "gamma": 0.1},
         "options": {"bundle_k": 5}}
    h = {"X-API-Key": "fk"}
    assert pair.post("/v1/settle", json_body=p, headers=h).status_code == 403
    monkeypatch.setenv("OSCILLINK_KEY_TIERS", "fk:pro")
    rp, rj = pair.both("POST", "/v1/settle", json_body=p, headers=h)
    assert rp.status_code == rj.status_code == 200
    body = rp.json()
    assert body["meta"]["diffusion"] == {"beta": 1.0, "gamma": 0.1}
    assert body["receipt"]["meta"]["gates_min"] < body["receipt"]["meta"]["gates_max"]
    # the derived gates agree within f32 rounding, and the state signature
    # (over the gates rounded to 1e-6) is the JAX one exactly when every
    # gate rounds alike (ROADMAP.md queue C: derived gates and state_sig)
    gates = []
    for pkg, dev in ((pt, {"device": "cpu"}), (ot, {})):
        lat = pkg.Oscillink(Y, kneighbors=6, **dev)
        lat.set_query(psi)
        gates.append(np.asarray(lat.diffusion_gates(beta=1.0, gamma=0.1, tol=1e-4, max_iters=256)))
    assert np.abs(gates[0] - gates[1]).max() <= 1e-6
    rounded_alike = np.array_equal(np.round(gates[0], 6), np.round(gates[1], 6))
    assert (body["state_sig"] == rj.json()["state_sig"]) == rounded_alike
    assert_same(body, rj.json(), skip=("state_sig",))
    # explicit gates and a diffusion-gated settle batch on the same key
    pair.post("/v1/settle", json_body={**p, "diffusion": None, "gates": [0.5] * 30}, headers=h)
    pair.post("/v1/settle/batch", headers=h, json_body={
        "Y": Y.tolist(), "psis": [psi.tolist(), Y[20].tolist()], "bundle_k": 4,
        "diffusion": {"beta": 1.0, "gamma": 0.2},
    })


def test_graph_cache_hit_and_miss_match_jax(pair, monkeypatch):
    monkeypatch.setenv("OSCILLINK_GRAPH_CACHE_SIZE", "4")
    p = _payload(n=40, d=16, seed=8)
    first = pair.post("/v1/settle", json_body=p).json()
    rng = np.random.default_rng(9)
    other = {**p, "psi": rng.standard_normal(16).astype(np.float32).tolist()}
    second = pair.post("/v1/settle", json_body=other).json()
    assert first["meta"]["graph_cache"] == "MISS" and second["meta"]["graph_cache"] == "HIT"
    assert pair.post("/v1/bundle", json_body={**other, "bundle_k": 4}).status_code == 200
    fresh = _payload(n=40, d=16, seed=10)
    assert pair.post("/v1/settle", json_body=fresh).json()["meta"]["graph_cache"] == "MISS"


def test_adaptive_profiles_match_jax(pair, monkeypatch):
    monkeypatch.setenv("OSCILLINK_API_KEYS", "ak")
    monkeypatch.setenv("OSCILLINK_ADAPTIVE_PROFILES", "1")
    monkeypatch.setenv("OSCILLINK_ADAPTIVE_LEARN", "1")
    monkeypatch.setenv("OSCILLINK_ADAPTIVE_EPS", "0.5")
    h = {"X-API-Key": "ak"}
    for s in range(4):
        pair.post("/v1/settle", json_body=_payload(seed=s), headers=h)
    assert pair.state.learners.store.get("ak")["obs_count"] == 4


def test_bench_competitor_matches_jax(pair):
    texts = [
        "paris is the capital of france",
        "london is the capital of england",
        "the moon is made of cheese",
        "berlin is the capital of germany",
        "rome is the capital of italy",
    ]
    body = pair.post("/v1/bench/competitor", json_body={
        "texts": texts, "query": "what is the capital of france", "labels": [1, 0, 0, 0, 0],
        "traps": [2], "k": 2, "kneighbors": 3,
    }).json()
    assert body["cosine"]["f1"] is not None and "oscillink" in body


def test_autocorrect_and_openapi_match_jax(pair):
    r = pair.post("/v1/autocorrect", json_body={"text": "teh lattice recieve API_KEY"})
    assert r.json()["changed"] is True
    schema = pair.get("/openapi.json").json()
    assert {"/v1/settle", "/v1/bundle/ragged", "/admin/introspect"} <= set(schema["paths"])
    assert pair.get("/health").json()["status"] == "ok"


# -- the routes of tests/test_service.py on the port's service ----------------


def test_bundle_cache_keyed_on_alpha_and_k(client):
    p = {**_payload(seed=9), "bundle_k": 5, "alpha": 0.0}
    assert client.post("/v1/bundle", json_body=p).headers["X-Cache"] == "MISS"
    assert client.post("/v1/bundle", json_body={**p, "alpha": 1.0}).headers["X-Cache"] == "MISS"
    r_k9 = client.post("/v1/bundle", json_body={**p, "bundle_k": 9})
    assert r_k9.headers["X-Cache"] == "MISS" and len(r_k9.json()["bundle"]) == 9
    assert client.post("/v1/bundle", json_body=p).headers["X-Cache"] == "HIT"


def test_auth_env_keys(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_API_KEYS", "k1,k2")
    assert client.post("/v1/settle", json_body=_payload()).status_code == 401
    r2 = client.post("/v1/settle", json_body=_payload(), headers={"X-API-Key": "k1"})
    assert r2.status_code == 200


def test_shape_caps(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_MAX_NODES", "10")
    _clear_settings()
    r = client.post("/v1/settle", json_body=_payload(n=24))
    _clear_settings()
    assert r.status_code == 413


def test_quota_window(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_API_KEYS", "qk")
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_LIMIT", "400")
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_WINDOW", "3600")
    h = {"X-API-Key": "qk"}
    assert client.post("/v1/settle", json_body=_payload(), headers=h).status_code == 200
    r2 = client.post("/v1/settle", json_body=_payload(), headers=h)
    assert r2.status_code == 200 and r2.headers["X-Quota-Remaining"] == "16"
    r3 = client.post("/v1/settle", json_body=_payload(), headers=h)
    assert r3.status_code == 429 and "Retry-After" in r3.headers


def test_monthly_cap(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_API_KEYS", "mk")
    monkeypatch.setenv("OSCILLINK_MONTHLY_CAP", "300")
    h = {"X-API-Key": "mk"}
    r1 = client.post("/v1/settle", json_body=_payload(), headers=h)
    assert r1.status_code == 200 and r1.headers["X-Monthly-Remaining"] == "108"
    assert client.post("/v1/settle", json_body=_payload(), headers=h).status_code == 429


def test_global_and_per_ip_rate_limits(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_RATE_LIMIT", "2")
    monkeypatch.setenv("OSCILLINK_RATE_WINDOW", "60")
    assert [client.get("/health").status_code for _ in range(3)] == [200, 200, 429]
    monkeypatch.delenv("OSCILLINK_RATE_LIMIT")
    monkeypatch.setenv("OSCILLINK_IP_RATE_LIMIT", "1")
    assert client.get("/health", remote_ip="1.2.3.4").status_code == 200
    assert client.get("/health", remote_ip="1.2.3.4").status_code == 429
    assert client.get("/health", remote_ip="5.6.7.8").status_code == 200


def test_diffusion_killswitch(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_API_KEYS", "pk")
    monkeypatch.setenv("OSCILLINK_KEY_TIERS", "pk:pro")
    monkeypatch.setenv("OSCILLINK_DIFFUSION_GATES_ENABLED", "0")
    p = {**_payload(), "gates": [1.0] * 24}
    assert client.post("/v1/settle", json_body=p, headers={"X-API-Key": "pk"}).status_code == 403


def test_jobs_delete_unknown_and_foreign(client, monkeypatch):
    assert client.delete("/v1/jobs/doesnotexist").status_code == 404
    monkeypatch.setenv("OSCILLINK_API_KEYS", "a1,a2")
    job = client.post("/v1/jobs/settle", json_body=_payload(), headers={"X-API-Key": "a1"})
    job_id = job.json()["job_id"]
    assert client.get(f"/v1/jobs/{job_id}", headers={"X-API-Key": "a2"}).status_code == 404
    assert client.get(f"/v1/jobs/{job_id}", headers={"X-API-Key": "a1"}).status_code == 200


def test_stripe_webhook_unverified_and_idempotent(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_ALLOW_UNVERIFIED_STRIPE", "1")
    evt = {"id": "evt_123", "type": "checkout.session.completed",
           "data": {"object": {"id": "cs_1", "metadata": {"tier": "pro"}}}}
    r1 = client.post("/stripe/webhook", json_body=evt)
    assert r1.status_code == 200 and r1.json()["action"] == "provisioned"
    assert client.state.keystore.get(r1.json()["api_key"]).tier == "pro"
    assert client.post("/stripe/webhook", json_body=evt).json()["status"] == "duplicate"


def test_billing_success_pages(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_ALLOW_UNVERIFIED_STRIPE", "1")
    assert "provisioned" in client.get("/billing/success", query={"session_id": "cs_pl_1"}).text
    evt = {"id": "evt_pl_1", "type": "checkout.session.completed",
           "data": {"object": {"id": "cs_pl_1", "metadata": {"tier": "beta"}}}}
    key = client.post("/stripe/webhook", json_body=evt).json()["api_key"]
    page = client.get("/billing/success", query={"session_id": "cs_pl_1"})
    assert key in page.text and "beta" in page.text
    assert key not in client.get("/billing/success").text
    evt2 = {"id": "evt_pl_2", "type": "checkout.session.completed",
            "data": {"object": {"id": "cs_pl_2", "metadata": {"tier": "enterprise"}}}}
    client.post("/stripe/webhook", json_body=evt2)
    assert "pending" in client.get("/billing/success", query={"session_id": "cs_pl_2"}).text
    rec = client.state.webhooks._checkouts["cs_pl_2"]
    rec["ts"] -= client.state.webhooks.CHECKOUT_TTL + 1
    assert client.state.webhooks.lookup_checkout("cs_pl_2") is None


def test_stripe_webhook_rejected_without_secret(client, monkeypatch):
    monkeypatch.delenv("OSCILLINK_ALLOW_UNVERIFIED_STRIPE", raising=False)
    monkeypatch.delenv("OSCILLINK_STRIPE_WEBHOOK_SECRET", raising=False)
    assert client.post("/stripe/webhook", json_body={"id": "evt_x", "type": "noop"}).status_code == 503


def test_cli_pairing_flow(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_ALLOW_UNVERIFIED_STRIPE", "1")
    code = client.post("/billing/cli/start", json_body={}).json()["code"]
    assert client.get(f"/billing/cli/poll/{code}").json()["status"] == "pending"
    client.state.cli_sessions._sessions[code]["metadata"]["checkout_session_id"] = "cs_99"
    evt = {"id": "evt_cli", "type": "checkout.session.completed",
           "data": {"object": {"id": "cs_99", "metadata": {"tier": "beta"}}}}
    client.post("/stripe/webhook", json_body=evt)
    poll = client.get(f"/billing/cli/poll/{code}").json()
    assert poll["status"] == "complete" and poll["api_key"]
    assert client.get("/billing/cli/poll/nope").status_code == 404
    assert client.post("/billing/portal").status_code == 503


def test_admin_endpoints(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_ADMIN_SECRET", "adm")
    h = {"X-Admin-Secret": "adm"}
    r = client.put("/admin/keys/kx", json_body={"tier": "pro", "status": "active"}, headers=h)
    assert r.status_code == 200 and r.json()["tier"] == "pro"
    assert client.get("/admin/keys/kx", headers=h).status_code == 200
    assert client.get("/admin/keys/kx").status_code == 403
    price = client.get("/admin/billing/price-map", headers=h).json()
    assert price["tiers"]["free"]["monthly_unit_cap"] == 5_000_000
    intro = client.get("/admin/introspect", headers=h, query={"api_key": "kx"}).json()
    assert intro["tier"] == "pro"
    assert intro["caches"]["graph"]["enabled"] is False and intro["caches"]["graph"]["entries"] == 0
    assert client.get("/admin/usage/kx", headers=h).json()["api_key"] == "kx"
    assert client.post("/admin/billing/cancel/kx", headers=h).json()["status"] == "revoked"
    assert client.post("/v1/settle", json_body=_payload(), headers={"X-API-Key": "kx"}).status_code == 401


def test_pending_key_403(client):
    client.state.keystore.update("pend", create=True, status="pending")
    r = client.post("/v1/settle", json_body=_payload(), headers={"X-API-Key": "pend"})
    assert r.status_code == 403


def test_license_status(client, monkeypatch, tmp_path):
    monkeypatch.setenv("OSCILLINK_ENTITLEMENTS_PATH", "/nonexistent/ent.json")
    assert client.get("/license/status").json()["status"] == "unknown"
    monkeypatch.setenv("OSCILLINK_LICENSE_REQUIRED", "1")
    assert client.get("/license/status").status_code == 503
    monkeypatch.delenv("OSCILLINK_LICENSE_REQUIRED")
    ent = tmp_path / "ent.json"
    ent.write_text(json.dumps({"iss": "osc", "sub": "lic1", "tier": "pro", "exp": time.time() + 3600}))
    monkeypatch.setenv("OSCILLINK_ENTITLEMENTS_PATH", str(ent))
    body = client.get("/license/status").json()
    assert body["status"] == "ok" and body["tier"] == "pro"


def test_usage_log_written_and_verified(client, monkeypatch, tmp_path):
    log = tmp_path / "usage.jsonl"
    monkeypatch.setenv("OSCILLINK_USAGE_LOG", str(log))
    monkeypatch.setenv("OSCILLINK_USAGE_SIGNING_SECRET", "sek")
    monkeypatch.setenv("OSCILLINK_ADMIN_SECRET", "adm")
    client.post("/v1/settle", json_body=_payload(seed=5))
    lines = log.read_text().strip().splitlines()
    rec = json.loads(lines[0])
    assert len(lines) == 1 and rec["event"] == "settle" and "sig" in rec
    out = client.get("/admin/usage/None/records", headers={"X-Admin-Secret": "adm"},
                     query={"verify": "1"}).json()
    assert out["unverified"] == 0


def test_metrics_route(client, monkeypatch):
    pytest.importorskip("prometheus_client")
    client.post("/v1/settle", json_body=_payload())
    r = client.get("/metrics")
    assert r.status_code == 200 and b"settle" in r.content
    monkeypatch.setenv("OSCILLINK_METRICS_ADMIN_SECRET", "m")
    assert client.get("/metrics").status_code == 403


def test_unknown_route_404(client):
    assert client.get("/v1/doesnotexist").status_code == 404


def test_service_lattices_run_on_the_state_device(client, monkeypatch):
    from oscillink_tpu_torch.core import lattice as tlattice

    seen = []
    real = tlattice.OscillinkLattice.__init__

    def spy(self, *args, **kwargs):
        seen.append(kwargs.get("device"))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(tlattice.OscillinkLattice, "__init__", spy)
    assert client.post("/v1/settle", json_body=_payload()).status_code == 200
    assert seen and all(torch.device(d) == torch.device("cpu") for d in seen)
    assert client.state.device == torch.device("cpu")
