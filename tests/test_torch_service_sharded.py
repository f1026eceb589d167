"""The port's sharded service route (``OSCILLINK_SHARDED_MIN_N``) against
the JAX service's, case by case from ``tests/test_service_sharded.py``.

Each request goes through the JAX `LocalClient` (its mesh: the 8 virtual
CPU devices of ``tests/conftest.py``) and the port's
``create_state(device="cpu", mesh=8 CPU shards)``.  The bodies agree apart
from timings and ids: ``state_sig``, iterations, null points, bundle ids and
chain verdicts equal, ΔH within 1e-5 relative, other floats within 1e-4
(z-scores 1e-3 absolute), ``meta.backend`` and ``mesh_devices`` equal;
signed receipts verify across the packages.  Against the device route the
JAX file's own bars hold (rel 2e-3; nulls and bundle ids equal).
"""

import random
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu.core.receipts import verify_receipt as jax_verify  # noqa: E402
from oscillink_tpu.parallel.mesh import lattice_mesh as jax_mesh  # noqa: E402
from oscillink_tpu.parallel.sharded_build import build_graph_sharded as jax_build_sharded  # noqa: E402
from oscillink_tpu.service import LocalClient as JaxClient  # noqa: E402
from oscillink_tpu.service import config as jax_config  # noqa: E402
from oscillink_tpu.service.api import create_state as jax_create_state  # noqa: E402
from oscillink_tpu_torch.core.receipts import verify_receipt as port_verify  # noqa: E402
from oscillink_tpu_torch.parallel.mesh import lattice_mesh  # noqa: E402
from oscillink_tpu_torch.parallel.sharded_build import build_graph_sharded  # noqa: E402
from oscillink_tpu_torch.service import LocalClient  # noqa: E402
from oscillink_tpu_torch.service import config as port_config  # noqa: E402
from oscillink_tpu_torch.service.api import create_state  # noqa: E402

SECRET = "shard-secret"
DH_REL = 1e-5
FLOAT_RTOL, FLOAT_ATOL = 1e-4, 1e-5
Z_ATOL = 1e-3  # z-scores divide by a row's spread: an ulp of it moves z by more
DEVICE_REL = 2e-3  # tests/test_service_sharded.py's sharded-vs-device bar
ENV = (
    "OSCILLINK_API_KEYS",
    "OSCILLINK_KEY_TIERS",
    "OSCILLINK_KEY_NODE_UNITS_LIMIT",
    "OSCILLINK_MONTHLY_CAP",
    "OSCILLINK_RATE_LIMIT",
    "OSCILLINK_IP_RATE_LIMIT",
    "OSCILLINK_NATIVE_SMALL_N",
    "OSCILLINK_SHARDED_MIN_N",
    "OSCILLINK_RECEIPT_NULL_CAP",
    "OSCILLINK_FEAT_DIFFUSION_GATES",
)


def _payload(n, d, seed=0, **opts):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    return {"Y": Y.tolist(), "psi": psi.tolist(), "options": {"max_iters": 8, "tol": 1e-3, **opts}}


def _skip(key: str) -> bool:
    return key in ("timings_ms", "request_id", "job_id", "t_ms", "ms") or key.endswith("_ms")


def assert_same(port, jax, path="body"):
    """The port's body against the JAX service's at this file's bars."""
    if isinstance(jax, dict):
        assert isinstance(port, dict) and set(port) == set(jax), (path, set(port) ^ set(jax))
        for key in jax:
            if not _skip(key) and key != "signature":
                assert_same(port[key], jax[key], f"{path}.{key}")
    elif isinstance(jax, list):
        assert isinstance(port, list) and len(port) == len(jax), path
        for i, (a, b) in enumerate(zip(port, jax)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(jax, float) and not isinstance(jax, bool):
        assert isinstance(port, (int, float)) and not isinstance(port, bool), path
        if path.endswith("deltaH_total"):
            assert abs(port - jax) <= DH_REL * max(abs(jax), 1e-30), (path, port, jax)
        elif path.endswith((".z", "zscore", "z_struct", "z_path")):
            assert abs(port - jax) <= Z_ATOL + FLOAT_RTOL * abs(jax), (path, port, jax)
        else:
            assert abs(port - jax) <= FLOAT_ATOL + FLOAT_RTOL * abs(jax), (path, port, jax)
    else:
        assert port == jax and type(port) is type(jax), (path, port, jax)


class Pair:
    """The JAX service and the port's (8 CPU shards) side by side."""

    def __init__(self):
        self.jax = JaxClient(jax_create_state())
        self.port = LocalClient(create_state(device="cpu", mesh=[torch.device("cpu")] * 8))

    def both(self, method, path, **kw):
        random.seed(0)
        rj = self.jax.request(method, path, **kw)
        random.seed(0)
        rp = self.port.request(method, path, **kw)
        assert rp.status_code == rj.status_code, (rp.json(), rj.json())
        for key in ("X-Cache", "X-Cache-Key"):
            assert rp.headers.get(key) == rj.headers.get(key)
        return rp, rj

    def post(self, path, json_body=None, **kw):
        rp, rj = self.both("POST", path, json_body=json_body, **kw)
        assert_same(rp.json(), rj.json())
        return rp


@pytest.fixture()
def pair(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("OSCILLINK_RECEIPT_SECRET", SECRET)
    monkeypatch.setenv("OSCILLINK_MAX_NODES", "200000")
    port_config.get_settings.cache_clear()
    jax_config.get_settings.cache_clear()
    yield Pair()
    port_config.get_settings.cache_clear()
    jax_config.get_settings.cache_clear()


def _cross_verify(body):
    rec = body["receipt"]
    assert port_verify(rec, SECRET) and jax_verify(rec, SECRET)


def test_sharded_path_matches_single_device(pair, monkeypatch):
    p = _payload(512, 16, seed=7, bundle_k=5)
    dev = pair.post("/v1/settle", json_body=p).json()
    assert dev["meta"]["backend"] == "device"
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "256")
    sh = pair.post("/v1/settle", json_body=p).json()
    assert sh["meta"]["backend"] == "sharded" and sh["receipt"]["meta"]["mesh_devices"] == 8
    assert sh["state_sig"] == dev["state_sig"]
    for key in ("deltaH_total", "coh_drop_sum", "anchor_pen_sum", "query_term_sum"):
        assert sh["receipt"][key] == pytest.approx(dev["receipt"][key], rel=DEVICE_REL)
    assert ({tuple(e["edge"]) for e in sh["receipt"]["null_points"]}
            == {tuple(e["edge"]) for e in dev["receipt"]["null_points"]})
    assert [e["id"] for e in sh["bundle"]] == [e["id"] for e in dev["bundle"]]
    for body in (dev, sh):
        _cross_verify(body)


def test_sharded_path_signed_receipt_65k(pair, monkeypatch):
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "8192")
    n, d = 65536, 8
    rng = np.random.default_rng(0)
    centers = 4.0 * rng.standard_normal((32, d)).astype(np.float32)
    Y = (centers[rng.integers(0, 32, size=n)] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    p = {
        "Y": Y.tolist(),
        "psi": psi.tolist(),
        "params": {"kneighbors": 4, "similarity": "fastest"},
        "options": {"max_iters": 10, "tol": 1e-3, "bundle_k": 8},
    }
    rp, rj = pair.both("POST", "/v1/settle", json_body=p)
    body, bj = rp.json(), rj.json()
    rec, rec_j = body["receipt"], bj["receipt"]
    assert body["meta"]["backend"] == "sharded" and rec["meta"]["mesh_devices"] == 8
    # the fastest scan's bf16 candidates near-tie differently in the two
    # packages' matmuls on this D = 8 corpus (65 of 65536 rows' neighbour
    # lists differ, queue C): ΔH, iterations, null edges, bundle ids and the
    # signature agree at this file's bars, the three component sums at the
    # device route's
    assert body["state_sig"] == bj["state_sig"]
    assert abs(rec["deltaH_total"] - rec_j["deltaH_total"]) <= DH_REL * rec_j["deltaH_total"]
    for key in ("coh_drop_sum", "anchor_pen_sum", "query_term_sum"):
        assert rec[key] == pytest.approx(rec_j[key], rel=DEVICE_REL)
    assert rec["cg_iters"] == rec_j["cg_iters"]
    assert rec["meta"]["ustar_iters"] == rec_j["meta"]["ustar_iters"]
    assert len(rec["null_points"]) == len(rec_j["null_points"])
    assert [e["id"] for e in body["bundle"]] == [e["id"] for e in bj["bundle"]]
    # null edges equal on every row whose own and whose neighbours' lists
    # agree between the two packages' graphs (weights to f32 rounding)
    gj = jax_build_sharded(jax_mesh(8), Y, 4, similarity="fastest")
    gp = build_graph_sharded(lattice_mesh(devices=["cpu"] * 8), Y, 4, similarity="fastest")
    ij, wj = np.asarray(gj.idx), np.asarray(gj.w)
    same = (ij == gp.idx.numpy()).all(1) & (np.abs(wj - gp.w.numpy()) <= 1e-6).all(1)
    assert (~same).sum() < 0.002 * n, (~same).sum()
    clean = same & same[ij].all(1)
    port_nulls = {tuple(e["edge"]) for e in rec["null_points"] if clean[e["edge"][0]]}
    jax_nulls = {tuple(e["edge"]) for e in rec_j["null_points"] if clean[e["edge"][0]]}
    assert port_nulls == jax_nulls and len(port_nulls) > 0.9 * len(rec_j["null_points"])
    assert np.isfinite(rec["deltaH_total"]) and rec["deltaH_total"] >= 0.0
    assert len(body["bundle"]) == 8
    _cross_verify(body)


def test_sharded_chain_prior_matches_device(pair, monkeypatch):
    p = {**_payload(128, 8, seed=1), "chain": [0, 1, 2, 3], "params": {"lamP": 0.3}}
    dev = pair.post("/v1/settle", json_body=p).json()
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "64")
    sh = pair.post("/v1/settle", json_body=p).json()
    assert (dev["meta"]["backend"], sh["meta"]["backend"]) == ("device", "sharded")
    assert sh["state_sig"] == dev["state_sig"]
    assert sh["receipt"]["deltaH_total"] == pytest.approx(dev["receipt"]["deltaH_total"],
                                                          rel=DEVICE_REL)


def test_sharded_routing_exclusions(pair, monkeypatch):
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "64")
    p = _payload(128, 8, seed=2)
    p["params"] = {"deterministic_k": False, "neighbor_seed": 7}
    assert pair.post("/v1/settle", json_body=p).json()["meta"]["backend"] == "device"


def _poll(client, job_id):
    for _ in range(400):
        jr = client.get(f"/v1/jobs/{job_id}").json()
        if jr["status"] in {"done", "error"}:
            return jr
        time.sleep(0.05)
    return jr


def test_jobs_route_to_sharded_tier(pair, monkeypatch):
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "64")
    p = _payload(128, 8, seed=5, bundle_k=3)
    rj = pair.jax.post("/v1/jobs/settle", json_body=p)
    rp = pair.port.post("/v1/jobs/settle", json_body=p)
    assert rp.status_code == rj.status_code == 202
    jj, jp = _poll(pair.jax, rj.json()["job_id"]), _poll(pair.port, rp.json()["job_id"])
    assert jp["status"] == jj["status"] == "done", jp
    assert jp["result"]["backend"] == "sharded"
    assert_same(jp["result"], jj["result"])


def test_bundle_endpoint_routes_sharded_with_cache(pair, monkeypatch):
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "64")
    p = {**_payload(256, 8, seed=6), "bundle_k": 4}
    r1 = pair.post("/v1/bundle", json_body=p)
    assert r1.headers["X-Cache"] == "MISS" and r1.json()["meta"]["backend"] == "sharded"
    assert len(r1.json()["bundle"]) == 4
    r2 = pair.post("/v1/bundle", json_body=p)
    assert r2.headers["X-Cache"] == "HIT" and r2.json()["bundle"] == r1.json()["bundle"]
    monkeypatch.delenv("OSCILLINK_SHARDED_MIN_N")
    r3 = pair.post("/v1/bundle", json_body=p)
    assert r3.json()["state_sig"] == r1.json()["state_sig"]
    assert [e["id"] for e in r3.json()["bundle"]] == [e["id"] for e in r1.json()["bundle"]]


def test_chain_receipt_endpoint_routes_sharded(pair, monkeypatch):
    p = {**_payload(256, 8, seed=8), "chain": [0, 3, 7, 11], "z_th": 2.5}
    dev = pair.post("/v1/chain/receipt", json_body=p).json()
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "64")
    sh = pair.post("/v1/chain/receipt", json_body=p).json()
    assert sh["meta"]["backend"] == "sharded" and sh["state_sig"] == dev["state_sig"]
    cd, cs = dev["chain_receipt"], sh["chain_receipt"]
    assert cs["verdict"] == cd["verdict"]
    assert cs["weakest_link"]["edge"] == cd["weakest_link"]["edge"]
    assert cs["coherence_gain"] == pytest.approx(cd["coherence_gain"], rel=DEVICE_REL)
    for es, ed in zip(cs["edges"], cd["edges"]):
        assert es["z_struct"] == pytest.approx(ed["z_struct"], rel=1e-2, abs=1e-3)
        assert es["z_path"] == pytest.approx(ed["z_path"], rel=1e-2, abs=1e-3)


def test_sharded_validation_mirrors_device_400s(pair, monkeypatch):
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "64")
    monkeypatch.setenv("OSCILLINK_FEAT_DIFFUSION_GATES", "1")
    p = _payload(128, 8, seed=4)
    bad_psi = dict(p)
    bad_psi["psi"] = [0.0] * 9
    for body in ({**p, "gates": [1.0] * 127}, bad_psi, {**p, "chain": [0, 500]}):
        assert pair.post("/v1/settle", json_body=body).status_code == 400
    r = pair.post("/v1/chain/receipt", json_body={**p, "chain": [0, 500], "z_th": 2.5})
    assert r.status_code == 400


def test_sharded_chain_receipt_accepts_cluster_similarity(pair, monkeypatch):
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "64")
    p = {**_payload(128, 8, seed=5), "chain": [0, 3, 7], "z_th": 2.5}
    p["params"] = {"similarity": "cluster"}
    assert pair.post("/v1/chain/receipt", json_body=p).json()["meta"]["backend"] == "sharded"


def test_sharded_receipt_honors_null_cap(pair, monkeypatch):
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "64")
    monkeypatch.setenv("OSCILLINK_RECEIPT_NULL_CAP", "2")
    rng = np.random.default_rng(9)
    Y = rng.standard_normal((128, 8)).astype(np.float32)
    Y[5] += 25.0
    Y[60] -= 25.0
    p = {"Y": Y.tolist(), "psi": rng.standard_normal(8).astype(np.float32).tolist(),
         "options": {"max_iters": 8, "tol": 1e-3}}
    rec = pair.post("/v1/receipt", json_body=p).json()["receipt"]
    summary = rec["meta"]["null_points_summary"]
    assert summary["total_null_points"] > 2 and summary["null_cap_applied"] is True
    assert len(rec["null_points"]) == 2


def test_rerank_bundle_routes_off_sharded(pair, monkeypatch):
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "64")
    p = _payload(128, 8, seed=6, bundle_k=5)
    p["options"]["bundle_diversify"] = False
    r = pair.post("/v1/settle", json_body=p)
    assert r.json()["meta"]["backend"] == "device"
    scores = [e["score"] for e in r.json()["bundle"]]
    assert scores == sorted(scores, reverse=True)
    p2 = _payload(128, 8, seed=6, bundle_k=5)
    assert pair.post("/v1/settle", json_body=p2).json()["meta"]["backend"] == "sharded"
