"""The port's service (``oscillink_tpu_torch.service``, ``device="cpu"``):
the opt-in cross-request graph cache, the cases of ``tests/test_graph_cache.py``.

Opt-in cross-request graph cache (service/graph_cache.py).

Off by default (the reference's stateless contract); enabled, a repeat
corpus skips the similarity scan and serves a behaviorally identical
response (same state_sig -> same receipts), isolated per api key and
keyed over every graph-determining input.
"""

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from oscillink_tpu_torch.service.api import create_state  # noqa: E402

import numpy as np

from oscillink_tpu_torch.service import LocalClient


def _payload(n=28, d=10, seed=0, psi_seed=None, **opts):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    qrng = np.random.default_rng(seed if psi_seed is None else psi_seed)
    qrng.standard_normal(d)  # decouple psi from Y draw order
    psi = qrng.standard_normal(d).astype(np.float32)
    return {
        "Y": Y.tolist(),
        "psi": psi.tolist(),
        "options": {"max_iters": 12, "tol": 1e-3, "include_receipt": True, **opts},
    }


@pytest.fixture()
def client(monkeypatch):
    for var in ("OSCILLINK_API_KEYS", "OSCILLINK_RECEIPT_SECRET"):
        monkeypatch.delenv(var, raising=False)
    # keep everything on the device path so the cache branch is exercised
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "0")
    return LocalClient(create_state(device="cpu"))


def test_disabled_by_default(client):
    r = client.post("/v1/settle", json_body=_payload())
    assert r.status_code == 200
    assert r.json()["meta"]["graph_cache"] is None


def test_hit_is_behaviorally_identical(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_GRAPH_CACHE_SIZE", "8")
    p = _payload(bundle_k=5)
    r1 = client.post("/v1/settle", json_body=p)
    assert r1.status_code == 200 and r1.json()["meta"]["graph_cache"] == "MISS"
    r2 = client.post("/v1/settle", json_body=p)
    assert r2.json()["meta"]["graph_cache"] == "HIT"
    b1, b2 = r1.json(), r2.json()
    assert b1["state_sig"] == b2["state_sig"]
    assert b1["receipt"]["deltaH_total"] == pytest.approx(
        b2["receipt"]["deltaH_total"], rel=1e-6
    )
    assert [e["id"] for e in b1["bundle"]] == [e["id"] for e in b2["bundle"]]
    # graph-derived meta survives the hit
    m1, m2 = b1["receipt"]["meta"], b2["receipt"]["meta"]
    assert m1["avg_degree"] == pytest.approx(m2["avg_degree"])
    assert m1["similarity"] == m2["similarity"]


def test_hit_with_different_query_is_fresh(client, monkeypatch):
    """A cache hit reuses the GRAPH only — per-request query state must not
    leak between requests sharing a corpus."""
    monkeypatch.setenv("OSCILLINK_GRAPH_CACHE_SIZE", "8")
    client.post("/v1/settle", json_body=_payload(psi_seed=1))
    r_a = client.post("/v1/settle", json_body=_payload(psi_seed=2))
    r_b = client.post("/v1/settle", json_body=_payload(psi_seed=3))
    assert r_a.json()["meta"]["graph_cache"] == "HIT"
    assert r_b.json()["meta"]["graph_cache"] == "HIT"
    # different queries -> different signatures and energies
    assert r_a.json()["state_sig"] != r_b.json()["state_sig"]
    assert (
        r_a.json()["receipt"]["deltaH_total"]
        != r_b.json()["receipt"]["deltaH_total"]
    )


def test_key_includes_graph_params(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_GRAPH_CACHE_SIZE", "8")
    p = _payload()
    client.post("/v1/settle", json_body=p)
    # different corpus -> MISS
    r = client.post("/v1/settle", json_body=_payload(seed=7))
    assert r.json()["meta"]["graph_cache"] == "MISS"
    # different kneighbors -> MISS
    p_k = {**p, "params": {"kneighbors": 4}}
    r = client.post("/v1/settle", json_body=p_k)
    assert r.json()["meta"]["graph_cache"] == "MISS"
    # deterministic_k flips the key too
    p_det = {**p, "params": {"deterministic_k": True}}
    r = client.post("/v1/settle", json_body=p_det)
    assert r.json()["meta"]["graph_cache"] == "MISS"


def test_per_api_key_isolation(client, monkeypatch):
    monkeypatch.setenv("OSCILLINK_GRAPH_CACHE_SIZE", "8")
    monkeypatch.setenv("OSCILLINK_API_KEYS", "ka,kb")
    p = _payload()
    r1 = client.post("/v1/settle", json_body=p, headers={"X-API-Key": "ka"})
    assert r1.json()["meta"]["graph_cache"] == "MISS"
    # same corpus, other tenant: never served from ka's bucket
    r2 = client.post("/v1/settle", json_body=p, headers={"X-API-Key": "kb"})
    assert r2.json()["meta"]["graph_cache"] == "MISS"
    r3 = client.post("/v1/settle", json_body=p, headers={"X-API-Key": "ka"})
    assert r3.json()["meta"]["graph_cache"] == "HIT"


def test_diffusion_over_cached_graph(client, monkeypatch):
    """Server-side diffusion gates derive over the cached graph on a hit
    and match the fresh-build derivation."""
    monkeypatch.setenv("OSCILLINK_GRAPH_CACHE_SIZE", "8")
    monkeypatch.setenv("OSCILLINK_FEAT_DIFFUSION_GATES", "1")
    p = _payload()
    p["diffusion"] = {"enable": True, "beta": 1.0, "gamma": 0.1}
    r1 = client.post("/v1/settle", json_body=p)
    r2 = client.post("/v1/settle", json_body=p)
    assert r1.json()["meta"]["graph_cache"] == "MISS"
    assert r2.json()["meta"]["graph_cache"] == "HIT"
    m1, m2 = r1.json()["receipt"]["meta"], r2.json()["receipt"]["meta"]
    assert m1["gates_mean"] == pytest.approx(m2["gates_mean"], rel=1e-6)
    assert r1.json()["receipt"]["deltaH_total"] == pytest.approx(
        r2.json()["receipt"]["deltaH_total"], rel=1e-6
    )


def test_prometheus_counter_tracks_hits_and_misses(client, monkeypatch):
    """Cache observability: oscillink_graph_cache_total{status=...} moves
    with each lookup outcome (no-op when prometheus_client is absent)."""
    pytest.importorskip("prometheus_client")
    monkeypatch.setenv("OSCILLINK_GRAPH_CACHE_SIZE", "8")
    ctr = client.state.metrics.graph_cache

    def val(status):
        return ctr.labels(status=status)._value.get()

    miss0, hit0 = val("miss"), val("hit")
    p = _payload()
    client.post("/v1/settle", json_body=p)
    assert (val("miss"), val("hit")) == (miss0 + 1, hit0)
    client.post("/v1/settle", json_body=p)
    assert (val("miss"), val("hit")) == (miss0 + 1, hit0 + 1)


def test_global_bound_evicts_across_tenants(monkeypatch):
    """Graph-cache snapshots pin device memory, so OSCILLINK_GRAPH_CACHE_SIZE
    bounds TOTAL entries across api keys — filling one tenant's bucket must
    evict the least-recently-used entry of another tenant."""
    from oscillink_tpu_torch.service.graph_cache import GraphCache

    monkeypatch.setenv("OSCILLINK_GRAPH_CACHE_SIZE", "3")
    gc = GraphCache()
    gc.put_snapshot("ka", "s1", {"v": 1})
    gc.put_snapshot("ka", "s2", {"v": 2})
    gc.put_snapshot("kb", "s3", {"v": 3})
    # recency: touch ka/s1 so ka/s2 is the global LRU victim
    assert gc.get_snapshot("ka", "s1") == {"v": 1}
    gc.put_snapshot("kb", "s4", {"v": 4})
    assert gc.get_snapshot("ka", "s2") is None  # evicted (oldest access)
    assert gc.get_snapshot("ka", "s1") == {"v": 1}
    assert gc.get_snapshot("kb", "s3") == {"v": 3}
    assert gc.get_snapshot("kb", "s4") == {"v": 4}


def test_expired_snapshots_dropped_on_access(monkeypatch):
    """Device buffers must not stay pinned past TTL waiting for the
    every-256-puts sweep: any get/put sweeps expired entries out."""
    from oscillink_tpu_torch.service.graph_cache import GraphCache

    monkeypatch.setenv("OSCILLINK_GRAPH_CACHE_SIZE", "8")
    monkeypatch.setenv("OSCILLINK_GRAPH_CACHE_TTL", "60")
    gc = GraphCache()
    gc.put_snapshot("ka", "s1", {"v": 1})
    gc.put_snapshot("kb", "s2", {"v": 2})
    # age both entries past TTL without touching them
    with gc._lock:
        for bucket in gc._per_key.values():
            for rec in bucket.values():
                rec["ts"] -= 120.0
    gc.sweep_expired()
    with gc._lock:
        assert gc._per_key == {}  # buffers released, not just masked


def test_cache_key_uses_full_anchor_hash():
    """The sampled fingerprint is lossy above _FULL_HASH_LIMIT; as a cache
    KEY two corpora differing only in stride-skipped rows must not collide."""
    from oscillink_tpu_torch.core import lattice as L

    rng = np.random.default_rng(0)
    Y1 = rng.standard_normal((64, 8)).astype(np.float32)
    Y2 = Y1.copy()
    Y2[1] += 1.0  # row a stride>1 sample would skip
    orig, L._FULL_HASH_LIMIT = L._FULL_HASH_LIMIT, 64
    try:
        sampled1 = L.OscillinkLattice._hash_anchors(Y1)
        sampled2 = L.OscillinkLattice._hash_anchors(Y2)
        full1 = L.OscillinkLattice._hash_anchors(Y1, full=True)
        full2 = L.OscillinkLattice._hash_anchors(Y2, full=True)
    finally:
        L._FULL_HASH_LIMIT = orig
    assert sampled1 == sampled2  # demonstrates the fingerprint IS lossy here
    assert full1 != full2  # the key hash must distinguish them


def test_key_includes_corpus_shape(client, monkeypatch):
    """Two corpora with IDENTICAL bytes but different (N, D) must never
    share a graph: the full-content anchor hash covers raw bytes only, so
    the shape lives in the cache key (ADVICE r4, service/graph_cache.py)."""
    monkeypatch.setenv("OSCILLINK_GRAPH_CACHE_SIZE", "8")
    rng = np.random.default_rng(11)
    flat = rng.standard_normal(240).astype(np.float32)
    psi_a = rng.standard_normal(10).astype(np.float32)
    psi_b = rng.standard_normal(8).astype(np.float32)
    p_a = {
        "Y": flat.reshape(24, 10).tolist(),
        "psi": psi_a.tolist(),
        "options": {"max_iters": 8, "tol": 1e-3},
    }
    p_b = {
        "Y": flat.reshape(30, 8).tolist(),
        "psi": psi_b.tolist(),
        "options": {"max_iters": 8, "tol": 1e-3},
    }
    r1 = client.post("/v1/settle", json_body=p_a)
    assert r1.status_code == 200 and r1.json()["meta"]["graph_cache"] == "MISS"
    # same bytes, different shape: MUST miss (a hit would install a graph
    # built for a 24-row corpus into a 30-row lattice)
    r2 = client.post("/v1/settle", json_body=p_b)
    assert r2.status_code == 200 and r2.json()["meta"]["graph_cache"] == "MISS"
    assert r2.json()["meta"]["N"] == 30 and r2.json()["meta"]["D"] == 8


def test_install_snapshot_rejects_wrong_row_count():
    """Defense-in-depth behind the shape-keyed cache: installing a snapshot
    whose graph was built for a different N fails loudly."""
    from oscillink_tpu_torch import OscillinkLattice

    rng = np.random.default_rng(3)
    Y24 = rng.standard_normal((24, 10)).astype(np.float32)
    src = OscillinkLattice(Y24, kneighbors=4, device="cpu")
    snap = src._graph_snapshot()
    dst = OscillinkLattice(
        rng.standard_normal((30, 10)).astype(np.float32),
        kneighbors=4,
        _defer_graph=True,
        device="cpu",
    )
    with pytest.raises(ValueError, match="row count"):
        dst._install_graph_snapshot(snap)
