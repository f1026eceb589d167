"""The port's `parallel.streaming.StreamingLattice` against the JAX
package's on the scenarios of ``tests/test_streaming.py``: every delta
receipt's shard receipts (ΔH and alignment within 1e-5 relative, identical
iterations, rows, generations), the super level (ranking equal), the
composed ΔH, and the composition signature equal exactly when every value
it rounds rounds alike; bundles equal; signed receipts verify across the
packages.  The port's own invariants are checked as the JAX file checks
them: zero padding is inert, a fully flushed stream composes the
hierarchical receipts, consolidation keeps the stream continuous."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu.core.receipts import verify_component as jax_verify  # noqa: E402
from oscillink_tpu.parallel.streaming import StreamingLattice as JaxStream  # noqa: E402
from oscillink_tpu_torch.core.receipts import verify_component as port_verify  # noqa: E402
from oscillink_tpu_torch.parallel.hierarchical import hierarchical_settle  # noqa: E402
from oscillink_tpu_torch.parallel.streaming import StreamingLattice  # noqa: E402

REL = 1e-5


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    psi /= np.linalg.norm(psi)
    return Y, psi


def _close(a, b, path):
    assert abs(a - b) <= REL * max(abs(b), 1e-6), (path, a, b)


def _rounded(rec):
    sup = rec["super"] or {}
    return ([round(r["deltaH"], 6) for r in rec["shard_receipts"]],
            round(sup.get("deltaH", 0.0), 6), [round(a, 6) for a in sup.get("align", [])])


def assert_receipt_matches(port, jax):
    for key in ("seq", "n_shards", "generation", "total_rows", "buffered"):
        assert port[key] == jax[key], key
    for key in ("deltaH_composed", "deltaH_since_last"):
        assert abs(port[key] - jax[key]) <= REL * max(abs(jax["deltaH_composed"]), 1e-6), key
    shards = list(zip(port["shard_receipts"], jax["shard_receipts"]))
    if "new_shard" in jax:
        shards.append((port["new_shard"], jax["new_shard"]))
    assert len(port["shard_receipts"]) == len(jax["shard_receipts"])
    for rp, rj in shards:
        for key in set(rj) - {"deltaH", "align", "res", "signature"}:
            assert rp[key] == rj[key], (key, rp, rj)
        _close(rp["deltaH"], rj["deltaH"], "deltaH")
        _close(rp["align"], rj["align"], "align")
    sp, sj = port["super"], jax["super"]
    assert sp["ranking"] == sj["ranking"] and sp["iters"] == sj["iters"]
    _close(sp["deltaH"], sj["deltaH"], "super.deltaH")
    np.testing.assert_allclose(sp["align"], sj["align"], rtol=REL, atol=1e-6)
    assert (port["composition_sig"] == jax["composition_sig"]) == (_rounded(port) == _rounded(jax))


class Both:
    """A port stream (on the CPU) and a JAX stream fed alike."""

    def __init__(self, psi, **kw):
        self.port = StreamingLattice(psi, device="cpu", **kw)
        self.jax = JaxStream(psi, **kw)

    def append(self, Y, gates=None):
        rp, rj = self.port.append(Y, gates=gates), self.jax.append(Y, gates=gates)
        assert len(rp) == len(rj)
        for a, b in zip(rp, rj):
            assert_receipt_matches(a, b)
        return rp

    def call(self, name, *args, **kw):
        out = getattr(self.port, name)(*args, **kw), getattr(self.jax, name)(*args, **kw)
        if name in ("flush", "delta_receipt", "receipt") and out[1] is not None:
            assert_receipt_matches(*out)
        return out[0]


def test_append_buffers_then_autoflushes():
    Y, psi = _data(70, 16)
    s = Both(psi, shard_size=32, max_shards=8, kneighbors=4)
    assert s.append(Y[:10]) == []
    r = s.append(Y[10:70])
    assert len(r) == 2 and s.port.buffered == 6 and s.port.total_rows == 70
    s.call("flush")
    np.testing.assert_allclose(s.port.shard_ustar(2), s.jax.shard_ustar(2), rtol=0, atol=1e-5)


def test_partial_flush_padding_is_inert():
    """A zero-padded partial bucket gives the receipt and settled rows of a
    bucket sized exactly to the rows (zero rows normalise to zero)."""
    Y, psi = _data(20, 12, seed=3)
    a = Both(psi, shard_size=32, max_shards=4, kneighbors=4)
    a.append(Y)
    ra = a.call("flush")
    b = StreamingLattice(psi, shard_size=20, max_shards=4, kneighbors=4, device="cpu")
    b.append(Y)
    sa, sb = ra["new_shard"], b.delta_receipt()["shard_receipts"][0]
    assert sa["rows"] == sb["rows"] == 20
    np.testing.assert_allclose(sa["deltaH"], sb["deltaH"], rtol=1e-5)
    np.testing.assert_allclose(a.port.shard_ustar(0), b.shard_ustar(0), rtol=2e-5, atol=1e-6)


def test_matches_hierarchical_composition():
    n_shards, ns, d = 4, 24, 16
    Y, psi = _data(n_shards * ns, d, seed=1)
    batch = hierarchical_settle(Y, psi, n_shards=n_shards, kneighbors=4, super_k=3, device="cpu")
    s = Both(psi, shard_size=ns, max_shards=8, kneighbors=4, super_k=3)
    s.append(Y)
    rec = s.call("delta_receipt")
    for a, b in zip(rec["shard_receipts"], batch["shard_receipts"]):
        np.testing.assert_allclose(a["deltaH"], b["deltaH"], rtol=1e-4)
    np.testing.assert_allclose(rec["super"]["deltaH"], batch["super"]["deltaH"], rtol=1e-4)
    np.testing.assert_allclose(rec["super"]["align"], batch["super"]["align"], rtol=1e-4, atol=1e-6)
    assert rec["super"]["ranking"] == batch["super"]["ranking"]


def test_delta_receipts_accumulate_and_gates_propagate():
    Y, psi = _data(96, 16, seed=2)
    s = Both(psi, shard_size=32, max_shards=8, kneighbors=4)
    receipts = s.append(Y)
    total = sum(r["deltaH_since_last"] for r in receipts)
    np.testing.assert_allclose(total, receipts[-1]["deltaH_composed"], rtol=1e-5)
    assert s.call("delta_receipt")["deltaH_since_last"] == 0.0
    Y, psi = _data(64, 16, seed=4)
    s = Both(psi, shard_size=32, max_shards=4, kneighbors=4)
    gates = np.linspace(0.2, 1.0, 64).astype(np.float32)
    s.append(Y, gates=gates)
    for a, b in zip(s.port.propagate_gates([1.0, 0.25]), s.jax.propagate_gates([1.0, 0.25])):
        np.testing.assert_array_equal(a, b)


def test_component_receipts_verify_across_packages():
    Y, psi = _data(64, 16, seed=5)
    s = Both(psi, shard_size=32, max_shards=4, kneighbors=4, receipt_secret="s3cret")
    for r in s.append(Y):
        for verify in (port_verify, jax_verify):
            assert verify(r, "s3cret") and not verify(r, "wrong")
            assert verify(r["new_shard"], "s3cret")
        bad = dict(r)
        bad["total_rows"] = 10**6
        assert not port_verify(bad, "s3cret")


def test_tiny_bucket_k_clamp_equivalence():
    Y, psi = _data(3, 12, seed=7)
    a = Both(psi, shard_size=32, max_shards=2, kneighbors=6)
    a.append(Y)
    ra = a.call("flush")
    b = StreamingLattice(psi, shard_size=3, max_shards=2, kneighbors=2, device="cpu")
    rb = b.append(Y)[0]
    np.testing.assert_allclose(ra["new_shard"]["deltaH"], rb["new_shard"]["deltaH"], rtol=1e-5)


def test_consolidation_recursion_matches_jax():
    Y, psi = _data(32 * 6, 16, seed=8)
    s = Both(psi, shard_size=32, max_shards=3, kneighbors=4, receipt_secret="k")
    s.append(Y[: 32 * 3])
    r2 = s.append(Y[32 * 3: 32 * 4])
    assert s.port.generation == 1 and s.port.n_shards == 2
    cons = r2[0]["shard_receipts"][0]
    assert cons["consolidated"] and cons["children"] == 3 and jax_verify(cons, "k")
    s.append(Y[32 * 4:])
    s.append(_data(32, 16, seed=9)[0])
    assert s.port.generation == 2 and s.port.n_shards == 3 and s.port.total_rows == 32 * 7
    s.call("receipt")


def test_bundle_spans_generations_matches_jax():
    rng = np.random.default_rng(11)
    d = 16
    psi = rng.standard_normal(d).astype(np.float32)
    psi /= np.linalg.norm(psi)
    Y = rng.standard_normal((32 * 4, d)).astype(np.float32)
    planted = [3, 40, 70, 100]
    for g in planted:
        Y[g] = 5.0 * psi + 0.01 * rng.standard_normal(d).astype(np.float32)
    s = Both(psi, shard_size=32, max_shards=3, kneighbors=4, candidate_pool=8)
    s.port.ingest(Y)
    s.jax.ingest(Y)
    for div in (False, True):
        bp, bj = s.port.bundle(k=4, diversify=div), s.jax.bundle(k=4, diversify=div)
        assert [e["id"] for e in bp] == [e["id"] for e in bj]
    assert {e["id"] for e in s.port.bundle(k=4, diversify=False)} == set(planted)
    s.call("consolidate")
    s.call("receipt")
    s.call("delta_receipt")


def test_validation_and_capacity():
    _, psi = _data(4, 8)
    sl = StreamingLattice(psi, shard_size=4, max_shards=1, kneighbors=2, auto_consolidate=False,
                          device="cpu")
    with pytest.raises(ValueError):
        sl.append(np.zeros((2, 5), dtype=np.float32))
    sl.append(np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32))
    sl.append(np.zeros((1, 8), dtype=np.float32))
    with pytest.raises(RuntimeError):
        sl.flush()
    with pytest.raises(ValueError, match="max_shards >= 2"):
        StreamingLattice(psi, shard_size=4, max_shards=1, device="cpu")
    with pytest.raises(ValueError):
        StreamingLattice(psi, shard_size=8, max_shards=16, device="cpu")
