"""The port's `parallel.hierarchical` against the JAX package's on the
cases of ``tests/test_hierarchical.py``: per-shard ΔH and alignment within
1e-5 relative, identical iterations, the same super-level ranking, and the
composition signature equal exactly when every value it rounds (to 6
decimals) rounds alike in both packages (the diffusion-gate ``state_sig``
rule of ROADMAP queue C).  Signed component receipts verify across the
packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu.core.receipts import verify_component as jax_verify  # noqa: E402
from oscillink_tpu.parallel.hierarchical import hierarchical_settle as jax_settle  # noqa: E402
from oscillink_tpu_torch.core.receipts import verify_component as port_verify  # noqa: E402
from oscillink_tpu_torch.parallel.hierarchical import hierarchical_settle  # noqa: E402

REL = 1e-5


def _rounded(out):
    return ([round(r["deltaH"], 6) for r in out["shard_receipts"]],
            round(out["super"]["deltaH"], 6), [round(a, 6) for a in out["super"]["align"]])


def assert_matches_jax(port, jax):
    assert port["n_shards"] == jax["n_shards"]
    for rp, rj in zip(port["shard_receipts"], jax["shard_receipts"]):
        assert rp["shard"] == rj["shard"] and rp["iters"] == rj["iters"]
        for key in ("deltaH", "align"):
            assert abs(rp[key] - rj[key]) <= REL * max(abs(rj[key]), 1e-6), (key, rp, rj)
    sp, sj = port["super"], jax["super"]
    assert sp["ranking"] == sj["ranking"] and sp["iters"] == sj["iters"]
    assert abs(sp["deltaH"] - sj["deltaH"]) <= REL * max(abs(sj["deltaH"]), 1e-6)
    np.testing.assert_allclose(sp["align"], sj["align"], rtol=REL, atol=1e-6)
    assert abs(port["deltaH_composed"] - jax["deltaH_composed"]) <= REL * abs(jax["deltaH_composed"])
    assert (port["composition_sig"] == jax["composition_sig"]) == (_rounded(port) == _rounded(jax))
    np.testing.assert_allclose(port["Ustar_shards"].numpy(), np.asarray(jax["Ustar_shards"]),
                               rtol=0, atol=REL * float(np.abs(jax["Ustar_shards"]).max()))


def _topic(seed=0, n=128, d=16):
    rng = np.random.default_rng(seed)
    topic = rng.standard_normal(d).astype(np.float32)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    Y[:16] += 2.0 * topic
    return Y, topic / np.linalg.norm(topic)


def test_hierarchical_composition_matches_jax():
    Y, psi = _topic()
    kw = dict(n_shards=8, kneighbors=4, tol=1e-5)
    port, jax = hierarchical_settle(Y, psi, device="cpu", **kw), jax_settle(Y, psi, **kw)
    assert_matches_jax(port, jax)
    assert port["super"]["ranking"][0] == 0  # the on-topic shard ranks first


@pytest.mark.parametrize("seed,n,d,shards,k,gates", [
    (1, 64, 12, 4, 3, False),
    (3, 32, 8, 4, 3, True),
    (4, 256, 24, 8, 6, True),
])
def test_hierarchical_cases_match_jax(seed, n, d, shards, k, gates):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    g = rng.uniform(0, 1, n).astype(np.float32) if gates else None
    kw = dict(n_shards=shards, kneighbors=k)
    port = hierarchical_settle(Y, psi, g, device="cpu", **kw)
    assert_matches_jax(port, jax_settle(Y, psi, g, **kw))
    again = hierarchical_settle(Y.copy(), psi.copy(), g, device="cpu", **kw)
    assert again["composition_sig"] == port["composition_sig"]  # deterministic


def test_signed_receipts_verify_across_packages():
    Y, psi = _topic(seed=5, n=64)
    port = hierarchical_settle(Y, psi, n_shards=2, kneighbors=4, receipt_secret="s3cret",
                               device="cpu")
    jax = jax_settle(Y, psi, n_shards=2, kneighbors=4, receipt_secret="s3cret")
    for out in (port, jax):
        for verify in (port_verify, jax_verify):
            assert verify(out, "s3cret") and not verify(out, "wrong")
            for r in out["shard_receipts"]:
                assert verify(r, "s3cret")
    forged = dict(port)
    forged["super"] = {**port["super"], "ranking": port["super"]["ranking"][::-1]}
    assert not port_verify(forged, "s3cret") and not jax_verify(forged, "s3cret")


def test_indivisible_raises():
    Y = np.random.default_rng(2).standard_normal((30, 8)).astype(np.float32)
    with pytest.raises(ValueError):
        hierarchical_settle(Y, Y[0], n_shards=7, device="cpu")
