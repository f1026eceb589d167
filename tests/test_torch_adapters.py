"""The port's adapters (`adapters/registry.py`, `adapters/lsa.py`) and
`OscillinkLattice.from_texts`: the JAX package's registry tests
(``tests/test_adapter_registry.py``) and ``from_texts`` test
(``tests/test_preprocess_adapters.py::test_from_texts_constructor``) on the
port, its LSA vectors held to the JAX package's within 1e-6, its hash
provider to the byte, and a ``from_texts`` lattice over the repo's synth3k
corpus to the JAX package's at the lattice bars."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import oscillink_tpu as ot  # noqa: E402
from oscillink_tpu.adapters import registry as jax_registry  # noqa: E402
from oscillink_tpu.adapters.lsa import LSAEmbedder as JaxLSA  # noqa: E402
from oscillink_tpu_torch import Oscillink  # noqa: E402
from oscillink_tpu_torch.adapters import registry  # noqa: E402
from oscillink_tpu_torch.adapters.lsa import LSAEmbedder  # noqa: E402
from oscillink_tpu_torch.adapters.registry import (  # noqa: E402
    CachedEmbedder,
    _ValidatedProvider,
    auto_detect,
    available_providers,
    register_provider,
    resolve_provider,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(ROOT, "benchmarks", "data", "beir", "synth3k")
LSA_TOL = 1e-6


def _synth(n_docs):
    with open(os.path.join(SYNTH, "corpus.jsonl")) as f:
        docs = [json.loads(line)["text"] for _, line in zip(range(n_docs), f)]
    with open(os.path.join(SYNTH, "queries.jsonl")) as f:
        query = json.loads(f.readline())["text"]
    return docs, query


def test_hash_provider_resolves_and_normalizes():
    p = resolve_provider("hash")
    v = p.embed(["alpha", "beta"])
    assert v.shape == (2, 384) and v.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-5)
    assert resolve_provider("hash:256").embed(["alpha"]).shape == (1, 256)
    ref = jax_registry.resolve_provider("hash").embed(["alpha", "beta"])
    assert v.tobytes() == ref.tobytes()


def test_lsa_provider_fits_then_embeds_consistently():
    p = resolve_provider("lsa:8")
    corpus = ["mars red planet moons", "paris france capital",
              "bees honey pollinate", "mars olympus mons volcano"]
    Y = p.embed(corpus)
    q = p.embed(["tell me about mars"])
    assert Y.shape[0] == 4 and q.shape == (1, Y.shape[1])
    assert int(np.argmax(Y @ q[0])) in (0, 3)
    ref = jax_registry.resolve_provider("lsa:8")
    np.testing.assert_allclose(Y, ref.embed(corpus), rtol=0, atol=LSA_TOL)
    np.testing.assert_allclose(q, ref.embed(["tell me about mars"]), rtol=0, atol=LSA_TOL)


@pytest.mark.parametrize("dim,min_df", [(64, 1), (16, 2)])
def test_lsa_vectors_match_the_jax_package(dim, min_df):
    docs, query = _synth(300)
    ours, theirs = LSAEmbedder(dim=dim, min_df=min_df), JaxLSA(dim=dim, min_df=min_df)
    Y, Yj = ours.fit(docs), theirs.fit(docs)
    assert Y.shape == Yj.shape == (300, dim) and ours.vocab == theirs.vocab
    np.testing.assert_allclose(Y, Yj, rtol=0, atol=LSA_TOL)
    np.testing.assert_allclose(ours.embed([query]), theirs.embed([query]), rtol=0, atol=LSA_TOL)
    with pytest.raises(RuntimeError, match="fit must run first"):
        LSAEmbedder().embed(["x"])


def test_unknown_provider_and_env_override(monkeypatch):
    with pytest.raises(KeyError):
        resolve_provider("no-such-backend")
    monkeypatch.setenv("OSCILLINK_EMBED_PROVIDER", "hash:16")
    assert resolve_provider(None).embed(["x"]).shape == (1, 16)


def test_auto_detect_falls_back_to_hash(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    monkeypatch.delenv("COHERE_API_KEY", raising=False)
    monkeypatch.setenv("OSCILLINK_DISABLE_ST", "1")
    from oscillink_tpu_torch.adapters.text import _load_st_model

    _load_st_model.cache_clear()
    assert auto_detect().name == "hash"
    _load_st_model.cache_clear()


def test_api_providers_fail_actionably(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    with pytest.raises(RuntimeError, match="package|OPENAI_API_KEY"):
        resolve_provider("openai")
    assert {"openai", "cohere", "anthropic", "huggingface", "hash", "st",
            "lsa"} <= set(available_providers())
    assert available_providers() == jax_registry.available_providers()


def test_validation_rejects_bad_provider_output():
    with pytest.raises(ValueError, match="shape"):
        _ValidatedProvider("bad", lambda ts: np.zeros((99, 4))).embed(["a"])
    with pytest.raises(ValueError, match="dtype"):
        _ValidatedProvider("bad", lambda ts: np.zeros((1, 4), dtype=np.int32)).embed(["a"])
    with pytest.raises(ValueError, match="finite"):
        _ValidatedProvider("bad", lambda ts: np.full((1, 4), np.nan)).embed(["a"])


def test_register_provider_plugs_in():
    calls = []

    def factory(model):
        return _ValidatedProvider(
            "toy", lambda ts: (calls.append(len(ts)), np.ones((len(ts), 4), dtype=np.float32))[1]
        )

    register_provider("toy", factory)
    try:
        v = resolve_provider("toy").embed(["a", "b"])
        assert v.shape == (2, 4) and calls == [2]
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-6)
    finally:
        registry._REGISTRY.pop("toy", None)


def test_cache_hits_ttl_and_partial_batches():
    calls = []
    prov = _ValidatedProvider(
        "count", lambda ts: (calls.append(list(ts)),
                             np.asarray([[hash(t) % 7 + 1.0, 1.0] for t in ts],
                                        dtype=np.float32))[1]
    )
    t = {"now": 0.0}
    ce = CachedEmbedder(prov, ttl_s=10.0, max_items=3, clock=lambda: t["now"])
    v1 = ce.embed(["a", "b"])
    assert calls == [["a", "b"]] and ce.misses == 2 and ce.hits == 0
    v2 = ce.embed(["b", "a"])
    assert calls == [["a", "b"]] and ce.hits == 2
    np.testing.assert_array_equal(v2[0], v1[1])
    np.testing.assert_array_equal(v2[1], v1[0])
    ce.embed(["a", "c"])
    assert calls[-1] == ["c"]
    t["now"] = 11.0
    ce.embed(["a"])
    assert calls[-1] == ["a"]
    ce.embed(["d", "e", "f", "g"])
    assert len(ce._store) <= 3


def test_cache_key_includes_provider_name_and_model():
    p1 = _ValidatedProvider("p1", lambda ts: np.ones((len(ts), 2), dtype=np.float32))
    p2 = _ValidatedProvider("p2", lambda ts: 2 * np.ones((len(ts), 2), dtype=np.float32))
    assert CachedEmbedder(p1)._key("x") != CachedEmbedder(p2)._key("x")
    c1 = CachedEmbedder(resolve_provider("hash:256"))
    c2 = CachedEmbedder(resolve_provider("hash:384"))
    assert c1._key("x") != c2._key("x")
    assert c1.embed(["x"]).shape == (1, 256) and c2.embed(["x"]).shape == (1, 384)
    # the same key scheme as the JAX package's, so a shared cache store is
    # addressed alike
    assert c1._key("x") == jax_registry.CachedEmbedder(jax_registry.resolve_provider(
        "hash:256"))._key("x")


def test_from_texts_constructor(monkeypatch):
    monkeypatch.setenv("OSCILLINK_DISABLE_ST", "1")
    texts = ["alpha beta", "beta gamma", "gamma delta", "delta epsilon"]
    lat = Oscillink.from_texts(texts, query="beta", kneighbors=2, embed_dim=32, device="cpu")
    assert (lat.N, lat.D) == (4, 32)
    assert np.linalg.norm(lat.psi) > 0
    lat.settle()
    assert len(lat.bundle(k=2)) == 2
    lat2 = Oscillink.from_texts(texts, kneighbors=2, embed_dim=32, device="cpu")
    assert np.allclose(lat2.psi, 0)


def _flow(lat):
    lat.settle(max_iters=12, tol=1e-3)
    rec = lat.receipt()
    return rec, [e["id"] for e in lat.bundle(k=8)], lat.last["iters"]


@pytest.mark.parametrize("provider", ["hash", "lsa"])
def test_text_lattice_over_synth3k_matches_jax(provider, monkeypatch):
    """The chip phase ``texts`` at a tenth of its corpus: the hash path
    through ``from_texts``, the LSA path through the registry."""
    monkeypatch.setenv("OSCILLINK_DISABLE_ST", "1")
    docs, query = _synth(300)
    if provider == "hash":
        lat = Oscillink.from_texts(docs, query=query, kneighbors=8, device="cpu")
        ref = ot.OscillinkLattice.from_texts(docs, query=query, kneighbors=8)
        assert lat.Y.tobytes() == ref.Y.tobytes() and lat.psi.tobytes() == ref.psi.tobytes()
    else:
        p = resolve_provider("lsa:64")
        Y, psi = p.embed(docs), p.embed([query])[0]
        lat = Oscillink(Y, kneighbors=8, device="cpu")
        lat.set_query(psi)
        ref = ot.OscillinkLattice(Y, kneighbors=8)
        ref.set_query(psi)
    (rec, bundle, iters), (rj, bj, ij) = _flow(lat), _flow(ref)
    assert rec["meta"]["state_sig"] == rj["meta"]["state_sig"]
    assert iters == ij and bundle == bj
    assert len(rec["null_points"]) == len(rj["null_points"])
    assert abs(rec["deltaH_total"] - rj["deltaH_total"]) <= 1e-5 * abs(rj["deltaH_total"])
