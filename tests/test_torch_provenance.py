"""The port's ``compare_perf``, ``compare_provenance``,
``adjacency_fingerprint`` and ``dense_adjacency`` against the JAX
package's, and the two packages' top-level names."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402


def test_top_level_names_match_the_jax_package():
    assert set(pt.__all__) == set(ot.__all__)
    for name in pt.__all__:
        assert hasattr(pt, name), name
    from oscillink_tpu_torch import preprocess

    assert preprocess.compute_diffusion_gates is pt.compute_diffusion_gates


def _report(**means):
    return {"aggregates": {k: {"mean": v} for k, v in means.items()}}


@pytest.mark.parametrize("base,cur,kw", [
    (_report(build_ms=10.0, settle_ms=5.0, receipt_ms=2.0),
     _report(build_ms=13.0, settle_ms=5.5, receipt_ms=1.0), {}),
    (_report(build_ms=0.0, settle_ms=5.0, receipt_ms=2.0),
     _report(build_ms=3.0, settle_ms=9.0, receipt_ms=2.0), dict(tolerance_pct=50.0)),
    (_report(ustar_ms=4.0, settle_ms=-1.0), _report(ustar_ms=4.4, settle_ms=1.0),
     dict(metrics=["ustar_ms", "settle_ms"], tolerance_pct=5.0)),
])
def test_compare_perf_matches_jax(base, cur, kw):
    assert pt.compare_perf(base, cur, **kw) == ot.compare_perf(base, cur, **kw)


def _lattice(pkg, Y, psi=None, chain=None, **kw):
    kw = dict(kw)
    if pkg is pt:
        kw["device"] = "cpu"
    lat = pkg.Oscillink(Y, kneighbors=6, **kw)
    if psi is not None:
        lat.set_query(psi)
    if chain is not None:
        lat.add_chain(chain)
    return lat


@pytest.mark.parametrize("change", ["none", "psi", "chain", "params", "shape", "gates"])
def test_compare_provenance_matches_jax(change):
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((120, 64)).astype(np.float32)
    psi = Y[:10].mean(0)
    other = {
        "none": dict(Y=Y, psi=psi),
        "psi": dict(Y=Y, psi=-psi),
        "chain": dict(Y=Y, psi=psi, chain=[1, 2, 3]),
        "params": dict(Y=Y, psi=psi, lamC=0.9),
        "shape": dict(Y=Y[:100], psi=psi),
        "gates": dict(Y=Y, psi=psi),
    }[change]
    out = {}
    for pkg in (ot, pt):
        a = _lattice(pkg, Y, psi)
        b = _lattice(pkg, **other)
        if change == "gates":
            b.set_gates(np.linspace(0, 1, 120).astype(np.float32))
        out[pkg.__name__] = pkg.compare_provenance(a, b)
    assert out["oscillink_tpu_torch"] == out["oscillink_tpu"]
    assert out["oscillink_tpu"]["same"] == (change == "none")


@pytest.mark.parametrize("n,d,seed", [(120, 128, 0), (300, 16, 1), (2500, 8, 2)])
def test_adjacency_fingerprint_and_dense_adjacency_match_jax(n, d, seed):
    Y = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    lj, lt = ot.Oscillink(Y, kneighbors=6), pt.Oscillink(Y, kneighbors=6, device="cpu")
    np.testing.assert_array_equal(lt.graph.idx.numpy(), np.asarray(lj._graph.idx))
    assert lt.adjacency_fingerprint() == lj.adjacency_fingerprint()
    A = lt.dense_adjacency()
    assert A.shape == (n, n) and A.dtype == np.float32
    np.testing.assert_allclose(A, lj.dense_adjacency(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(A != 0, A.T != 0)


def test_fingerprint_on_a_carried_graph_equals_the_jax_lattices():
    """On the same graph — the JAX graph carried across — the fingerprints
    are equal whatever the build."""
    from oscillink_tpu_torch import interop

    Y = np.random.default_rng(3).standard_normal((400, 12)).astype(np.float32)
    lj = ot.Oscillink(Y, kneighbors=5)
    g = lj._graph
    graph = interop.graph_from_numpy(g.idx, g.w, g.wn, g.sqrt_deg, device="cpu")
    lt = pt.Oscillink(Y, kneighbors=5, device="cpu", graph=graph)
    assert lt.adjacency_fingerprint() == lj.adjacency_fingerprint()
