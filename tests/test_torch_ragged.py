"""The port's ragged bundles (``models/ragged.py``) against the JAX
package's ``bundle_ragged``: same ids, iterations and sizes, scores and
alignments within 1e-4 relative, and the padded build's isolation of its
zero rows.  Each corpus's graph is built inside both packages, so the
corpora used here are first checked to give the same graph in both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.models.ragged import bundle_ragged as jragged  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jbuild_graph  # noqa: E402
from oscillink_tpu_torch.models import ragged as tr  # noqa: E402
from oscillink_tpu_torch.ops.graph import build_graph as tbuild_graph  # noqa: E402


def _corpus(n, d, seed):
    """tests/test_ragged.py's generator: 4 centres, noise 0.4."""
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.standard_normal((4, d)).astype(np.float32)
    Y = (centers[rng.integers(0, 4, size=n)] + 0.4 * rng.standard_normal((n, d))).astype(np.float32)
    return Y, rng.standard_normal(d).astype(np.float32)


def _padded_builds_agree(corpora, k):
    n_pad = -(-max(len(c) for c in corpora) // tr._BUCKET) * tr._BUCKET
    for c in corpora:
        k_eff = min(k, max(1, len(c) - 1))
        Yp = np.zeros((n_pad, c.shape[1]), np.float32)
        Yp[: len(c)] = c
        gj = jax.jit(lambda Y: jbuild_graph(Y, k_eff))(jnp.asarray(Yp))
        gt = tbuild_graph(torch.from_numpy(Yp), k_eff)
        live = np.asarray(gj.w) > 0
        np.testing.assert_array_equal(gt.w.numpy() > 0, live)
        np.testing.assert_array_equal(gt.idx.numpy()[live], np.asarray(gj.idx)[live])


def _assert_match(rt, rj):
    assert len(rt) == len(rj)
    for a, b in zip(rt, rj):
        assert (a["n"], a["iters"]) == (b["n"], b["iters"])
        assert a["res"] == pytest.approx(b["res"], rel=1e-3, abs=1e-6)
        assert [e["id"] for e in a["bundle"]] == [e["id"] for e in b["bundle"]]
        for ea, eb in zip(a["bundle"], b["bundle"]):
            assert ea["score"] == pytest.approx(eb["score"], rel=1e-4, abs=1e-6)
            assert ea["align"] == pytest.approx(eb["align"], rel=1e-4, abs=1e-6)


@pytest.mark.parametrize("sizes,d,k,bundle_k,gated", [
    ((50, 130, 97), 24, 6, 5, False),
    ((70, 64, 129, 33), 16, 5, 6, True),
    ((200,), 32, 6, 8, False),
])
def test_bundle_ragged_matches_jax(sizes, d, k, bundle_k, gated):
    data = [_corpus(n, d, seed=i + d) for i, n in enumerate(sizes)]
    corpora, psis = [Y for Y, _ in data], [p for _, p in data]
    _padded_builds_agree(corpora, k)
    rng = np.random.default_rng(5)
    gates = [rng.random(n).astype(np.float32) if i % 2 else None
             for i, n in enumerate(sizes)] if gated else None
    kw = dict(kneighbors=k, bundle_k=bundle_k)
    _assert_match(tr.bundle_ragged(corpora, psis, gates, device="cpu", **kw),
                  jragged(corpora, psis, gates, **kw))


def test_tiny_corpus_k_group_matches_jax_and_standalone():
    """tests/test_ragged.py:85's case: a corpus smaller than k clamps only
    its own graph (its own k-group); the larger lane keeps k = 6 and matches
    a lattice serving it alone."""
    tiny, big = _corpus(4, 16, seed=30), _corpus(80, 16, seed=31)
    corpora, psis = [tiny[0], big[0]], [tiny[1], big[1]]
    _padded_builds_agree(corpora, 6)
    rt = tr.bundle_ragged(corpora, psis, kneighbors=6, bundle_k=5, device="cpu")
    _assert_match(rt, jragged(corpora, psis, kneighbors=6, bundle_k=5))
    lat = pt.Oscillink(big[0], kneighbors=6, device="cpu")
    lat.set_query(big[1])
    lat.settle(max_iters=12, tol=1e-3)
    assert [e["id"] for e in rt[1]["bundle"]] == [e["id"] for e in lat.bundle(k=5)]
    assert rt[1]["iters"] == lat.last["iters"]
    lat.solve_Ustar(tol=1e-3, max_iters=12, use_cache=False)
    assert rt[1]["ustar_iters"] == lat.last_ustar["iters"]
    assert len(rt[0]["bundle"]) == 4


def test_bundle_k_past_the_smallest_corpus():
    data = [_corpus(n, 8, seed=10 + i) for i, n in enumerate((9, 40))]
    corpora, psis = [Y for Y, _ in data], [p for _, p in data]
    rt = tr.bundle_ragged(corpora, psis, kneighbors=4, bundle_k=12, device="cpu")
    _assert_match(rt, jragged(corpora, psis, kneighbors=4, bundle_k=12))
    assert len(rt[0]["bundle"]) == 9 and max(e["id"] for e in rt[0]["bundle"]) < 9
    assert len(rt[1]["bundle"]) == 12


def test_padded_rows_are_isolated_with_zero_weight():
    Y, _ = _corpus(100, 16, seed=3)
    Yp = np.zeros((128, 16), np.float32)
    Yp[:100] = Y
    gp, g = tbuild_graph(torch.from_numpy(Yp), 6), tbuild_graph(torch.from_numpy(Y), 6)
    assert torch.all(gp.w[100:] == 0.0) and torch.all(gp.wn[100:] == 0.0)
    assert not torch.any((gp.w[:100] > 0) & (gp.idx[:100] >= 100))
    live = g.w > 0
    assert torch.equal(gp.w[:100] > 0, live)
    assert torch.equal(gp.idx[:100][live], g.idx[live])
    assert torch.equal(gp.w[:100], g.w) and torch.equal(gp.wn[:100], g.wn)


def test_empty_and_invalid_inputs():
    assert tr.bundle_ragged([], [], device="cpu") == []
    a, b = _corpus(20, 8, 0), _corpus(30, 6, 1)
    with pytest.raises(ValueError, match="psis"):
        tr.bundle_ragged([a[0]], [a[1], a[1]], device="cpu")
    with pytest.raises(ValueError, match="share D"):
        tr.bundle_ragged([a[0], b[0]], [a[1], b[1]], device="cpu")
