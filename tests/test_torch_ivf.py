"""The IVF cluster build: oscillink_tpu_torch.ops.ivf against oscillink_tpu.ops.ivf.

Both packages get the same numpy inputs (made from a seed) on the CPU, on the
corpora and geometries of ``tests/test_ivf_build.py``.  Bars:

* ``ivf_topk``: the same overflow count and filled rows; vals within 1e-6;
  ids identical except slots whose two neighbours are tied within f32
  rounding (the f64 gap within 8 gamma_(D+2), `_near_tie_gap_ok`), on at
  most 1 % of rows.  The two packages' f32 similarity matmuls add in another
  order, and these tight corpora put many neighbours within an ulp.
* ``_rank_in_cluster``: identical.  ``_sample_quality``: within 1e-6.
* ``_clusterability``: ``obs`` within 1e-5; the null within 1e-2 relative
  (the port draws the column shuffle from a torch generator, not JAX's
  threefry stream); the accept-or-fall-back decision identical.
* ``build_graph_ivf``: the same mode, info keys and reason template.
* The lattice in cluster mode: deltaH within 1e-5 relative, identical
  bundle ids and ``state_sig``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.ops import ivf as jivf  # noqa: E402
from oscillink_tpu_torch.ops import ivf as tivf  # noqa: E402

NULL_REL = 1e-2
# the JAX package's balance defaults and no spill patch: the port's
# defaults differ (ops/ivf.py), so its side of each comparison passes these
JAX_BALANCE = dict(balance_rounds=3, balance_cands=4, spill_patch=False)


def _clustered(n_clusters=32, per=256, d=64, seed=0, spread=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 5
    return np.concatenate(
        [c + spread * rng.standard_normal((per, d)).astype(np.float32) for c in centers]
    )


def _skewed():
    # tests/test_ivf_build.py::test_balanced_assignment_bounds_overflow
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((8, 32)).astype(np.float32) * 5
    parts = [centers[0] + 0.5 * rng.standard_normal((1024, 32)).astype(np.float32)]
    for c in centers[1:]:
        parts.append(c + 0.5 * rng.standard_normal((128, 32)).astype(np.float32))
    return np.concatenate(parts)


def _near_tie_gap_ok(Y, idx_a, idx_b):
    """Rows that differ, and whether every differing slot's two neighbours
    lie within the f32 rounding bound of each other in f64."""
    rows, slots = np.nonzero(idx_a != idx_b)
    if rows.size == 0:
        return 0, True
    d = Y.shape[1]
    nu = (d + 2) * 2.0**-24
    Yn = Y.astype(np.float64)
    Yn /= np.linalg.norm(Yn, axis=1, keepdims=True) + 1e-12
    s_a = np.einsum("ij,ij->i", Yn[rows], Yn[idx_a[rows, slots]])
    s_b = np.einsum("ij,ij->i", Yn[rows], Yn[idx_b[rows, slots]])
    return np.unique(rows).size, bool((np.abs(s_a - s_b) <= 8 * nu / (1 - nu)).all())


IVF_CASES = {
    "clustered": (lambda: _clustered(), 8, dict(n_clusters=32, bucket_cap=384, m_probe=4)),
    "wide_spread": (lambda: _clustered(spread=2.0), 8,
                    dict(n_clusters=32, bucket_cap=384, m_probe=4)),
    "patched": (lambda: _clustered(n_clusters=8, per=256, d=32, seed=7), 6,
                dict(n_clusters=8, bucket_cap=128, m_probe=4, patch_cap=2048)),
    "patch_cap_binds": (lambda: _clustered(n_clusters=8, per=256, d=32, seed=7), 6,
                        dict(n_clusters=8, bucket_cap=128, m_probe=4, patch_cap=100)),
    "unbalanced": (_skewed, 6, dict(n_clusters=8, bucket_cap=256, m_probe=4, balance_rounds=0)),
    "balanced": (_skewed, 6, dict(n_clusters=8, bucket_cap=256, m_probe=4, balance_rounds=3)),
    "few_clusters": (lambda: _clustered(n_clusters=4, per=64, d=16, seed=41), 4,
                     dict(n_clusters=3, bucket_cap=128, m_probe=2, balance_cands=4)),
    "one_cluster": (lambda: _clustered(n_clusters=4, per=64, d=16, seed=41), 4,
                    dict(n_clusters=1, bucket_cap=256, m_probe=1, balance_cands=4)),
}


@pytest.mark.parametrize("case", sorted(IVF_CASES))
def test_ivf_topk_matches_jax(case):
    make, k, kw = IVF_CASES[case]
    Y = make()
    vj, ij, oj, fj = jivf.ivf_topk(jnp.asarray(Y), k, **kw)
    vt, it, ot_, ft = tivf.ivf_topk(torch.from_numpy(Y), k, **{**JAX_BALANCE, **kw})
    assert it.dtype == torch.int32 and it.shape == (Y.shape[0], k)
    assert ot_ == int(oj)  # overflow
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))  # filled
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-6)  # vals 1e-6
    rows, ties_only = _near_tie_gap_ok(Y, it.numpy(), np.asarray(ij))
    assert ties_only  # ids identical except near-tie slots
    assert rows <= 0.01 * Y.shape[0]
    if case == "patched":
        assert ot_ > 0 and bool(ft.all())  # every overflow row was patched
    if case == "patch_cap_binds":
        assert int((~ft).sum()) == ot_ - 100  # rows past the cap stay unfilled
    if case == "balanced":
        unbalanced = {**JAX_BALANCE, **kw, "balance_rounds": 0}
        assert ot_ <= tivf.ivf_topk(torch.from_numpy(Y), k, **unbalanced)[2] // 4


def test_ivf_topk_rejects_a_pool_smaller_than_k():
    Y = torch.from_numpy(_clustered(n_clusters=4, per=16, d=8, seed=1))
    with pytest.raises(ValueError, match="must be >= k"):
        tivf.ivf_topk(Y, 8, n_clusters=2, bucket_cap=2, m_probe=1)


@pytest.mark.parametrize("levels", [4, 50, 100000])
def test_rank_in_cluster_matches_jax(levels):
    # quantized similarities force ties: the stable argsorts must agree
    rng = np.random.default_rng(levels)
    n, C = 3000, 17
    cur = rng.integers(0, C, size=n).astype(np.int32)
    sim = (rng.integers(0, levels, size=n) / levels).astype(np.float32)
    oj, aj, pj = jivf._rank_in_cluster(jnp.asarray(cur), jnp.asarray(sim), C, n)
    ot_, at, ptt = tivf._rank_in_cluster(
        torch.from_numpy(cur).long(), torch.from_numpy(sim), C, n)
    np.testing.assert_array_equal(ot_.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(ptt.numpy(), np.asarray(pj))


def test_lloyd_update_matches_jax():
    # an empty cluster keeps its previous centroid
    rng = np.random.default_rng(2)
    Ys = rng.standard_normal((500, 24)).astype(np.float32)
    Ys /= np.linalg.norm(Ys, axis=1, keepdims=True)
    cent = Ys[:6].copy()
    A = Ys @ cent.T
    A[:, 5] = -2.0  # nobody picks centroid 5
    cj = jivf._lloyd_update(jnp.asarray(A), jnp.asarray(Ys), jnp.asarray(cent), 6, 24)
    ct = tivf._lloyd_update(torch.from_numpy(A), torch.from_numpy(Ys), torch.from_numpy(cent), 6, 24)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["wide_spread", "patch_cap_binds", "unbalanced"])
def test_sample_quality_matches_jax(case):
    # corpora whose exact top-k has no near-tie within f32 rounding: on the
    # tight default corpus the two packages' exact scans may swap such a
    # pair, and one swapped id moves the recall by 1/2048
    make, k, kw = IVF_CASES[case]
    Y = make()
    vj, ij, _, _ = jivf.ivf_topk(jnp.asarray(Y), k, **kw)
    rj, gj = (float(v) for v in jivf._sample_quality(jnp.asarray(Y), vj, ij, k))
    rt, gt = tivf._sample_quality(
        torch.from_numpy(Y), torch.from_numpy(np.array(vj)), torch.from_numpy(np.array(ij)), k)
    assert abs(float(rt) - rj) <= 1e-6
    assert abs(float(gt) - gj) <= 1e-6


@pytest.mark.parametrize(
    "name,kw",
    [
        ("iso64", dict(n_clusters=64, sample=4096)),
        ("iso128", dict(n_clusters=64, sample=4096)),
        ("clustered64", dict(n_clusters=64, sample=4096)),
        ("clustered128", dict(n_clusters=64, sample=4096)),
        ("iso_default", dict()),
        ("clustered_default", dict()),
    ],
)
def test_clusterability_matches_jax(name, kw):
    rng = np.random.default_rng(21)
    d = 128 if "128" in name else 64
    if name.startswith("iso"):
        Y = rng.standard_normal((8192, d)).astype(np.float32)
    else:
        Y = _clustered(n_clusters=16, per=512, d=d, seed=22)
    oj, nj = (float(v) for v in jivf._clusterability(jnp.asarray(Y), **kw))
    ot_, nt = (float(v) for v in tivf._clusterability(torch.from_numpy(Y), **kw))
    assert abs(ot_ - oj) <= 1e-5  # obs: a strided sample and init, deterministic
    assert abs(nt - nj) <= NULL_REL * nj  # null: another shuffle of the columns
    assert (ot_ / nt < 1.25) == (oj / nj < 1.25) == name.startswith("iso")  # the decision


def _template(reason):
    return re.sub(r"-?\d+(\.\d+)?", "#", reason)


FALLBACKS = {
    # tests/test_ivf_build.py's fallbacks: the isotropic pre-gate, the
    # recall gate with the pre-gate off, overflow, small N
    "pregate": (lambda: np.random.default_rng(1).standard_normal((8192, 64)).astype(np.float32),
                dict(n_clusters=32, m_probe=4, min_n=1000), "clusterability"),
    "recall_gate": (lambda: np.random.default_rng(1).standard_normal((8192, 64)).astype(np.float32),
                    dict(n_clusters=32, m_probe=4, min_n=1000, min_clusterability=0.0), "recall"),
    "overflow": (lambda: _clustered(seed=2),
                 dict(n_clusters=32, m_probe=4, bucket_factor=0.5, min_n=1000), "overflow"),
    "small_n": (lambda: np.random.default_rng(3).standard_normal((256, 16)).astype(np.float32),
                dict(), "N below"),
    "small_n_exact": (lambda: np.random.default_rng(51).standard_normal((512, 32)).astype(np.float32),
                      dict(), "N below"),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_build_graph_ivf_fallbacks_match_jax(case):
    make, kw, word = FALLBACKS[case]
    Y = make()
    k = 6 if case == "small_n_exact" else 8
    gj, ij = jivf.build_graph_ivf(jnp.asarray(Y), k, **kw)
    gt, it = tivf.build_graph_ivf(torch.from_numpy(Y), k, **JAX_BALANCE, **kw)
    assert it["mode"] == ij["mode"] == "fallback-exact"
    assert set(it) == set(ij)
    assert word in it["reason"]
    assert _template(it["reason"]) == _template(ij["reason"])
    for key in ("recall_estimate", "sim_gap_p99", "clusterability"):
        if key in ij:
            assert abs(it[key] - ij[key]) <= 1e-5, key
    if case != "overflow":  # Gaussian corpora: the fallback graphs agree
        np.testing.assert_array_equal(gt.idx.numpy(), np.asarray(gj.idx))
        np.testing.assert_allclose(gt.w.numpy(), np.asarray(gj.w), rtol=0, atol=1e-6)


def test_fallback_builder_is_called_with_the_resolved_mode():
    Y = torch.from_numpy(np.random.default_rng(3).standard_normal((256, 16)).astype(np.float32))
    seen = []

    def builder(mode):
        seen.append(mode)
        return tivf.build_graph(Y, 4, similarity=mode)

    _, info = tivf.build_graph_ivf(Y, 4, fallback_builder=builder)
    assert seen == ["exact"] and info["mode"] == "fallback-exact"


def test_build_graph_ivf_accepts_and_matches_jax():
    Y = _clustered()
    kw = dict(n_clusters=32, m_probe=4, min_n=1000)
    gj, ij = jivf.build_graph_ivf(jnp.asarray(Y), 8, **kw)
    gt, it = tivf.build_graph_ivf(torch.from_numpy(Y), 8, **JAX_BALANCE, **kw)
    assert it["mode"] == ij["mode"] == "ivf"
    assert list(it) == list(ij)
    for key, val in ij.items():
        if key in ("clusterability_null", "clusterability_ratio"):
            assert abs(it[key] - val) <= NULL_REL * val, key
        elif isinstance(val, float):
            assert abs(it[key] - val) <= 1e-5, key
        else:
            assert it[key] == val, key
    rows, ties_only = _near_tie_gap_ok(Y, gt.idx.numpy(), np.asarray(gj.idx))
    assert ties_only and rows <= 0.01 * Y.shape[0]


def _small_geometry(monkeypatch, mod):
    orig = mod.build_graph_ivf

    def small(Yd, k, **kw):
        kw.update(n_clusters=8, m_probe=4, min_n=256)
        return orig(Yd, k, **kw)

    monkeypatch.setattr(mod, "build_graph_ivf", small)


@pytest.mark.parametrize("similarity,spread", [("cluster", 1.0), ("auto", 2.0), ("cluster", 0.5)])
def test_lattice_cluster_mode_matches_jax(monkeypatch, similarity, spread):
    """The lattice's cluster route in both packages, with the IVF geometry
    shrunk on each module (the lattice looks build_graph_ivf up at call
    time), as tests/test_ivf_build.py::test_lattice_cluster_mode does."""
    monkeypatch.setenv("OSCILLINK_CLUSTER_SIM_N", "256")
    _small_geometry(monkeypatch, jivf)
    _small_geometry(monkeypatch, tivf)
    Y = _clustered(n_clusters=8, per=64, d=32, seed=4, spread=spread)
    psi = (Y[:16].mean(0) / np.linalg.norm(Y[:16].mean(0))).astype(np.float32)
    lj = ot.Oscillink(Y, kneighbors=6, similarity=similarity)
    lt = pt.Oscillink(Y, kneighbors=6, similarity=similarity, device="cpu")
    for lat in (lj, lt):
        lat.set_query(psi)
        lat.settle(max_iters=10, tol=1e-3)
    rj, rt = lj.receipt(), lt.receipt()
    assert rt["meta"]["similarity"] == rj["meta"]["similarity"] == "cluster"
    assert rt["meta"]["similarity_recall_target"] == 0.9
    info_t, info_j = rt["meta"]["similarity_info"], rj["meta"]["similarity_info"]
    assert info_t["mode"] == info_j["mode"] == "ivf"
    assert info_t["recall_estimate"] == pytest.approx(info_j["recall_estimate"], abs=1e-5)
    assert abs(rt["deltaH_total"] - rj["deltaH_total"]) <= 1e-5 * abs(rj["deltaH_total"])
    assert rt["meta"]["state_sig"] == rj["meta"]["state_sig"]
    assert [b["id"] for b in lt.bundle(k=6)] == [b["id"] for b in lj.bundle(k=6)]


def test_lattice_cluster_fallback_lands_in_meta(monkeypatch):
    # isotropic rows: the pre-gate falls back, and the receipt says so
    _small_geometry(monkeypatch, tivf)
    Y = np.random.default_rng(9).standard_normal((512, 32)).astype(np.float32)
    lt = pt.Oscillink(Y, kneighbors=6, similarity="cluster", device="cpu")
    lt.set_query(np.zeros(32, dtype=np.float32))
    info = lt.receipt()["meta"]["similarity_info"]
    assert info["mode"] == "fallback-exact" and "clusterability" in info["reason"]
    ge = pt.Oscillink(Y, kneighbors=6, device="cpu").graph
    assert torch.equal(lt.graph.idx, ge.idx) and torch.equal(lt.graph.w, ge.w)
