"""The lattice's seeded build, rebuild, export/import and graph snapshots:
oscillink_tpu_torch against oscillink_tpu.

Both packages get the same numpy inputs (made from a seed) on the CPU.  Bars:

* the seeded host build (NumPy in both): dense (N <= 4096) identical idx,
  w and ``state_sig``; row-blocked (N = 4200) identical idx and
  ``state_sig``, and w within 1e-7, since its last step (`graph_from_topk`)
  runs in each package's own tensor library;
* export/import: a state saved by either package (JSON or NPZ, dense ``A``
  or ``A_sparse``) loads in the other with the same ``state_sig``, the same
  ``provenance`` and deltaH within 1e-5 relative;
* ``rebuild_graph``: for each argument, the same ``state_sig`` and graph as
  the JAX lattice rebuilt alike;
* ``_graph_snapshot`` / ``_install_graph_snapshot``: an installed snapshot
  serves the same receipt as the lattice it came from, and a snapshot of
  another shape or k is refused.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402


def _inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    m = Y[:20].mean(0)
    return Y, (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _graph_np(lat):
    g = lat._graph if isinstance(lat, ot.OscillinkLattice) else lat.graph
    return tuple(np.asarray(t) if not isinstance(t, torch.Tensor) else t.numpy()
                 for t in (g.idx, g.w, g.wn, g.sqrt_deg))


@pytest.mark.parametrize("n,d,seed", [(300, 32, 3), (4096, 8, 7)])
def test_seeded_dense_build_matches_jax(n, d, seed):
    Y, psi = _inputs(n, d)
    lj = ot.Oscillink(Y, kneighbors=6, neighbor_seed=seed)
    lt = pt.Oscillink(Y, kneighbors=6, neighbor_seed=seed, device="cpu")
    for a, b in zip(_graph_np(lt), _graph_np(lj)):
        np.testing.assert_array_equal(a, b)  # idx, w, wn, sqrt_deg identical
    for lat in (lj, lt):
        lat.set_query(psi)
    assert lt.receipt()["meta"]["state_sig"] == lj.receipt()["meta"]["state_sig"]


def test_seeded_blocked_build_matches_jax():
    Y, psi = _inputs(4200, 16, seed=1)
    lj = ot.Oscillink(Y, kneighbors=6, neighbor_seed=3)
    lt = pt.Oscillink(Y, kneighbors=6, neighbor_seed=3, device="cpu")
    (it, wt, _, _), (ij, wj, _, _) = _graph_np(lt), _graph_np(lj)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-7)
    for lat in (lj, lt):
        lat.set_query(psi)
        lat.settle(max_iters=8, tol=1e-3)
    rj, rt = lj.receipt(), lt.receipt()
    assert rt["meta"]["state_sig"] == rj["meta"]["state_sig"]
    assert _rel(rt["deltaH_total"], rj["deltaH_total"]) <= 1e-5
    # the seeded token is the adjacency's own, not the unseeded input token
    other = pt.Oscillink(Y, kneighbors=6, device="cpu")
    other.set_query(psi)
    assert other.receipt()["meta"]["state_sig"] != rt["meta"]["state_sig"]


def test_seeded_max_n_refusal(monkeypatch):
    monkeypatch.setenv("OSCILLINK_SEEDED_MAX_N", "4100")
    Y, _ = _inputs(4200, 8)
    for cls in (ot.Oscillink, lambda *a, **kw: pt.Oscillink(*a, device="cpu", **kw)):
        with pytest.raises(ValueError, match="OSCILLINK_SEEDED_MAX_N"):
            cls(Y, kneighbors=4, neighbor_seed=1)
    # deterministic_k ignores the seed, so the cap does not apply
    assert pt.Oscillink(Y, kneighbors=4, neighbor_seed=1, deterministic_k=True,
                        device="cpu").graph.idx.shape == (4200, 4)


def _state_pair(n, d, chain, seed=0):
    Y, psi = _inputs(n, d, seed)
    lj = ot.Oscillink(Y, kneighbors=5)
    lt = pt.Oscillink(Y, kneighbors=5, device="cpu")
    gates = np.linspace(0.5, 1.0, n).astype(np.float32)
    for lat in (lj, lt):
        lat.set_query(psi, gates=gates)
        if chain:
            lat.add_chain(chain, lamP=0.3)
        lat.settle(max_iters=8, tol=1e-3)
    return lj, lt


@pytest.mark.parametrize("fmt", ["json", "npz"])
@pytest.mark.parametrize("n,chain", [(300, [5, 2, 9, 11]), (2100, [7, 3, 12])])
def test_save_and_load_across_packages(tmp_path, fmt, n, chain):
    """A state saved by either package loads in the other: the same
    state_sig, the same provenance (exported again), deltaH within 1e-5."""
    lj, lt = _state_pair(n, 16, chain)
    sj, st = lj.export_state(), lt.export_state()
    assert sj["provenance"] == st["provenance"]
    assert set(sj) == set(st)
    assert ("A" in st) == (n <= 2048) and ("A_sparse" in st) == (n > 2048)
    for src_name, src in (("jax", lj), ("torch", lt)):
        path = str(tmp_path / f"{src_name}.{fmt}")
        src.save_state(path, format=fmt)
        if fmt == "json":
            with open(path, encoding="utf-8") as f:
                state = json.load(f)
            aj, at = ot.OscillinkLattice.from_state(state), pt.OscillinkLattice.from_state(
                state, device="cpu")
        else:
            aj, at = ot.OscillinkLattice.from_npz(path), pt.OscillinkLattice.from_npz(
                path, device="cpu")
        for lat in (aj, at):
            lat.settle(max_iters=8, tol=1e-3)
        rj, rt = aj.receipt(), at.receipt()
        assert rt["meta"]["state_sig"] == rj["meta"]["state_sig"], src_name
        # {"mode": "imported"} where A was stored; an NPZ above N = 2048
        # stores none, and both rebuild from Y
        assert rt["meta"].get("similarity_info") == rj["meta"].get("similarity_info")
        assert _rel(rt["deltaH_total"], rj["deltaH_total"]) <= 1e-5
        assert at.export_state()["provenance"] == aj.export_state()["provenance"]
        if fmt == "json":
            assert at._imported_provenance == state["provenance"]
            # the stored adjacency was installed, not rebuilt
            assert at.export_state()["provenance"] == state["provenance"]
        assert at._chain_nodes == aj._chain_nodes


def test_chain_order_walk_matches_jax():
    # without chain_nodes the path order is walked from the edges: the chain
    # [5, 2, 9] has edges [[2, 5], [2, 9]] and must not become 2-5-9
    lj, lt = _state_pair(300, 16, [5, 2, 9])
    state = lt.export_state()
    assert state["chain_edges"] == lj.export_state()["chain_edges"] == [[2, 5], [2, 9]]
    del state["chain_nodes"]
    aj = ot.OscillinkLattice.from_state(state)
    at = pt.OscillinkLattice.from_state(state, device="cpu")
    assert at._chain_nodes == aj._chain_nodes == [5, 2, 9]
    assert at.receipt()["meta"]["state_sig"] == aj.receipt()["meta"]["state_sig"]
    # a branching edge set falls back to sorted node ids in both
    state["chain_edges"] = [[1, 2], [1, 3], [1, 4]]
    aj = ot.OscillinkLattice.from_state(state)
    at = pt.OscillinkLattice.from_state(state, device="cpu")
    assert at._chain_nodes == aj._chain_nodes == [1, 2, 3, 4]


def test_state_without_graph_rebuilds_and_bad_shape_is_refused():
    lj, lt = _state_pair(200, 8, None)
    state = lt.export_state(include_graph=False, include_chain=False)
    at = pt.OscillinkLattice.from_state(state, device="cpu")
    aj = ot.OscillinkLattice.from_state(state)
    assert "similarity_info" not in at.receipt()["meta"]
    assert at.receipt()["meta"]["state_sig"] == aj.receipt()["meta"]["state_sig"]
    state["A"] = [[0.0] * 3] * 3
    with pytest.raises(ValueError, match="N, N"):
        pt.OscillinkLattice.from_state(state, device="cpu")


def test_dense_values_for_pairs_matches_jax():
    # both packages on one stored adjacency, so the values are the same bits
    _, lt = _state_pair(300, 16, None)
    state = lt.export_state()
    aj = ot.OscillinkLattice.from_state(state)
    at = pt.OscillinkLattice.from_state(state, device="cpu")
    pairs = np.concatenate([at._edge_pairs()[:50], np.array([[0, 0], [1, 299], [299, 1]])])
    got = at.dense_values_for_pairs(pairs)
    np.testing.assert_array_equal(got, aj.dense_values_for_pairs(pairs))
    A = np.array(state["A"], dtype=np.float32)
    np.testing.assert_array_equal(got, A[pairs[:, 0], pairs[:, 1]])


def test_save_state_rejects_unknown_format(tmp_path):
    _, lt = _state_pair(50, 8, None)
    with pytest.raises(ValueError, match="json"):
        lt.save_state(str(tmp_path / "x"), format="csv")


@pytest.mark.parametrize(
    "kw",
    [
        dict(row_cap_val=0.6),
        dict(kneighbors=3),
        dict(deterministic_k=True),
        dict(neighbor_seed=11),
        dict(similarity="fast"),
        dict(similarity="auto"),
    ],
)
def test_rebuild_graph_matches_jax(monkeypatch, kw):
    monkeypatch.setenv("OSCILLINK_FAST_SIM_N", "100")  # auto resolves to fast at N = 400
    Y, psi = _inputs(400, 16, seed=5)
    lj = ot.Oscillink(Y, kneighbors=6)
    lt = pt.Oscillink(Y, kneighbors=6, device="cpu")
    for lat in (lj, lt):
        lat.set_query(psi)
        lat.settle(max_iters=8, tol=1e-3)
    before = lt.receipt()["meta"]["state_sig"]
    for lat in (lj, lt):
        lat.rebuild_graph(**kw)
        lat.settle(max_iters=8, tol=1e-3)
    rj, rt = lj.receipt(), lt.receipt()
    assert rt["meta"]["state_sig"] == rj["meta"]["state_sig"] != before
    assert rt["meta"]["similarity"] == rj["meta"]["similarity"]
    (it, wt, _, _), (ij, wj, _, _) = _graph_np(lt), _graph_np(lj)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-6)
    assert _rel(rt["deltaH_total"], rj["deltaH_total"]) <= 1e-5
    with pytest.raises(ValueError, match="similarity must be"):
        lt.rebuild_graph(similarity="nope")


def test_graph_snapshot_install_serves_the_same_receipt():
    Y, psi = _inputs(500, 16, seed=8)
    src = pt.Oscillink(Y, kneighbors=6, similarity="fast", device="cpu")
    snap = src._graph_snapshot()
    assert set(snap) == set(ot.Oscillink(Y[:50], kneighbors=6)._graph_snapshot())
    dst = pt.Oscillink(Y, kneighbors=6, device="cpu", _defer_graph=True)
    assert dst.graph is None
    dst._install_graph_snapshot(snap)
    for lat in (src, dst):
        lat.set_query(psi)
        lat.settle(max_iters=8, tol=1e-3)
    rs, rd = src.receipt(), dst.receipt()
    assert rd["meta"]["state_sig"] == rs["meta"]["state_sig"]
    assert rd["meta"]["similarity"] == "fast"
    assert rd["deltaH_total"] == rs["deltaH_total"]


def test_graph_snapshot_guards():
    Y, _ = _inputs(300, 8, seed=9)
    snap = pt.Oscillink(Y, kneighbors=5, device="cpu")._graph_snapshot()
    with pytest.raises(ValueError, match="row count"):
        pt.Oscillink(Y[:200], kneighbors=5, device="cpu", _defer_graph=True)._install_graph_snapshot(snap)
    with pytest.raises(ValueError, match="params"):
        pt.Oscillink(Y, kneighbors=4, device="cpu", _defer_graph=True)._install_graph_snapshot(snap)
    with pytest.raises(ValueError, match="params"):
        pt.Oscillink(Y, kneighbors=5, row_cap_val=0.5, device="cpu",
                     _defer_graph=True)._install_graph_snapshot(snap)


def test_deferred_lattice_meta_is_imported():
    Y, _ = _inputs(100, 8)
    lat = pt.Oscillink(Y, kneighbors=4, device="cpu", _defer_graph=True)
    assert lat._similarity == "imported" and lat._similarity_info == {"mode": "imported"}
    lat._set_adjacency_dense(pt.Oscillink(Y, kneighbors=4, device="cpu").dense_adjacency())
    meta = lat.receipt()["meta"]
    assert meta["similarity_info"] == {"mode": "imported"}
    assert meta["similarity_recall_target"] == 1.0
