"""The port's sharded build, settle and serve (`parallel.sharded_build`,
`parallel.sharded`, `parallel.serve`) against the JAX package's on its
8-virtual-device CPU mesh, and against the port's single-device paths.

* Build: the graph bit-equal to the port's single-device `build_graph`
  (exact, fast, fastest; dense and blocked sizes), and idx identical to
  the JAX sharded build's.
* Settle: port against JAX at 8 shards, U and U* within 1e-5 of max|U|,
  ΔH within 1e-5 relative, identical iterations; 8 shards against 1 and
  against the port's lattice at the JAX test's bars (1e-4 / 2e-4,
  ``tests/test_sharded.py:21``, ``:43``).
* Serve: ΔH within 1e-5 relative of the JAX sharded serve, other sums 1e-4,
  nulls, bundle ids, iterations and chain verdicts equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscillink_tpu.parallel import lattice_mesh as jax_mesh  # noqa: E402
from oscillink_tpu.parallel import serve as jax_serve  # noqa: E402
from oscillink_tpu.parallel import sharded_build_and_settle as jax_settle  # noqa: E402
from oscillink_tpu.parallel.sharded_build import build_graph_sharded as jax_build  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu_torch.interop import graph_from_numpy  # noqa: E402
from oscillink_tpu_torch.ops.graph import build_graph  # noqa: E402
from oscillink_tpu_torch.parallel import lattice_mesh, sharded_build_and_settle  # noqa: E402
from oscillink_tpu_torch.parallel import serve  # noqa: E402
from oscillink_tpu_torch.parallel.mesh import gather_rows  # noqa: E402
from oscillink_tpu_torch.parallel.sharded_build import build_graph_sharded  # noqa: E402

REL = 1e-5
MESH8 = [torch.device("cpu")] * 8


def _rand(n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32), rng.standard_normal(d).astype(np.float32)


@pytest.mark.parametrize("n,d,k,sim,seed", [
    (64, 16, 4, "exact", 0), (512, 24, 6, "exact", 1), (8192, 24, 6, "exact", 3),
    (2048, 32, 6, "fast", 2), (8192, 16, 8, "fastest", 4),
])
def test_sharded_build_is_the_single_device_graph(n, d, k, sim, seed):
    Y, _ = _rand(n, d, seed)
    g8 = build_graph_sharded(lattice_mesh(devices=MESH8), Y, k, similarity=sim)
    g1 = build_graph(torch.from_numpy(Y), k, similarity=sim)
    for a, b in zip(g8, g1):
        assert torch.equal(a, b)
    gj = jax_build(jax_mesh(8), jnp.asarray(Y), k, similarity=sim)
    np.testing.assert_array_equal(g8.idx.numpy(), np.asarray(gj.idx))
    np.testing.assert_allclose(g8.w.numpy(), np.asarray(gj.w), rtol=0, atol=1e-6)


def test_sharded_build_refuses_cluster_and_indivisible():
    Y, _ = _rand(64, 8, 0)
    with pytest.raises(ValueError, match="cluster"):
        build_graph_sharded(lattice_mesh(devices=MESH8), Y, 4, similarity="cluster")
    with pytest.raises(ValueError):
        build_graph_sharded(lattice_mesh(devices=MESH8), Y[:60], 4)


@pytest.mark.parametrize("n,d,seed,tol,iters", [(64, 16, 0, 1e-5, 50), (48, 12, 1, 1e-6, 100),
                                                (1024, 32, 5, 1e-4, 64)])
def test_sharded_settle_matches_jax(n, d, seed, tol, iters):
    Y, psi = _rand(n, d, seed)
    kw = dict(k=4, tol=tol, max_iters=iters)
    port = sharded_build_and_settle(Y, psi, mesh=lattice_mesh(devices=MESH8), **kw)
    jax = jax_settle(Y, psi, mesh=jax_mesh(8), **kw)
    for key in ("U", "Ustar"):
        ref = np.asarray(jax[key])
        assert np.abs(gather_rows(port[key]).numpy() - ref).max() <= REL * np.abs(ref).max(), key
    assert abs(port["deltaH"] - jax["deltaH"]) <= REL * abs(jax["deltaH"])
    for key in ("settle_iters", "ustar_iters", "mesh_devices"):
        assert port[key] == jax[key], key
    one = sharded_build_and_settle(Y, psi, mesh=lattice_mesh(devices=MESH8[:1]), **kw)
    np.testing.assert_allclose(gather_rows(port["U"]).numpy(), gather_rows(one["U"]).numpy(),
                               rtol=1e-4, atol=1e-4)
    assert abs(port["deltaH"] - one["deltaH"]) <= max(1e-2, 1e-3 * abs(one["deltaH"]))
    lat = pt.Oscillink(Y, kneighbors=4, device="cpu")
    lat.set_query(psi)
    np.testing.assert_allclose(gather_rows(port["Ustar"]).numpy(),
                               lat.solve_Ustar(tol=tol, max_iters=iters), rtol=2e-4, atol=2e-4)


def test_sharded_settle_indivisible_raises():
    Y, psi = _rand(30, 8, 2)
    with pytest.raises(ValueError):
        sharded_build_and_settle(Y, psi, k=3, mesh=lattice_mesh(devices=MESH8))


def _assert_serve_matches(port, jax):
    for key in ("U", "Ustar"):
        ref = np.asarray(jax[key])
        assert np.abs(gather_rows(port[key]).numpy() - ref).max() <= REL * np.abs(ref).max()
    assert abs(port["deltaH"] - jax["deltaH"]) <= REL * abs(jax["deltaH"])
    for key in ("coh_drop_sum", "anchor_pen_sum", "query_term_sum"):
        assert port[key] == pytest.approx(jax[key], rel=1e-4), key
    for key in ("settle_iters", "ustar_iters", "ustar_converged", "n_edges", "mesh_devices"):
        assert port[key] == jax[key], key
    assert [e["edge"] for e in port["null_points"]] == [e["edge"] for e in jax["null_points"]]
    for a, b in zip(port["null_points"], jax["null_points"]):
        assert a["z"] == pytest.approx(b["z"], rel=1e-4, abs=1e-3)
    if jax["bundle"] is None:
        assert port["bundle"] is None
    else:
        assert [e["id"] for e in port["bundle"]] == [e["id"] for e in jax["bundle"]]


@pytest.mark.parametrize("chain,gates,bundle_k", [(None, False, 5), ([0, 1, 2, 3], True, 0),
                                                  ([7, 3, 90, 44], False, 8)])
def test_sharded_serve_matches_jax(chain, gates, bundle_k):
    Y, psi = _rand(512, 16, 7)
    Y[5] += 25.0
    Y[60] -= 25.0
    B = np.random.default_rng(1).uniform(0.3, 1.0, 512).astype(np.float32) if gates else None
    kw = dict(k=6, settle_tol=1e-3, settle_iters=8, bundle_k=bundle_k, chain=chain, lamP=0.3)
    port = serve.sharded_serve(lattice_mesh(devices=MESH8), Y, psi, B, **kw)
    _assert_serve_matches(port, jax_serve.sharded_serve(jax_mesh(8), Y, psi, B, **kw))


def test_sharded_serve_on_a_given_graph():
    """``graph=`` serves over a prebuilt graph: the JAX graph carried over
    gives the JAX serve's receipt."""
    Y, psi = _rand(256, 8, 3)
    gj = jax_build(jax_mesh(8), jnp.asarray(Y), 5)
    gt = graph_from_numpy(*(np.asarray(a) for a in gj), device="cpu")
    port = serve.sharded_serve(lattice_mesh(devices=MESH8), Y, psi, k=5, bundle_k=4, graph=gt)
    _assert_serve_matches(port, jax_serve.sharded_serve(jax_mesh(8), Y, psi, k=5, bundle_k=4,
                                                        graph=gj))


@pytest.mark.parametrize("chain,similarity", [([0, 3, 7, 11], "auto"), ([5, 60, 2], "cluster")])
def test_sharded_chain_receipt_matches_jax(chain, similarity):
    Y, psi = _rand(256, 8, 8)
    kw = dict(k=6, lamP=0.2, z_th=2.5, similarity=similarity)
    port = serve.sharded_chain_receipt(lattice_mesh(devices=MESH8), Y, psi, None, chain, **kw)
    jax = jax_serve.sharded_chain_receipt(jax_mesh(8), Y, psi, None, chain, **kw)
    assert port["verdict"] == jax["verdict"] and port["ustar_iters"] == jax["ustar_iters"]
    assert port["weakest_link"]["edge"] == jax["weakest_link"]["edge"]
    assert port["coherence_gain"] == pytest.approx(jax["coherence_gain"], rel=1e-4, abs=1e-6)
    for a, b in zip(port["edges"], jax["edges"]):
        assert a["edge"] == b["edge"]
        for key in ("z_struct", "z_path", "r_struct", "r_path"):
            assert a[key] == pytest.approx(b[key], rel=1e-4, abs=1e-3), key
    with pytest.raises(ValueError):
        serve.sharded_chain_receipt(lattice_mesh(devices=MESH8), Y, psi, None, [0, 400])
