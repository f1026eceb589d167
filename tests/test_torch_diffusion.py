"""Screened-diffusion gates of the port (``preprocess/diffusion.py`` and the
lattice's ``diffusion_gates`` / ``diffusion_gates_batch``) against the JAX
package's.

Both packages get the same numpy inputs on the CPU; gates agree within
1e-5.  The paths that build their own graph first check that the two builds
agree.  The port keeps the numerical fallbacks (uniform ones) but lets any
other error raise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jbuild_graph  # noqa: E402
from oscillink_tpu.preprocess import diffusion as jd  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.ops.graph import build_graph as tbuild_graph  # noqa: E402
from oscillink_tpu_torch.preprocess import diffusion as td  # noqa: E402

TOL = 1e-5


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    return Y, Y[:8].mean(0).astype(np.float32)


def _same_build(Y, k, jitter=None):
    jj = None if jitter is None else jnp.asarray(jitter)
    gj = jax.jit(lambda Y: jbuild_graph(Y, k, jitter=jj))(jnp.asarray(Y))
    jt = None if jitter is None else torch.from_numpy(jitter)
    gt = tbuild_graph(torch.from_numpy(Y), k, jitter=jt)
    np.testing.assert_array_equal(gt.idx.numpy(), np.asarray(gj.idx))
    np.testing.assert_allclose(gt.wn.numpy(), np.asarray(gj.wn), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,d,k,method,kw", [
    (200, 32, 6, "direct", {}),
    (200, 32, 6, "cg", {}),
    (150, 16, 4, "direct", dict(beta=2.0, gamma=0.3, row_cap_val=0.5)),
    (150, 16, 4, "cg", dict(gamma=0.05, tol=1e-6, max_iters=400, clamp=False)),
    (4200, 8, 5, "direct", dict(max_iters=64)),  # above the dense limit: CG
])
def test_compute_diffusion_gates_matches_jax(n, d, k, method, kw):
    Y, psi = _data(n, d, n + d)
    _same_build(Y, k)
    hj = ot.compute_diffusion_gates(Y, psi, kneighbors=k, method=method, **kw)
    ht = pt.compute_diffusion_gates(Y, psi, kneighbors=k, method=method, device="cpu", **kw)
    assert ht.dtype == np.float32 and ht.shape == (n,)
    np.testing.assert_allclose(ht, hj, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("method", ["direct", "cg"])
def test_neighbor_seed_jitter_matches_jax(method):
    rng = np.random.default_rng(7)
    base = rng.standard_normal((30, 12)).astype(np.float32)
    Y = base[rng.integers(0, 30, size=120)]  # duplicate rows: exact ties
    psi = base[:4].mean(0).astype(np.float32)
    jitter = np.random.default_rng(11).uniform(-1e-8, 1e-8, size=(120, 120)).astype(np.float32)
    _same_build(Y, 5, jitter)
    hj = ot.compute_diffusion_gates(Y, psi, kneighbors=5, neighbor_seed=11, method=method)
    ht = pt.compute_diffusion_gates(Y, psi, kneighbors=5, neighbor_seed=11, method=method,
                                    device="cpu")
    np.testing.assert_allclose(ht, hj, rtol=TOL, atol=TOL)
    # deterministic_k ignores the seed, as in the JAX package
    np.testing.assert_array_equal(
        pt.compute_diffusion_gates(Y, psi, kneighbors=5, neighbor_seed=11, deterministic_k=True,
                                   device="cpu"),
        pt.compute_diffusion_gates(Y, psi, kneighbors=5, device="cpu"))


def _graphs(Y, k):
    gj = jax.jit(lambda Y: jbuild_graph(Y, k))(jnp.asarray(Y))
    gt = interop.graph_from_numpy(*(np.asarray(a) for a in (gj.idx, gj.w, gj.wn, gj.sqrt_deg)),
                                  device="cpu")
    return gj, gt


@pytest.mark.parametrize("kw", [{}, dict(beta=0.5, gamma=0.2, clamp=False),
                                dict(tol=1e-7, max_iters=20)])
def test_from_graph_matches_jax(kw):
    Y, psi = _data(300, 24, 1)
    gj, gt = _graphs(Y, 6)
    hj = jd.compute_diffusion_gates_from_graph(gj, jnp.asarray(Y), psi, **kw)
    ht = td.compute_diffusion_gates_from_graph(gt, torch.from_numpy(Y), psi, **kw)
    np.testing.assert_allclose(ht, hj, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("q,kw", [(4, {}), (3, dict(beta=2.0, gamma=0.05, tol=1e-6)),
                                  (2, dict(max_iters=5))])
def test_from_graph_batch_matches_jax_and_single(q, kw):
    Y, _ = _data(300, 24, 2)
    psis = np.random.default_rng(3).standard_normal((q, 24)).astype(np.float32)
    gj, gt = _graphs(Y, 6)
    hj = jd.compute_diffusion_gates_from_graph_batch(gj, jnp.asarray(Y), psis, **kw)
    ht = td.compute_diffusion_gates_from_graph_batch(gt, torch.from_numpy(Y), psis, **kw)
    assert ht.shape == (q, 300) and ht.dtype == np.float32
    np.testing.assert_allclose(ht, hj, rtol=TOL, atol=TOL)
    for i in range(q):
        single = td.compute_diffusion_gates_from_graph(gt, torch.from_numpy(Y), psis[i], **kw)
        np.testing.assert_allclose(ht[i], single, rtol=TOL, atol=TOL)


def test_lattice_diffusion_gates_match_jax():
    Y, psi = _data(120, 128, 0)
    lj, lt = ot.Oscillink(Y, kneighbors=6), pt.Oscillink(Y, kneighbors=6, device="cpu")
    np.testing.assert_array_equal(lt.graph.idx.numpy(), np.asarray(lj._graph.idx))
    for lat in (lj, lt):
        lat.set_query(psi)
    np.testing.assert_allclose(lt.diffusion_gates(), lj.diffusion_gates(), rtol=TOL, atol=TOL)
    psis = np.random.default_rng(1).standard_normal((3, 128)).astype(np.float32)
    np.testing.assert_allclose(lt.diffusion_gates_batch(psis, gamma=0.2),
                               lj.diffusion_gates_batch(psis, gamma=0.2), rtol=TOL, atol=TOL)
    hj, ht = lj.diffusion_gates(psis[0], apply=True), lt.diffusion_gates(psis[0], apply=True)
    np.testing.assert_array_equal(lt.B_diag, ht)
    np.testing.assert_allclose(ht, hj, rtol=TOL, atol=TOL)


def test_lattice_records_each_gate_solves_iterations():
    """``last_gates`` holds the batched gate solve's own per-query
    iterations, each its single solve's count."""
    Y, _ = _data(300, 24, 6)
    lt = pt.Oscillink(Y, kneighbors=6, device="cpu")
    psis = np.random.default_rng(7).standard_normal((4, 24)).astype(np.float32)
    psis[2] *= -1.0
    G = lt.diffusion_gates_batch(psis, tol=1e-6)
    batch = lt.last_gates
    assert len(batch["iters"]) == 4 and len(batch["res"]) == 4
    for i in range(4):
        np.testing.assert_allclose(lt.diffusion_gates(psis[i], tol=1e-6), G[i], rtol=TOL, atol=TOL)
        assert lt.last_gates["iters"] == batch["iters"][i]
        assert lt.last_gates["res"] == pytest.approx(batch["res"][i], rel=1e-5, abs=1e-9)


def test_nonfinite_psi_gives_uniform_ones_as_in_jax():
    Y, psi = _data(100, 16, 4)
    bad = psi.copy()
    bad[3] = np.nan
    gj, gt = _graphs(Y, 5)
    for method in ("direct", "cg"):
        ht = pt.compute_diffusion_gates(Y, bad, kneighbors=5, method=method, device="cpu")
        hj = ot.compute_diffusion_gates(Y, bad, kneighbors=5, method=method)
        np.testing.assert_array_equal(ht, np.ones(100, np.float32))
        np.testing.assert_array_equal(ht, hj)
    ht = td.compute_diffusion_gates_from_graph(gt, torch.from_numpy(Y), bad)
    hj = jd.compute_diffusion_gates_from_graph(gj, jnp.asarray(Y), bad)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(ht, np.ones(100, np.float32))
    # in the batch only the non-finite lane falls back
    psis = np.stack([psi, bad, -psi])
    hb = td.compute_diffusion_gates_from_graph_batch(gt, torch.from_numpy(Y), psis)
    np.testing.assert_array_equal(hb[1], np.ones(100, np.float32))
    assert not np.all(hb[0] == 1.0) and not np.all(hb[2] == 1.0)
    np.testing.assert_allclose(
        hb, jd.compute_diffusion_gates_from_graph_batch(gj, jnp.asarray(Y), psis), rtol=TOL,
        atol=TOL)


def test_singular_dense_system_gives_uniform_ones(monkeypatch):
    def singular(A, b):
        raise torch.linalg.LinAlgError("singular")

    monkeypatch.setattr(td.torch.linalg, "solve", singular)
    Y, psi = _data(60, 8, 5)
    np.testing.assert_array_equal(pt.compute_diffusion_gates(Y, psi, device="cpu"),
                                  np.ones(60, np.float32))


@pytest.mark.parametrize("call", ["cg", "from_graph", "batch", "lattice", "lattice_batch"])
def test_operator_errors_propagate(monkeypatch, call):
    """A failure inside the operator (on the card: K1 failing to build or
    launch) raises; it never turns into uniform gates."""
    Y, psi = _data(80, 8, 6)
    lat = pt.Oscillink(Y, kneighbors=5, device="cpu")

    def broken(g, X):
        raise RuntimeError("spmv_gather launch failed")

    monkeypatch.setattr(td, "lap_matvec", broken)
    calls = {
        "cg": lambda: pt.compute_diffusion_gates(Y, psi, method="cg", device="cpu"),
        "from_graph": lambda: td.compute_diffusion_gates_from_graph(lat.graph, lat._Y_dev, psi),
        "batch": lambda: td.compute_diffusion_gates_from_graph_batch(lat.graph, lat._Y_dev,
                                                                     psi[None]),
        "lattice": lambda: lat.diffusion_gates(psi),
        "lattice_batch": lambda: lat.diffusion_gates_batch(psi[None]),
    }
    with pytest.raises(RuntimeError, match="launch failed"):
        calls[call]()


@pytest.mark.parametrize("args,kw", [
    ((np.ones(5, np.float32), np.ones(5, np.float32)), {}),
    ((np.ones((5, 4), np.float32), np.ones(3, np.float32)), {}),
    ((np.ones((5, 4), np.float32), np.ones(4, np.float32)), dict(gamma=0.0)),
    ((np.ones((5, 4), np.float32), np.ones(4, np.float32)), dict(kneighbors=0)),
    ((np.ones((5, 4), np.float32), np.ones(4, np.float32)), dict(similarity="dot")),
    ((np.ones((4200, 2), np.float32), np.ones(2, np.float32)), dict(neighbor_seed=1)),
])
def test_input_errors_match_jax(args, kw):
    with pytest.raises(ValueError) as ej:
        ot.compute_diffusion_gates(*args, **kw)
    with pytest.raises(ValueError) as et:
        pt.compute_diffusion_gates(*args, device="cpu", **kw)
    assert str(et.value) == str(ej.value)


def test_from_graph_input_errors_match_jax():
    Y, psi = _data(50, 8, 8)
    gj, gt = _graphs(Y, 4)
    Yj, Yt = jnp.asarray(Y), torch.from_numpy(Y)
    cases = [
        (jd.compute_diffusion_gates_from_graph, td.compute_diffusion_gates_from_graph,
         (psi[:5],), {}),
        (jd.compute_diffusion_gates_from_graph, td.compute_diffusion_gates_from_graph,
         (psi,), dict(gamma=-1.0)),
        (jd.compute_diffusion_gates_from_graph_batch, td.compute_diffusion_gates_from_graph_batch,
         (psi[None, :5],), {}),
        (jd.compute_diffusion_gates_from_graph_batch, td.compute_diffusion_gates_from_graph_batch,
         (psi,), {}),
        (jd.compute_diffusion_gates_from_graph_batch, td.compute_diffusion_gates_from_graph_batch,
         (psi[None],), dict(gamma=0.0)),
    ]
    for fj, ft, args, kw in cases:
        with pytest.raises(ValueError) as ej:
            fj(gj, Yj, *args, **kw)
        with pytest.raises(ValueError) as et:
            ft(gt, Yt, *args, **kw)
        assert str(et.value) == str(ej.value)
