"""The port's batched multi-query solves (``models/batched.py`` and the
lattice's ``solve_Ustar_batch`` / ``bundle_batch``) against the JAX
package's vmapped ones.

The JAX package's vmapped ``while_loop`` stops each query at its own trip
count; the port must give the same per-query iterations, U* within 1e-5,
the same bundle ids and scores within 1e-4 relative, and per query what its
single solve gives.  The shared-graph tests carry the JAX graph across
(``interop``); the tests that build graphs in both packages first check
that the two builds agree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.models import batched as jb  # noqa: E402
from oscillink_tpu.models import coherence as jcoh  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jbuild_graph  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.models import batched as tb  # noqa: E402
from oscillink_tpu_torch.ops.graph import build_graph as tbuild_graph  # noqa: E402

LAMS = (1.0, 0.5, 4.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _queries(n, d, q, seed, gated=(1, 3)):
    """Q query vectors and [Q, N] gates: all ones, except the listed
    queries, whose gates are uniform in [0, 1]."""
    rng = np.random.default_rng(seed)
    psis = rng.standard_normal((q, d)).astype(np.float32)
    gates = np.ones((q, n), dtype=np.float32)
    for i in gated:
        if i < q:
            gates[i] = rng.random(n).astype(np.float32)
    return psis, gates


def _graph_pair(Y, k):
    gj = jax.jit(lambda Y: jbuild_graph(Y, k))(jnp.asarray(Y))
    gt = interop.graph_from_numpy(
        *(np.asarray(a) for a in (gj.idx, gj.w, gj.wn, gj.sqrt_deg)), device="cpu"
    )
    return gj, gt


@pytest.mark.parametrize("n,d,q,seed,tol,max_iters", [
    (400, 24, 4, 0, 1e-4, 64), (300, 128, 4, 1, 1e-4, 64), (250, 16, 3, 2, 1e-6, 7),
])
def test_solve_stationary_batch_matches_jax(n, d, q, seed, tol, max_iters):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    psis, gates = _queries(n, d, q, seed + 10)
    gj, gt = _graph_pair(Y, 6)
    Uj, itj, resj = jb.solve_stationary_batch(
        gj, jnp.asarray(Y), jnp.asarray(psis), jnp.asarray(gates),
        jcoh.EnergyParams.make(*LAMS, 0.0), tol=tol, max_iters=max_iters,
    )
    Ut, itt, rest = tb.solve_stationary_batch(
        gt, _t(Y), _t(psis), _t(gates), interop.energy_from_numpy(*LAMS, device="cpu"),
        tol=tol, max_iters=max_iters,
    )
    assert Ut.shape == (q, n, d)
    np.testing.assert_array_equal(itt, np.asarray(itj))
    np.testing.assert_allclose(rest, np.asarray(resj), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,n,d,k,seed", [(3, 200, 32, 6, 0), (2, 130, 16, 4, 3)])
def test_settle_lattice_batch_matches_jax(b, n, d, k, seed):
    rng = np.random.default_rng(seed)
    Ys = rng.standard_normal((b, n, d)).astype(np.float32)
    psis = rng.standard_normal((b, d)).astype(np.float32)
    Bs = rng.random((b, n)).astype(np.float32)
    for Y in Ys:  # the builds inside both batches must agree
        gj = jax.jit(lambda Y: jbuild_graph(Y, k))(jnp.asarray(Y))
        np.testing.assert_array_equal(tbuild_graph(_t(Y), k).idx.numpy(), np.asarray(gj.idx))
    Uj, itj, resj = jb.settle_lattice_batch(
        jnp.asarray(Ys), jnp.asarray(psis), jnp.asarray(Bs), jcoh.EnergyParams.make(*LAMS, 0.0),
        k=k, dt=0.5, tol=1e-4, max_iters=30,
    )
    Ut, itt, rest = tb.settle_lattice_batch(
        _t(Ys), _t(psis), _t(Bs), interop.energy_from_numpy(*LAMS, device="cpu"), k=k, dt=0.5,
        tol=1e-4, max_iters=30,
    )
    np.testing.assert_array_equal(itt, np.asarray(itj))
    np.testing.assert_allclose(rest, np.asarray(resj), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=1e-5, atol=1e-5)


def _lattice_pair(n=120, d=128, k=6, seed=0):
    Y = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    lj = ot.Oscillink(Y, kneighbors=k)
    lt = pt.Oscillink(Y, kneighbors=k, device="cpu")
    np.testing.assert_array_equal(lt.graph.idx.numpy(), np.asarray(lj._graph.idx))
    return lj, lt


@pytest.mark.parametrize("seed,q,k,alpha", [(0, 4, 6, 0.5), (1, 3, 4, 0.3), (2, 1, 8, 0.7)])
def test_lattice_batch_matches_jax(seed, q, k, alpha):
    lj, lt = _lattice_pair(seed=seed)
    psis, gates = _queries(lj.N, lj.D, q, seed + 20)
    for g in (None, gates):
        Uj, Ut = lj.solve_Ustar_batch(psis, g), lt.solve_Ustar_batch(psis, g)
        assert Ut.shape == (q, lj.N, lj.D) and Ut.flags.c_contiguous
        np.testing.assert_allclose(Ut, Uj, rtol=1e-5, atol=1e-5)
        bj = lj.bundle_batch(psis, g, k=k, alpha=alpha)
        bt = lt.bundle_batch(psis, g, k=k, alpha=alpha)
        assert [[e["id"] for e in b] for b in bt] == [[e["id"] for e in b] for b in bj]
        for qb_t, qb_j in zip(bt, bj):
            for et, ej in zip(qb_t, qb_j):
                assert et["score"] == pytest.approx(ej["score"], rel=1e-4, abs=1e-6)
                assert et["align"] == pytest.approx(ej["align"], rel=1e-4, abs=1e-6)


@pytest.mark.parametrize("bad", [
    dict(psis=np.ones((2, 7), np.float32)),
    dict(psis=np.ones(128, np.float32)),
    dict(psis=np.ones((2, 128), np.float32), gates=np.ones((3, 120), np.float32)),
    dict(psis=np.ones((2, 128), np.float32), gates=np.ones((2, 119), np.float32)),
])
def test_solve_ustar_batch_input_errors_match_jax(bad):
    lj, lt = _lattice_pair()
    with pytest.raises(ValueError) as ej:
        lj.solve_Ustar_batch(**bad)
    with pytest.raises(ValueError) as et:
        lt.solve_Ustar_batch(**bad)
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError):
        lt.bundle_batch(**bad)


def test_batch_equals_single_queries_in_the_port():
    """Per query, the batch gives the single solve's U* and bundle; the
    ustar_batch event is logged as the JAX package logs it."""
    _, lt = _lattice_pair(seed=4)
    psis, gates = _queries(lt.N, lt.D, 4, 30)
    events = []
    lt.set_logger(lambda ev, payload: events.append((ev, payload)))
    Ub = lt.solve_Ustar_batch(psis, gates, tol=1e-5, max_iters=80)
    bb = lt.bundle_batch(psis, gates, k=5)
    assert ("ustar_batch", {"queries": 4, "tol": 1e-5, "max_iters": 80}) in events
    for i in range(4):
        lt.set_query(psis[i], gates=gates[i])
        np.testing.assert_allclose(Ub[i], lt.solve_Ustar(tol=1e-5, max_iters=80), rtol=1e-6,
                                   atol=1e-6)
        lt.refresh_Ustar()
        single = lt.bundle(k=5)
        assert [e["id"] for e in bb[i]] == [e["id"] for e in single]
        for eb, es in zip(bb[i], single):
            assert eb["score"] == pytest.approx(es["score"], rel=1e-5, abs=1e-6)


def test_lattice_records_each_querys_iterations():
    """``last_ustar_batch`` holds the batched solve's own per-query
    iterations: the JAX package's vmapped counts on the same graph, and
    each query's single solve's count; `bundle_batch` records its solve
    the same way."""
    lj, lt = _lattice_pair(seed=5)
    psis, gates = _queries(lt.N, lt.D, 4, 40)
    lt.solve_Ustar_batch(psis, gates, tol=1e-6, max_iters=80)
    rec = lt.last_ustar_batch
    _, itj, resj = jb.solve_stationary_batch(
        lj._graph, jnp.asarray(lj.Y), jnp.asarray(psis), jnp.asarray(gates),
        jcoh.EnergyParams.make(*LAMS, 0.0), tol=1e-6, max_iters=80,
    )
    assert rec["iters"] == np.asarray(itj).tolist() and len(set(rec["iters"])) > 1
    np.testing.assert_allclose(rec["res"], np.asarray(resj), rtol=1e-3, atol=1e-7)
    for i in range(4):
        lt.set_query(psis[i], gates=gates[i])
        lt.solve_Ustar(tol=1e-6, max_iters=80, use_cache=False)
        assert lt.last_ustar["iters"] == rec["iters"][i]
    lt.bundle_batch(psis, gates, k=5)
    from_bundle = lt.last_ustar_batch["iters"]
    lt.solve_Ustar_batch(psis, gates)  # bundle_batch solves at the defaults
    assert from_bundle == lt.last_ustar_batch["iters"]


def test_batch_ignores_the_chain_and_the_window_context(monkeypatch):
    """As in the JAX package, the batch solves on the gather operator with
    no chain prior, whatever the lattice holds."""
    _, plain = _lattice_pair(seed=5)
    assert plain._window_ctx is None
    monkeypatch.setenv("OSCILLINK_WINDOWED_MATVEC", "1")
    lt = pt.Oscillink(plain.Y, kneighbors=6, device="cpu")
    assert lt._window_ctx is not None
    lt.add_chain([1, 4, 9], lamP=0.3)
    psis, gates = _queries(lt.N, lt.D, 2, 40)
    np.testing.assert_array_equal(lt.solve_Ustar_batch(psis, gates),
                                  plain.solve_Ustar_batch(psis, gates))
