"""The port's column-chunked solves and chunked full receipt against the JAX
package's (tests/test_orbax_checkpoint.py::test_chunked_solve_matches and
::test_lattice_forced_col_chunks, tests/test_chunked_receipts.py).

The chunked solves must stop after the same maximum iteration count as the
JAX functions, with U within 1e-5.  Under ``OSCILLINK_COL_CHUNKS=4`` the
two lattices meet the lattice bars: deltaH within 1e-5 relative, the same
null-point count, bundle ids, state signature and settle and U* iteration
counts; the chunked receipt's sums match the full-width receipt's as the
JAX package's own test holds them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.models import coherence as jcoh  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jbuild_graph  # noqa: E402
from oscillink_tpu.ops.path import build_path_graph as jbuild_path  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.models import coherence as tcoh  # noqa: E402
from oscillink_tpu_torch.ops import receipts as treceipts  # noqa: E402

LAMS = (1.0, 0.5, 4.0, 0.2)
CHAIN = [2, 5, 7, 9]


def _state(n=300, d=32, k=6, seed=0, chain=None):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    U = (Y + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    B = (0.5 + rng.random(n)).astype(np.float32)
    gj = jax.jit(lambda Y: jbuild_graph(Y, k))(jnp.asarray(Y))
    gt = interop.graph_from_numpy(*(np.asarray(a) for a in (gj.idx, gj.w, gj.wn, gj.sqrt_deg)),
                                  device="cpu")
    pj = pt_ = None
    if chain is not None:
        pj = jbuild_path(n, chain)
        pt_ = interop.path_from_numpy(
            *(np.asarray(a) for a in (pj.src, pj.dst, pj.w, pj.wn, pj.sqrt_deg)), device="cpu")
    j = dict(g=gj, pg=pj, lam=jcoh.EnergyParams.make(*LAMS))
    t = dict(g=gt, pg=pt_, lam=interop.energy_from_numpy(*LAMS, device="cpu"))
    return j, t, dict(Y=Y, U=U, psi=psi, B=B)


def _jt(host):
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v.copy()) for k, v in host.items()})


@pytest.mark.parametrize("col_chunks", [2, 4])
@pytest.mark.parametrize("chain", [None, CHAIN])
def test_solve_stationary_chunked_matches_jax(col_chunks, chain):
    j, t, host = _state(chain=chain)
    hj, ht = _jt(host)
    for x0 in (None, "U"):
        Uj, itj, resj = jcoh.solve_stationary_chunked(
            j["g"], j["pg"], hj["Y"], hj["psi"], hj["B"], j["lam"], tol=1e-5, max_iters=200,
            col_chunks=col_chunks, x0=None if x0 is None else hj["U"])
        Ut, itt, rest = tcoh.solve_stationary_chunked(
            t["g"], t["pg"], ht["Y"], ht["psi"], ht["B"], t["lam"], tol=1e-5, max_iters=200,
            col_chunks=col_chunks, x0=None if x0 is None else ht["U"])
        assert itt == int(itj)
        assert Ut.is_contiguous() and Ut.shape == ht["Y"].shape
        np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=1e-5, atol=1e-5)
        assert rest <= 1e-5 * 1.01


@pytest.mark.parametrize("col_chunks", [2, 4])
@pytest.mark.parametrize("donate_u", [False, True])
@pytest.mark.parametrize("chain,dt,jacobi", [(None, 1.0, True), (CHAIN, 0.5, False)])
def test_settle_step_chunked_matches_jax(col_chunks, donate_u, chain, dt, jacobi):
    j, t, host = _state(seed=3, chain=chain)
    hj, ht = _jt(host)
    Uj, itj, _ = jcoh.settle_step_chunked(
        j["g"], j["pg"], hj["U"], hj["Y"], hj["psi"], hj["B"], j["lam"], dt=dt, tol=1e-4,
        max_iters=40, use_jacobi=jacobi, col_chunks=col_chunks)
    U_in = ht["U"]
    Ut, itt, _ = tcoh.settle_step_chunked(
        t["g"], t["pg"], U_in, ht["Y"], ht["psi"], ht["B"], t["lam"], dt=dt, tol=1e-4,
        max_iters=40, x0=U_in, use_jacobi=jacobi, col_chunks=col_chunks, donate_u=donate_u)
    assert itt == int(itj)
    # donate_u writes into U's own buffer; otherwise U is left as it was
    assert (Ut.data_ptr() == U_in.data_ptr()) == donate_u
    if not donate_u:
        np.testing.assert_array_equal(U_in.numpy(), host["U"])
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=1e-5, atol=1e-5)


def test_chunked_solves_refuse_a_non_divisor():
    j, t, host = _state()
    _, ht = _jt(host)
    with pytest.raises(ValueError, match="must divide col_chunks"):
        tcoh.solve_stationary_chunked(t["g"], None, ht["Y"], ht["psi"], ht["B"], t["lam"],
                                      col_chunks=5)
    with pytest.raises(ValueError, match="must divide col_chunks"):
        tcoh.settle_step_chunked(t["g"], None, ht["U"], ht["Y"], ht["psi"], ht["B"], t["lam"],
                                 col_chunks=3)


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    m = Y[:20].mean(0)
    return Y, (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("seed,chain,warm", [(0, None, "0"), (1, CHAIN, "0"), (2, None, "1")])
def test_lattice_under_col_chunks_4_matches_jax(monkeypatch, seed, chain, warm):
    """The gather settle, U* and full receipt chunked in both packages
    (OSCILLINK_USTAR_WARMSTART's x0 too), held to the lattice bar."""
    monkeypatch.setenv("OSCILLINK_COL_CHUNKS", "4")
    monkeypatch.setenv("OSCILLINK_USTAR_WARMSTART", warm)
    Y, psi = _inputs(400, 64, seed)
    lj = ot.Oscillink(Y, kneighbors=6)
    lt = pt.Oscillink(Y, kneighbors=6, device="cpu")
    assert lj._auto_col_chunks() == lt._auto_col_chunks() == 4
    assert lt._auto_col_chunks_gather(2) == 4
    for lat in (lj, lt):
        lat.set_query(psi)
        if chain is not None:
            lat.add_chain(chain, lamP=0.2)
    for _ in range(2):  # the second settle may take U's buffer (donate_u)
        sj, st_ = lj.settle(max_iters=12, tol=1e-3), lt.settle(max_iters=12, tol=1e-3)
        assert int(st_["iters"]) == int(sj["iters"])
    rj, rt = lj.receipt(), lt.receipt()
    assert _rel(rt["deltaH_total"], rj["deltaH_total"]) <= 1e-5
    assert len(rt["null_points"]) == len(rj["null_points"])
    assert rt["meta"]["state_sig"] == rj["meta"]["state_sig"]
    assert rt["meta"]["ustar_iters"] == rj["meta"]["ustar_iters"]
    assert rt["cg_iters"] == rj["cg_iters"]
    for key in ("coh_drop_sum", "anchor_pen_sum", "query_term_sum"):
        assert _rel(rt[key], rj[key]) <= 1e-4, key
    assert [b["id"] for b in lt.bundle(k=6)] == [b["id"] for b in lj.bundle(k=6)]
    if chain is not None:
        assert lt.chain_receipt(chain)["verdict"] == lj.chain_receipt(chain)["verdict"]
    np.testing.assert_allclose(lt.U, lj.U, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lt.solve_Ustar(), lj.solve_Ustar(), rtol=1e-5, atol=1e-5)


def test_lattice_forced_col_chunks(monkeypatch):
    """OSCILLINK_COL_CHUNKS routes the U* solve through the chunked path
    with the full-width result; an indivisible request is ignored."""
    rng = np.random.default_rng(5)
    Y = rng.standard_normal((40, 12)).astype(np.float32)
    psi = rng.standard_normal(12).astype(np.float32)
    lat = pt.Oscillink(Y, kneighbors=4, deterministic_k=True, device="cpu")
    lat.set_query(psi)
    U_full = lat.solve_Ustar(tol=1e-6, max_iters=200).copy()
    monkeypatch.setenv("OSCILLINK_COL_CHUNKS", "4")
    calls = []
    orig = tcoh.solve_stationary_chunked
    monkeypatch.setattr("oscillink_tpu_torch.core.lattice.solve_stationary_chunked",
                        lambda *a, **kw: calls.append(kw["col_chunks"]) or orig(*a, **kw))
    lat2 = pt.Oscillink(Y, kneighbors=4, deterministic_k=True, device="cpu")
    lat2.set_query(psi)
    assert lat2._auto_col_chunks() == 4
    U_chunk = lat2.solve_Ustar(tol=1e-6, max_iters=200)
    assert calls == [4]
    np.testing.assert_allclose(U_chunk, U_full, rtol=1e-5, atol=1e-5)
    monkeypatch.setenv("OSCILLINK_COL_CHUNKS", "5")
    assert lat2._auto_col_chunks() == 1


@pytest.mark.parametrize("chain", [None, CHAIN])
def test_receipt_full_chunked_matches_unchunked(monkeypatch, chain):
    """The port's chunked full receipt against its full-width one, with the
    JAX package's own bars: deltaH 1e-5 relative, the three sums 1e-4, the
    same null-point count (and edges).  The settle and U* chunk too, so U*
    itself moves within the solve tolerance."""
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((600, 32)).astype(np.float32)
    psi = rng.standard_normal(32).astype(np.float32)

    def run():
        lat = pt.Oscillink(Y, kneighbors=5, device="cpu")
        lat.set_query(psi)
        if chain is not None:
            lat.add_chain(chain, lamP=0.2)
        lat.settle(max_iters=10, tol=1e-3)
        return lat.receipt()

    monkeypatch.setenv("OSCILLINK_COL_CHUNKS", "1")
    r_full = run()
    monkeypatch.setenv("OSCILLINK_COL_CHUNKS", "4")
    chunked = []
    orig = treceipts.receipt_full_chunked
    monkeypatch.setattr("oscillink_tpu_torch.core.lattice.receipt_full_chunked",
                        lambda *a: chunked.append(a[-1]) or orig(*a))
    r_chunk = run()
    assert chunked == [4]
    assert r_chunk["deltaH_total"] == pytest.approx(r_full["deltaH_total"], rel=1e-5)
    for k in ("coh_drop_sum", "anchor_pen_sum", "query_term_sum"):
        assert r_chunk[k] == pytest.approx(r_full[k], rel=1e-4, abs=1e-4)
    assert len(r_chunk["null_points"]) == len(r_full["null_points"])
    assert [e["edge"] for e in r_chunk["null_points"]] == [e["edge"] for e in r_full["null_points"]]


def test_receipt_full_chunked_sums_and_refusal():
    """Direct: the four sums against the full-width diagnostics at c = 1,
    2 and 8, and a non-divisor refused."""
    j, t, host = _state(n=200, d=16, chain=CHAIN)
    _, ht = _jt(host)
    Ustar = ht["Y"] * 0.9
    full = (treceipts.deltaH_trace(t["g"], t["pg"], ht["U"], Ustar, t["lam"], ht["B"]),
            *(x.sum() for x in treceipts.per_node_components(t["g"], ht["Y"], Ustar, t["lam"],
                                                             ht["B"], ht["psi"])))
    for c in (1, 2, 8):
        got = treceipts.receipt_full_chunked(t["g"], t["pg"], ht["U"], Ustar, t["lam"], ht["B"],
                                             ht["Y"], ht["psi"], c)
        for a, b in zip(got, full):
            assert float(a) == pytest.approx(float(b), rel=1e-5)
    with pytest.raises(ValueError, match="must divide"):
        treceipts.receipt_full_chunked(t["g"], None, ht["U"], Ustar, t["lam"], ht["B"],
                                       ht["Y"], ht["psi"], 3)
