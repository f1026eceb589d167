"""The windowed solve tier of the PyTorch port against the JAX package's.

Both packages run on the CPU.  The JAX package's windowed operator composes
its kernel K2 with an XLA straggler scatter there; the port routes
D % 128 == 0 to the plain versions of K3/K4 and any other D to K2 plus its
epilogue.  Every route takes the same bf16-rounded operands and sums exact
products in f32, so only the order of summation differs, and the bars are
the lattice's own: deltaH within 1e-5 relative, the same null-point count,
bundle ids, state signature, CG iteration counts and window precision tier.
Solves run on a JAX window context carried across must stop after the same
number of iterations with U within 1e-5 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.core.lattice import _jit_locality_order  # noqa: E402
from oscillink_tpu.models import coherence as jcoh  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.core.lattice import _locality_order  # noqa: E402
from oscillink_tpu_torch.models import coherence as tcoh  # noqa: E402
from oscillink_tpu_torch.ops.kernels import window_spmv as tw  # noqa: E402

LAMS = (1.0, 0.5, 4.0, 0.0)


def _clustered(n, d, seed=0, n_centers=16, noise=0.35):
    """Gaussian centres plus per-row noise, rows in random order (the
    generator of benchmarks/probe_e2e_settle_dma16.py).  The corpus of
    tests/test_fused_windowed.py (centres 4x farther out, noise 0.25) is not
    used: its rows sit far from the origin, and the two packages' f32
    similarities, rounded differently, flip about 1 % of its near-tied
    neighbour lists, so the graphs differ before any solve runs."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    assign = rng.integers(0, n_centers, size=n)
    return (centers[assign] + noise * rng.standard_normal((n, d))).astype(np.float32)


def _psi(Y):
    m = Y[:40].mean(0)
    return (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _windowed_pair(monkeypatch, n, d, seed, fused="1", chain=None, n_centers=16, noise=0.35,
                   **kw):
    monkeypatch.setenv("OSCILLINK_WINDOWED_MATVEC", "1")
    monkeypatch.setenv("OSCILLINK_WINDOWED_FUSED", fused)
    Y = _clustered(n, d, seed=seed, n_centers=n_centers, noise=noise)
    lj = ot.Oscillink(Y, kneighbors=6, **kw)
    lt = pt.Oscillink(Y, kneighbors=6, device="cpu", **kw)
    # the same graph first: the windowed tier is what these tests compare
    np.testing.assert_array_equal(lt.graph.idx.numpy(), np.asarray(lj._graph.idx))
    np.testing.assert_allclose(lt.graph.wn.numpy(), np.asarray(lj._graph.wn), rtol=1e-5, atol=1e-7)
    assert lj._window_ctx is not None and lt._window_ctx is not None
    for lat in (lj, lt):
        lat.set_query(_psi(Y))
        if chain is not None:
            lat.add_chain(chain, lamP=0.2)
    return lj, lt


def _assert_lattices_agree(lj, lt, settle_kw):
    sj, st_ = lj.settle(**settle_kw), lt.settle(**settle_kw)
    assert int(st_["iters"]) == int(sj["iters"])
    rj, rt = lj.receipt(), lt.receipt()
    assert _rel(rt["deltaH_total"], rj["deltaH_total"]) <= 1e-5
    assert len(rt["null_points"]) == len(rj["null_points"])
    assert rt["meta"]["state_sig"] == rj["meta"]["state_sig"]
    assert rt["meta"]["ustar_iters"] == rj["meta"]["ustar_iters"]
    assert rt["meta"].get("window_precision") == rj["meta"].get("window_precision")
    assert [b["id"] for b in lt.bundle(k=6)] == [b["id"] for b in lj.bundle(k=6)]
    np.testing.assert_allclose(lt.U, lj.U, rtol=1e-5, atol=1e-5)
    return rt


@pytest.mark.parametrize("n,d,seed", [(1400, 64, 0), (1000, 200, 7)])
def test_locality_order_matches_jax(n, d, seed):
    Y = _clustered(n, d, seed=seed)
    oj, ij = _jit_locality_order(jnp.asarray(Y))
    ot_, it_ = _locality_order(torch.from_numpy(Y))
    assert ot_.dtype == it_.dtype == torch.int32
    np.testing.assert_array_equal(ot_.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(it_.numpy(), np.asarray(ij))


def _carried_ctx(lj):
    """The JAX lattice's window context, carried across as tensors."""
    cj = lj._window_ctx
    s_max = int(cj.oh.strag.shape[1])
    plan = interop.window_plan_from_numpy(
        *(np.asarray(getattr(cj.plan, f)) for f in cj.plan._fields), W=384, s_max=s_max,
        device="cpu",
    )
    oh = interop.onehots_from_numpy(np.asarray(cj.oh.main), np.asarray(cj.oh.strag), device="cpu")
    return tcoh.WindowCtx(
        plan=plan, order=torch.from_numpy(np.asarray(cj.order)),
        inv_order=torch.from_numpy(np.asarray(cj.inv_order)), W=384, s_max=s_max, oh=oh,
    )


@pytest.mark.parametrize("d", [128, 40])  # K3/K4 route; K2 + epilogue route
@pytest.mark.parametrize("fused", [True, False])
def test_windowed_solves_on_a_jax_ctx_match_jax(monkeypatch, d, fused):
    monkeypatch.setenv("OSCILLINK_WINDOWED_MATVEC", "1")
    n = 1300
    Y = _clustered(n, d, seed=d)
    lj = ot.Oscillink(Y, kneighbors=6)
    ctx_t = _carried_ctx(lj)
    rng = np.random.default_rng(1)
    U = (Y + 0.3 * rng.standard_normal(Y.shape)).astype(np.float32)
    psi = _psi(Y)
    B = (0.5 + rng.random(n)).astype(np.float32)
    lam_j = jcoh.EnergyParams.make(*LAMS)
    lam_t = interop.energy_from_numpy(*LAMS, device="cpu")
    jy, jpsi, jb = jnp.asarray(Y), jnp.asarray(psi), jnp.asarray(B)
    ty, tpsi, tb = (torch.from_numpy(a) for a in (Y, psi, B))
    solve_j = jcoh.solve_stationary_windowed_fused if fused else jcoh.solve_stationary_windowed
    solve_t = tcoh.solve_stationary_windowed_fused if fused else tcoh.solve_stationary_windowed
    Uj, itj, _ = solve_j(lj._window_ctx, jy, jpsi, jb, lam_j, tol=1e-5, max_iters=100)
    Ut, itt, _ = solve_t(ctx_t, ty, tpsi, tb, lam_t, tol=1e-5, max_iters=100)
    assert itt == int(itj)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=1e-5, atol=1e-5 * np.abs(Uj).max())
    step_j = jcoh.settle_step_windowed_fused if fused else jcoh.settle_step_windowed
    step_t = tcoh.settle_step_windowed_fused if fused else tcoh.settle_step_windowed
    for dt, jac in ((1.0, True), (0.5, False)):
        Uj, itj, _ = step_j(lj._window_ctx, jnp.asarray(U), jy, jpsi, jb, lam_j, dt=dt,
                            tol=1e-4, max_iters=40, use_jacobi=jac)
        Ut, itt, _ = step_t(ctx_t, torch.from_numpy(U), ty, tpsi, tb, lam_t, dt=dt,
                            tol=1e-4, max_iters=40, use_jacobi=jac)
        assert itt == int(itj)
        np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=1e-5,
                                   atol=1e-5 * np.abs(Uj).max())


def test_cpu_lattice_builds_its_onehot_and_the_ctx_carries_W_and_s_max(monkeypatch):
    """The context carries the geometry the kernels take (W, s_max); the
    one-hots are built on the CPU only, for its one-hot plain versions, and
    without them the CPU route refuses to solve."""
    monkeypatch.setenv("OSCILLINK_WINDOWED_MATVEC", "1")
    Y = _clustered(1400, 64, seed=0)
    lt = pt.Oscillink(Y, kneighbors=6, device="cpu")
    events = []
    lt.set_logger(lambda ev, p: events.append((ev, p)))
    lt._maybe_build_window_ctx()
    ctx = lt._window_ctx
    assert events[-1][0] == "window_ctx" and ctx.s_max == events[-1][1]["s_max"] == 384
    assert ctx.W == 384 and ctx.oh is not None
    want = tw.build_onehot(ctx.plan, ctx.W, ctx.s_max)
    assert torch.equal(ctx.oh.main, want.main) and torch.equal(ctx.oh.strag, want.strag)
    assert ctx.oh.strag.shape == (ctx.plan.n_pad, ctx.s_max)
    lam = interop.energy_from_numpy(*LAMS, device="cpu")
    ty, psi = torch.from_numpy(Y), torch.from_numpy(_psi(Y))
    B = torch.ones(Y.shape[0])
    for solve in (tcoh.solve_stationary_windowed, tcoh.solve_stationary_windowed_fused):
        with pytest.raises(ValueError, match="one-hot plain versions"):
            solve(ctx._replace(oh=None), ty, psi, B, lam, max_iters=2)


@pytest.mark.parametrize("col_chunks,fused", [("2", "1"), ("2", "0"), ("4", "1")])
def test_chunked_windowed_lattice_matches_jax(monkeypatch, col_chunks, fused):
    """A forced window context under OSCILLINK_COL_CHUNKS solves chunked in
    both packages: at D = 256, chunks of 128 take the K4 (fused) or K3
    plain paths and chunks of 64 take K2 and its epilogue.  The settle, U*
    and the chunked receipt meet the lattice bars."""
    monkeypatch.setenv("OSCILLINK_COL_CHUNKS", col_chunks)
    lj, lt = _windowed_pair(monkeypatch, 1200, 256, 5, fused=fused)
    assert lt._window_fullwidth is False and lj._window_fullwidth is False
    assert lt._graph_snapshot()["window_fullwidth"] is False
    widths = []
    for name in ("settle_step_windowed", "settle_step_windowed_fused",
                 "solve_stationary_windowed", "solve_stationary_windowed_fused"):
        orig = getattr(tcoh, name)

        def spy(ctx, *a, _orig=orig, _name=name, **kw):
            widths.append((_name.endswith("fused"), a[0].shape[1]))
            return _orig(ctx, *a, **kw)

        monkeypatch.setattr(tcoh, name, spy)
    _assert_lattices_agree(lj, lt, dict(max_iters=16, tol=1e-4))
    c = int(col_chunks)
    assert widths == [(fused == "1", 256 // c)] * (2 * c)


@pytest.mark.parametrize("seed", [0, 3])
def test_fused_windowed_lattice_matches_jax(monkeypatch, seed):
    lj, lt = _windowed_pair(monkeypatch, 1400, 128, seed)
    rt = _assert_lattices_agree(lj, lt, dict(max_iters=16, tol=1e-4))
    assert rt["meta"]["window_precision"] == "bf16x3"


def test_fused_windowed_lattice_dma16_matches_jax(monkeypatch):
    monkeypatch.setenv("OSCILLINK_WINDOW_PRECISION", "dma16")
    lj, lt = _windowed_pair(monkeypatch, 1400, 128, 1)
    assert lt._window_ctx.oh.main.dtype == torch.bfloat16
    rt = _assert_lattices_agree(lj, lt, dict(max_iters=16, tol=1e-4))
    assert rt["meta"]["window_precision"] == "dma16"


def test_unfused_windowed_lattice_matches_jax(monkeypatch):
    lj, lt = _windowed_pair(monkeypatch, 1400, 128, 2, fused="0")
    _assert_lattices_agree(lj, lt, dict(max_iters=16, tol=1e-4))


def test_lamC_zero_routes_unfused_and_matches_jax(monkeypatch):
    lj, lt = _windowed_pair(monkeypatch, 1200, 128, 5, lamC=0.0)
    launches = []
    orig = tcoh.settle_step_windowed

    def spy(*a, **kw):
        launches.append("unfused")
        return orig(*a, **kw)

    monkeypatch.setattr("oscillink_tpu_torch.core.lattice.settle_step_windowed", spy)
    # tol 1e-3: with lamC = 0 the Jacobi-preconditioned system is diagonal,
    # one iteration solves it and what is left is rounding, far below 1e-3
    _assert_lattices_agree(lj, lt, dict(max_iters=12, tol=1e-3))
    assert launches == ["unfused"]


@pytest.mark.parametrize("fused", ["1", "0"])
def test_narrow_d_windowed_lattice_matches_jax(monkeypatch, fused):
    lj, lt = _windowed_pair(monkeypatch, 1300, 97, 4, fused=fused)
    _assert_lattices_agree(lj, lt, dict(max_iters=16, tol=1e-4))


def test_chain_prior_takes_the_gather_path(monkeypatch):
    lj, lt = _windowed_pair(monkeypatch, 1000, 128, 6, chain=[1, 5, 9, 40])

    def refuse(*a, **kw):
        raise AssertionError("a lattice with a chain prior solved on the windowed path")

    for name in ("settle_step_windowed", "settle_step_windowed_fused",
                 "solve_stationary_windowed", "solve_stationary_windowed_fused"):
        monkeypatch.setattr(f"oscillink_tpu_torch.core.lattice.{name}", refuse)
    _assert_lattices_agree(lj, lt, dict(max_iters=16, tol=1e-4))
    assert lt.chain_receipt([1, 5, 9, 40])["verdict"] == lj.chain_receipt([1, 5, 9, 40])["verdict"]


def test_window_ctx_events_and_plan_match_jax(monkeypatch):
    lj, lt = _windowed_pair(monkeypatch, 1400, 64, 0)
    events = {"jax": [], "torch": []}
    lj.set_logger(lambda ev, p: events["jax"].append((ev, p)))
    lt.set_logger(lambda ev, p: events["torch"].append((ev, p)))
    lj._maybe_build_window_ctx()
    lt._maybe_build_window_ctx()
    (ev_j, pj), (ev_t, p_t) = events["jax"][-1], events["torch"][-1]
    assert ev_j == ev_t == "window_ctx"
    assert set(p_t) == set(pj)
    assert p_t == {**pj, "n_pad": int(pj["n_pad"])}
    assert lt._window_coverage == lj._window_coverage
    cj, ct = lj._window_ctx, lt._window_ctx
    np.testing.assert_array_equal(ct.order.numpy(), np.asarray(cj.order))
    for name in ("cs", "idxl", "strag_dst", "strag_src", "strag_off", "strag_cnt"):
        np.testing.assert_array_equal(
            getattr(ct.plan, name).numpy(), np.asarray(getattr(cj.plan, name)), err_msg=name
        )
    assert ct.oh.strag.shape == cj.oh.strag.shape and ct.oh.main.shape == cj.oh.main.shape


@pytest.mark.parametrize("fused", ["1", "0"])
def test_low_coverage_windowed_lattice_matches_jax(monkeypatch, fused):
    """Stragglers in most row blocks, through the low-coverage retry: the
    straggler correction of K4 (fused) and K3 (unfused) at the lattice.  The
    retry's bound is set, since the two packages' defaults differ (the JAX
    package's 768; the port's 0, read on the card, turns the retry off)."""
    monkeypatch.setenv("OSCILLINK_WINDOWED_LOWCOV_SMAX", "768")
    lj, lt = _windowed_pair(monkeypatch, 3000, 128, 0, fused=fused, n_centers=64, noise=1.0)
    ct = lt._window_ctx
    assert lt._window_coverage < 0.85 and ct.oh.strag.shape[1] == ct.s_max == 768
    assert int(torch.count_nonzero(ct.plan.strag_cnt)) >= ct.plan.n_blocks - 1
    _assert_lattices_agree(lj, lt, dict(max_iters=16, tol=1e-4))


def test_low_coverage_retry_and_overflow_match_jax(monkeypatch):
    """A noisy corpus (64 centres, noise 1.0, coverage about 0.65): the first
    plan overflows, the retry with the low-coverage bound's straggler window
    accepts it, and with the retry disabled both packages refuse it."""
    monkeypatch.setenv("OSCILLINK_WINDOWED_MATVEC", "1")
    Y = _clustered(4096, 16, seed=0, n_centers=64, noise=1.0)
    for bound, s_max in (("768", 768), ("0", None)):
        monkeypatch.setenv("OSCILLINK_WINDOWED_LOWCOV_SMAX", bound)
        lj = ot.Oscillink(Y, kneighbors=6)
        lt = pt.Oscillink(Y, kneighbors=6, device="cpu")
        assert lt._window_coverage == lj._window_coverage < 0.7
        events = []
        lt.set_logger(lambda ev, p: events.append((ev, p)))
        lt._maybe_build_window_ctx()
        ev, payload = events[-1]
        if s_max is None:
            assert lj._window_ctx is None and lt._window_ctx is None
            assert ev == "window_ctx_skipped" and payload["reason"] == "straggler overflow"
            assert set(payload) == {"coverage", "stragglers", "s_max", "reason"}
            continue
        assert ev == "window_ctx" and payload["s_max"] == s_max
        cj, ct = lj._window_ctx, lt._window_ctx
        assert ct.oh.strag.shape == cj.oh.strag.shape == (4224, s_max)
        # right-sized straggler arrays: the same length in both packages
        for name in ("strag_dst", "strag_src", "strag_off", "strag_cnt"):
            np.testing.assert_array_equal(
                getattr(ct.plan, name).numpy(), np.asarray(getattr(cj.plan, name)), err_msg=name
            )


@pytest.mark.parametrize("fused", ["1", "0"])
def test_windowed_lattice_on_the_jax_graph_matches_jax(monkeypatch, fused):
    """The corpus of tests/test_fused_windowed.py, whose near-tied neighbour
    lists the two packages' builds order differently: handed the JAX graph
    (``graph=``), the port's windowed lattice meets the lattice bars."""
    monkeypatch.setenv("OSCILLINK_WINDOWED_MATVEC", "1")
    monkeypatch.setenv("OSCILLINK_WINDOWED_FUSED", fused)
    rng = np.random.default_rng(0)
    centers = 4.0 * rng.standard_normal((8, 128)).astype(np.float32)
    lbl = np.sort(rng.integers(0, 8, size=1400))
    Y = (centers[lbl] + 0.25 * rng.standard_normal((1400, 128))).astype(np.float32)
    Y = Y[np.random.default_rng(1).permutation(1400)]
    lj = ot.Oscillink(Y, kneighbors=6)
    gj = lj._graph
    graph = interop.graph_from_numpy(gj.idx, gj.w, gj.wn, gj.sqrt_deg, device="cpu")
    lt = pt.Oscillink(Y, kneighbors=6, device="cpu", graph=graph)
    assert (pt.Oscillink(Y, kneighbors=6, device="cpu").graph.idx != graph.idx).any()
    assert torch.equal(lt.graph.idx, graph.idx) and lt._window_ctx is not None
    np.testing.assert_array_equal(lt._window_ctx.plan.cs.numpy(), np.asarray(lj._window_ctx.plan.cs))
    for lat in (lj, lt):
        lat.set_query(_psi(Y))
    _assert_lattices_agree(lj, lt, dict(max_iters=16, tol=1e-4))


def test_lattice_refuses_a_graph_of_another_shape():
    Y = _clustered(300, 16, seed=1)
    g = pt.Oscillink(Y, kneighbors=6, device="cpu").graph
    with pytest.raises(ValueError, match=r"\[N, k\]"):
        pt.Oscillink(Y, kneighbors=5, device="cpu", graph=g)
    with pytest.raises(ValueError, match=r"\[N, k\]"):
        pt.Oscillink(Y[:299], kneighbors=6, device="cpu", graph=g)
    bad = g._replace(idx=g.idx.clone())
    bad.idx[3, 2] = 300
    with pytest.raises(ValueError, match=r"\[0, N\)"):
        pt.Oscillink(Y, kneighbors=6, device="cpu", graph=bad)
