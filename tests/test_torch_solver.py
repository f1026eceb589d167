"""CG (classic and `cg_solve_kpap`), stationary solve and settle step of the
PyTorch port against the JAX package.

Both packages run on the same graph (built by the JAX package, carried
across with ``oscillink_tpu_torch.interop``) and the same numpy inputs.  The
port must stop after the same number of CG iterations and reach U within
1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscillink_tpu.models import coherence as jcoh  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jbuild_graph  # noqa: E402
from oscillink_tpu.ops.path import build_path_graph as jbuild_path  # noqa: E402
from oscillink_tpu.ops.solver import cg_solve as jcg_solve  # noqa: E402
from oscillink_tpu.ops.solver import cg_solve_kpap as jcg_solve_kpap  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.models import coherence as tcoh  # noqa: E402
from oscillink_tpu_torch.ops.path import build_path_graph as tbuild_path  # noqa: E402
from oscillink_tpu_torch.ops.solver import cg_solve as tcg_solve  # noqa: E402
from oscillink_tpu_torch.ops.solver import cg_solve_kpap as tcg_solve_kpap  # noqa: E402

LAMS = (1.0, 0.5, 4.0, 0.2)


def _state(n=400, d=24, k=6, seed=0, chain=None):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    U = (Y + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    B = (0.5 + rng.random(n)).astype(np.float32)
    gj = jax.jit(lambda Y: jbuild_graph(Y, k))(jnp.asarray(Y))
    gt = interop.graph_from_numpy(
        *(np.asarray(a) for a in (gj.idx, gj.w, gj.wn, gj.sqrt_deg)), device="cpu"
    )
    pj = pt = None
    if chain is not None:
        pj = jbuild_path(n, chain)
        pt = interop.path_from_numpy(
            *(np.asarray(a) for a in (pj.src, pj.dst, pj.w, pj.wn, pj.sqrt_deg)), device="cpu"
        )
    lam_j = jcoh.EnergyParams.make(*LAMS)
    lam_t = interop.energy_from_numpy(*LAMS, device="cpu")
    host = dict(Y=Y, U=U, psi=psi, B=B)
    return gj, gt, pj, pt, lam_j, lam_t, host


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("chain", [None, [2, 5, 7, 9, 5]])
@pytest.mark.parametrize("tol,max_iters", [(1e-4, 64), (1e-6, 200), (1e-2, 3)])
def test_solve_stationary_matches_jax(chain, tol, max_iters):
    gj, gt, pj, pt, lam_j, lam_t, h = _state(chain=chain)
    Uj, itj, resj = jcoh.solve_stationary(
        gj, pj, jnp.asarray(h["Y"]), jnp.asarray(h["psi"]), jnp.asarray(h["B"]), lam_j,
        tol=tol, max_iters=max_iters,
    )
    Ut, itt, rest = tcoh.solve_stationary(
        gt, pt, _t(h["Y"]), _t(h["psi"]), _t(h["B"]), lam_t, tol=tol, max_iters=max_iters
    )
    assert itt == int(itj)
    np.testing.assert_allclose(rest, float(resj), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chain", [None, [10, 3, 77]])
@pytest.mark.parametrize("dt,use_jacobi", [(1.0, True), (0.25, True), (1.0, False)])
def test_settle_step_matches_jax(chain, dt, use_jacobi):
    gj, gt, pj, pt, lam_j, lam_t, h = _state(seed=1, chain=chain)
    Uj, itj, _ = jcoh.settle_step(
        gj, pj, jnp.asarray(h["U"]), jnp.asarray(h["Y"]), jnp.asarray(h["psi"]),
        jnp.asarray(h["B"]), lam_j, dt=dt, tol=1e-4, max_iters=40, use_jacobi=use_jacobi,
    )
    Ut, itt, _ = tcoh.settle_step(
        gt, pt, _t(h["U"]), _t(h["Y"]), _t(h["psi"]), _t(h["B"]), lam_t,
        dt=dt, tol=1e-4, max_iters=40, use_jacobi=use_jacobi,
    )
    assert itt == int(itj)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=1e-5, atol=1e-5)


def test_cg_solve_matches_jax_on_shared_operator():
    gj, gt, _, _, lam_j, lam_t, h = _state(seed=2)
    Bj, Bt = jnp.asarray(h["B"]), _t(h["B"])
    b = h["U"]
    diag = (1.0 + h["B"]).astype(np.float32)
    xj, itj, resj = jcg_solve(
        lambda X: jcoh.stationary_matvec(gj, None, lam_j, Bj, X), jnp.asarray(b),
        M_diag=jnp.asarray(diag), tol=1e-5, max_iters=100,
    )
    xt, itt, rest = tcg_solve(
        lambda X: tcoh.stationary_matvec(gt, None, lam_t, Bt, X), _t(b),
        M_diag=_t(diag), tol=1e-5, max_iters=100,
    )
    assert itt == int(itj) and rest <= 1e-5
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)


def test_cg_solve_vector_rhs_and_at_least_one_iteration():
    A = torch.diag(torch.tensor([2.0, 3.0, 4.0]))
    b = torch.tensor([1.0, 1.0, 1.0])
    # exact start: the residual is already 0, yet one iteration still runs
    x, it, res = tcg_solve(lambda X: A @ X, b, x0=torch.tensor([0.5, 1 / 3, 0.25]), tol=1.0)
    assert x.shape == (3,) and it == 1 and res <= 1e-6
    x, it, _ = tcg_solve(lambda X: A @ X, b, tol=1e-8, max_iters=2)
    assert it == 2
    x, it, _ = tcg_solve(lambda X: A @ X, b, M_diag=torch.diagonal(A), tol=1e-7)
    np.testing.assert_allclose(x.numpy(), [0.5, 1 / 3, 0.25], rtol=1e-6)


def test_stationary_matvec_and_query_rhs_match_jax():
    gj, gt, pj, pt, lam_j, lam_t, h = _state(seed=3, chain=[1, 2, 3])
    X = np.random.default_rng(9).standard_normal(h["Y"].shape).astype(np.float32)
    mj = jcoh.stationary_matvec(gj, pj, lam_j, jnp.asarray(h["B"]), jnp.asarray(X))
    mt = tcoh.stationary_matvec(gt, pt, lam_t, _t(h["B"]), _t(X))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-5)
    rj = jcoh.query_rhs(lam_j, jnp.asarray(h["Y"]), jnp.asarray(h["psi"]), jnp.asarray(h["B"]))
    rt = tcoh.query_rhs(lam_t, _t(h["Y"]), _t(h["psi"]), _t(h["B"]))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "chain,weights", [([0, 4, 2, 9], None), ([3, 3, 8, 1, 3], [0.5, 2.0, 1.0, 0.7]), ([5, 99], None)]
)
def test_path_graph_matches_jax(chain, weights):
    pj = jbuild_path(20, chain, weights)
    pt = tbuild_path(20, chain, weights, device=torch.device("cpu"))
    for name in ("src", "dst", "w", "wn", "sqrt_deg"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)))
    X = np.random.default_rng(0).standard_normal((20, 5)).astype(np.float32)
    from oscillink_tpu.ops.path import path_lap_matvec as jpath_mv
    from oscillink_tpu_torch.ops.path import path_lap_matvec as tpath_mv

    np.testing.assert_allclose(
        tpath_mv(pt, _t(X)).numpy(), np.asarray(jpath_mv(pj, jnp.asarray(X))), rtol=1e-6, atol=1e-6
    )


def _dense_spd(seed=1, n=96, d=8):
    """tests/test_fused_windowed.py's dense SPD system A = Q Q^T / n + 2 I."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n)).astype(np.float32)
    A = (Q @ Q.T / n + 2.0 * np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, d)).astype(np.float32)
    x0 = rng.standard_normal((n, d)).astype(np.float32)
    return A, b, x0


@pytest.mark.parametrize("tol,max_iters", [(1e-5, 80), (1e-3, 80), (1e-6, 4)])
@pytest.mark.parametrize("jacobi,warm", [(True, False), (False, True)])
def test_cg_solve_kpap_matches_jax(tol, max_iters, jacobi, warm):
    """A = s K with the operator's own denominator: the same iteration count
    as the JAX package's cg_solve_kpap, x within 1e-5."""
    A, b, x0 = _dense_spd()
    s = 0.7
    M = np.diag(A).copy() if jacobi else None
    Aj, At = jnp.asarray(A), _t(A)

    def kj(x):
        kx = (Aj @ x) * (1.0 / s)
        return kx, jnp.sum(x * kx, axis=0)

    def kt(x):
        kx = (At @ x) * (1.0 / s)
        return kx, torch.sum(x * kx, dim=0)

    xj, itj, resj = jcg_solve_kpap(
        kj, s, jnp.asarray(b), x0=jnp.asarray(x0) if warm else None,
        M_diag=None if M is None else jnp.asarray(M), tol=tol, max_iters=max_iters,
    )
    xt, itt, rest = tcg_solve_kpap(
        kt, s, _t(b), x0=_t(x0) if warm else None, M_diag=None if M is None else _t(M),
        tol=tol, max_iters=max_iters,
    )
    assert itt == int(itj)
    np.testing.assert_allclose(rest, float(resj), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)


def test_cg_solve_kpap_scales_only_the_scalars():
    """The initial residual is b - (K x0) s; inside the loop s scales the
    scalars.  At least one iteration runs from an exact start, and the
    solution is that of cg_solve on A = s K."""
    A, b, _ = _dense_spd(seed=2, n=40, d=3)
    s = 2.5
    At = _t(A)
    seen = []

    def kt(x):
        seen.append(x.clone())
        kx = (At @ x) / s
        return kx, torch.sum(x * kx, dim=0)

    exact = torch.linalg.solve(At.double(), _t(b).double()).float()
    x, it, res = tcg_solve_kpap(kt, s, _t(b), x0=exact, tol=1.0)
    assert it == 1 and res <= 1e-4 and len(seen) == 2
    assert torch.equal(seen[0], exact)
    x_kpap, it_kpap, _ = tcg_solve_kpap(kt, s, _t(b), M_diag=torch.diagonal(At), tol=1e-6)
    x_cg, it_cg, _ = tcg_solve(lambda X: At @ X, _t(b), M_diag=torch.diagonal(At), tol=1e-6)
    assert abs(it_kpap - it_cg) <= 1
    np.testing.assert_allclose(x_kpap.numpy(), x_cg.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(x_kpap.numpy(), exact.numpy(), rtol=1e-4, atol=1e-5)


# -- cg_solve_lanes: the port of a vmapped cg_solve ----------------------------


def _lane_system(n=300, d=128, lanes=4, seed=4):
    """One graph, ``lanes`` stationary systems whose gates differ, so the
    lanes stop at different iteration counts."""
    gj, gt, _, _, lam_j, lam_t, h = _state(n=n, d=d, seed=seed)
    rng = np.random.default_rng(seed + 100)
    B = rng.random((lanes, n)).astype(np.float32)
    B[1] = 1.0
    B[2] = 0.0
    b = rng.standard_normal((n, lanes, d)).astype(np.float32)
    return gj, gt, lam_j, lam_t, h["Y"], B, b


def _lane_operator(gt, lam_t, B, row_dim):
    from oscillink_tpu_torch.models.batched import lanes_lap_matvec, union_graph

    n = B.shape[1]
    if row_dim == 0:
        Bl, g = _t(B).T.reshape(n, -1, 1), gt
    else:
        Bl, g = _t(B)[:, :, None], union_graph([gt] * B.shape[0])

    def A(X):
        return lam_t.lamG * X + lam_t.lamC * lanes_lap_matvec(g, X, row_dim) + lam_t.lamQ * (Bl * X)

    return A, lam_t.lamG + lam_t.lamQ * Bl


@pytest.mark.parametrize("row_dim", [0, 1])
def test_cg_solve_lanes_freezes_each_lane_at_its_single_solve(row_dim):
    """Lanes that stop at different counts give, lane by lane, the iterations
    and the bits of a single cg_solve on that lane's system; the stopped
    lanes are frozen, not run on to the slowest lane's count."""
    from oscillink_tpu_torch.ops.solver import cg_solve_lanes

    gj, gt, _, lam_t, Y, B, b = _lane_system()
    A, M = _lane_operator(gt, lam_t, B, row_dim)
    lanes = B.shape[0]
    bb = _t(b) if row_dim == 0 else _t(b).permute(1, 0, 2).contiguous()
    x0 = _t(Y)[:, None, :].expand_as(bb) if row_dim == 0 else _t(Y)[None].expand_as(bb)
    x, its, res = cg_solve_lanes(A, bb, x0=x0, M_diag=M, tol=1e-4, max_iters=64, row_dim=row_dim)
    assert its.shape == (lanes,) and res.shape == (lanes,) and len(set(its.tolist())) > 1
    for q in range(lanes):
        Bq = _t(B[q])
        xs, its1, res1 = tcg_solve(
            lambda X: tcoh.stationary_matvec(gt, None, lam_t, Bq, X), _t(b[:, q]).contiguous(),
            x0=_t(Y), M_diag=lam_t.lamG + lam_t.lamQ * Bq, tol=1e-4, max_iters=64,
        )
        xq = x[:, q] if row_dim == 0 else x[q]
        assert its[q] == its1 and res[q] == np.float32(res1)
        assert torch.equal(xq, xs), q


@pytest.mark.parametrize("row_dim", [0, 1])
@pytest.mark.parametrize("d,tol,max_iters", [(24, 1e-4, 64), (24, 1e-6, 9), (1, 1e-5, 100)])
def test_cg_solve_lanes_matches_vmapped_jax(row_dim, d, tol, max_iters):
    """Per-lane iterations equal those of jax.vmap over the JAX cg_solve;
    x within 1e-5."""
    gj, gt, lam_j, lam_t, Y, B, b = _lane_system(d=d, seed=5)
    Bj = jnp.asarray(B)

    def one(Bq, bq):
        return jcg_solve(lambda X: jcoh.stationary_matvec(gj, None, lam_j, Bq, X), bq,
                         x0=jnp.asarray(Y), M_diag=lam_j.lamG + lam_j.lamQ * Bq, tol=tol,
                         max_iters=max_iters)

    xj, itj, _ = jax.jit(jax.vmap(one, in_axes=(0, 1)))(Bj, jnp.asarray(b))
    A, M = _lane_operator(gt, lam_t, B, row_dim)
    from oscillink_tpu_torch.ops.solver import cg_solve_lanes

    bb = _t(b) if row_dim == 0 else _t(b).permute(1, 0, 2).contiguous()
    x0 = _t(Y)[:, None, :].expand_as(bb) if row_dim == 0 else _t(Y)[None].expand_as(bb)
    x, its, _ = cg_solve_lanes(A, bb, x0=x0, M_diag=M, tol=tol, max_iters=max_iters,
                               row_dim=row_dim)
    np.testing.assert_array_equal(its, np.asarray(itj))
    xt = x.permute(1, 0, 2) if row_dim == 0 else x
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)


def test_cg_solve_lanes_at_least_one_iteration_and_bad_layouts():
    from oscillink_tpu_torch.ops.solver import cg_solve_lanes

    A = torch.tensor([2.0, 3.0, 4.0])[:, None, None]
    b = torch.ones(3, 2, 1)
    x0 = (1.0 / A).expand(3, 2, 1)
    # an exact start: every lane still runs one iteration
    x, its, res = cg_solve_lanes(lambda X: A * X, b, x0=x0, tol=1.0, row_dim=0)
    assert its.tolist() == [1, 1] and float(res.max()) <= 1e-6
    _, its, _ = cg_solve_lanes(lambda X: A * X, b, tol=1e-12, max_iters=2, row_dim=0)
    assert its.tolist() == [2, 2]
    # a 2-D block is one lane, with its rows first
    _, its, _ = cg_solve_lanes(lambda X: A[:, 0] * X, b[:, :, 0], tol=1e-12, max_iters=2,
                               row_dim=0)
    assert its.tolist() == [2]
    for bad, row_dim in ((torch.ones(3), 0), (torch.ones(3, 2), 1), (b, 2),
                         (torch.ones(3, 2, 1, 1), 0)):
        with pytest.raises(ValueError):
            cg_solve_lanes(lambda X: X, bad, row_dim=row_dim)
