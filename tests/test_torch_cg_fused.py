"""The CG's fused passes (`oscillink_tpu_torch/ops/kernels/cg_fused.py`) and
the fused route of `cg_solve_lanes`, on the CPU, where the passes run their
plain twins.

The twins must give x, r, p and Ap as the classic expressions do, bit for
bit, and column sums that agree with float64 sums to rounding.  The fused
route must give the classic body's iterations and, on the CPU (whose twins
take the classic body's column sums), its bits; it must agree with the JAX
package's solves at tests/test_torch_solver.py's tolerances.  The kernels
run only on the card: chip_smoke.py's ``cg_fused`` phase holds them to
these twins there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscillink_tpu.models import coherence as jcoh  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jbuild_graph  # noqa: E402
from oscillink_tpu.ops.solver import cg_solve as jcg_solve  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.models import coherence as tcoh  # noqa: E402
from oscillink_tpu_torch.ops import solver as tsolver  # noqa: E402
from oscillink_tpu_torch.ops.graph import lap_matvec  # noqa: E402
from oscillink_tpu_torch.ops.kernels import cg_fused  # noqa: E402
from oscillink_tpu_torch.ops.path import build_path_graph as tbuild_path  # noqa: E402

LAMS = (1.0, 0.5, 4.0, 0.2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _graphs(Y: np.ndarray, k: int):
    gj = jax.jit(lambda Y: jbuild_graph(Y, k), static_argnums=())(jnp.asarray(Y))
    gt = interop.graph_from_numpy(
        *(np.asarray(a) for a in (gj.idx, gj.w, gj.wn, gj.sqrt_deg)), device="cpu")
    return gj, gt


def _system(n, d, k, seed):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    U = (Y + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    B = (0.5 + rng.random(n)).astype(np.float32)
    gj, gt = _graphs(Y, k)
    return gj, gt, dict(Y=Y, U=U, psi=psi, B=B)


def _blocks(n, d, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((n, d), generator=g) for _ in range(5)], g


def _f64_dot(a, b):
    return (a.reshape(a.shape[0], -1).double() * b.reshape(b.shape[0], -1).double()).sum(0)


def _ulp_close(a, b, rtol=2e-6):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=0)


@pytest.mark.parametrize("n,d", [(37, 768), (37, 97), (200, 1), (1, 8)])
@pytest.mark.parametrize("pre", [True, False])
def test_twins_are_the_classic_expressions(n, d, pre):
    """Each twin's Ap, r, p and x equal the classic expressions bit for bit
    (the operator's against `stationary_matvec` on a real graph); x_in is
    not written when x_out is another block; the column sums agree with
    float64 ones to rounding."""
    (p, b, x, r, _), gen = _blocks(n, d, seed=n + d)
    Y = torch.randn((n, 16), generator=gen)
    _, gt = _graphs(Y.numpy(), min(3, max(1, n - 1)))
    lam = tcoh.EnergyParams.make(*LAMS, device="cpu")
    B = torch.rand(n, generator=gen)
    inv_M = 1.0 / (lam.lamG + lam.lamQ * B + 1e-12) if pre else None
    z_of = (lambda t: t) if inv_M is None else (lambda t: t * inv_M[:, None])
    rz = torch.rand(d, generator=gen) + 0.5
    alpha, beta = torch.rand(d, generator=gen) * 0.1, torch.rand(d, generator=gen)

    for dt in (None, 0.25):
        L = lap_matvec(gt, p)
        Ap, pap = cg_fused.combine(p, L, lam, B, dt)
        want = tcoh.stationary_matvec(gt, None, lam, B, p)
        want = want if dt is None else p + dt * want
        assert Ap.data_ptr() == L.data_ptr() and torch.equal(Ap, want)
        _ulp_close(cg_fused.alpha(pap, rz), rz / (_f64_dot(p, Ap).float() + 1e-18))
        _ulp_close(cg_fused.alpha(cg_fused.dot(p, Ap), rz), cg_fused.alpha(pap, rz), rtol=0)

    r0, p0, prz = cg_fused.residual(b, Ap, inv_M)
    assert torch.equal(r0, b - Ap) and torch.equal(p0, z_of(b - Ap))
    assert p0.data_ptr() != r0.data_ptr() and r0.data_ptr() != Ap.data_ptr()
    _ulp_close(cg_fused.finish(prz)[0], _f64_dot(r0, p0).float())

    x_in, r1, x_out = x.clone(), r.clone(), torch.empty_like(x)
    prz, prr = cg_fused.update(x_in, x_out, r1, p, Ap, alpha, inv_M)
    assert torch.equal(x_in, x) and torch.equal(x_out, x + p * alpha)
    assert torch.equal(r1, r - Ap * alpha)
    for lanes in (1,) + ((3,) if d % 3 == 0 else ()):
        rz_n, be, res = cg_fused.finish(prz, rz, prr, lanes)
        want_rz = _f64_dot(r1, z_of(r1)).float()
        _ulp_close(rz_n, want_rz)
        assert torch.equal(be, rz_n / (rz + 1e-18))
        norms = _f64_dot(r1, r1).sqrt().float().view(lanes, -1)
        _ulp_close(res, norms.amax(1))
    x_same = x.clone()
    cg_fused.update(x_same, x_same, r.clone(), p, Ap, alpha, inv_M)
    assert torch.equal(x_same, x + p * alpha)

    p1 = p.clone()
    cg_fused.direction(p1, r1, beta, inv_M)
    assert torch.equal(p1, z_of(r1) + p * beta)


def test_finish_spreads_nan_and_sums_every_partial_row():
    """`finish` adds every row of a partials tensor (the kernels write one a
    stripe) and its residual is NaN where a lane's column is, as torch.amax
    gives it."""
    prz = torch.tensor([[1.0, 2.0, 3.0, 4.0], [0.5, 0.5, 0.5, 0.5], [0.25, 0, 0, 0]],
                       dtype=torch.float64)
    prr = torch.tensor([[9.0, 16.0, float("nan"), 1.0], [0.0, 0.0, 0.0, 0.0]],
                       dtype=torch.float64)
    rz_n, beta, res = cg_fused.finish(prz, torch.ones(4), prr, lanes=2)
    assert rz_n.tolist() == [1.75, 2.5, 3.5, 4.5]
    assert torch.equal(beta, rz_n / (torch.ones(4) + 1e-18))
    assert res[0].item() == 4.0 and np.isnan(res[1].item())
    assert cg_fused.finish(prz)[1:] == (None, None)
    np.testing.assert_allclose(cg_fused.alpha(prz, torch.ones(4)).numpy(),
                               1.0 / np.array([1.75, 2.5, 3.5, 4.5]), rtol=1e-7)


@pytest.mark.parametrize("n,c,v", [(171332, 768, 4), (522931, 768, 4), (500, 768, 4),
                                   (4099, 97, 1), (5000, 1, 1), (1, 8, 4), (7, 12, 4)])
def test_plan_covers_every_row_and_column(n, c, v):
    """The streaming passes' geometry: the stripes cover the rows exactly
    (none empty), a CTA's tile covers tx vector columns with tx a power of
    two up to 32, and the grid stays near `TARGET_CTAS`."""
    tx, rows, stripes = cg_fused.plan(n, c, v)
    assert stripes * rows >= n > (stripes - 1) * rows and stripes >= 1
    assert tx & (tx - 1) == 0 and 1 <= tx <= 32 and (tx >= c // v or tx == 32)
    tiles = -(-(c // v) // tx)
    assert stripes * tiles <= max(cg_fused.TARGET_CTAS, tiles)
    assert rows >= min(n, cg_fused.THREADS // tx)


def test_entry_points_refuse_other_devices_and_the_wrappers_cpu_tensors():
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cg_fused.dot(meta, meta)
    cpu = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        cg_fused._combine_cuda(cpu, cpu.clone(), None, None, None, 0)


def _classic(op, b, x0, diag, tol, max_iters):
    """The classic body on the same system: a one-lane lanes-first block
    (``row_dim=1``) keeps it."""
    n = b.shape[0]
    x, its, res = tsolver.cg_solve_lanes(
        lambda X: (lambda out: out[0] if isinstance(out, tuple) else out)(op(X.view(b.shape)))
        .view(1, *b.shape), b[None], x0=None if x0 is None else x0[None],
        M_diag=None if diag is None else diag.reshape(1, n, 1), tol=tol, max_iters=max_iters,
        row_dim=1)
    return x[0], int(its[0]), float(res[0])


@pytest.mark.parametrize("n,d,k", [(300, 768, 6), (120, 97, 4), (5, 768, 2), (1, 8, 1)])
@pytest.mark.parametrize("kind,jacobi", [("ustar", True), ("settle", True), ("settle", False)])
def test_fused_route_matches_jax_and_the_classic_body(n, d, k, kind, jacobi):
    """U* and a settle step (dt 0.5) through the fused route: the JAX
    package's iterations, U within 1e-5 (test_torch_solver.py's bars), and
    on the CPU the classic body's iterations, residual and bits; every
    iteration fused, none classic; the caller's blocks unwritten."""
    gj, gt, h = _system(n, d, k, seed=n + d)
    lam_j = jcoh.EnergyParams.make(*LAMS)
    lam_t = interop.energy_from_numpy(*LAMS, device="cpu")
    Y, U, psi, B = (_t(h[key]) for key in ("Y", "U", "psi", "B"))
    Y0, U0 = Y.clone(), U.clone()
    args_j = [jnp.asarray(h[key]) for key in ("Y", "psi", "B")]
    tsolver.fused_iterations = tsolver.classic_iterations = 0
    if kind == "ustar":
        Uj, itj, _ = jcoh.solve_stationary(gj, None, *args_j, lam_j, tol=1e-5, max_iters=80)
        Ut, itt, rest = tcoh.solve_stationary(gt, None, Y, psi, B, lam_t, tol=1e-5, max_iters=80)
        op = tcoh._gather_operator(gt, None, lam_t, B)
        rhs, x0, diag = tcoh.query_rhs(lam_t, Y, psi, B), Y, lam_t.lamG + lam_t.lamQ * B
        tol, iters = 1e-5, 80
    else:
        Uj, itj, _ = jcoh.settle_step(gj, None, jnp.asarray(h["U"]), *args_j, lam_j, dt=0.5,
                                      tol=1e-4, max_iters=40, use_jacobi=jacobi)
        Ut, itt, rest = tcoh.settle_step(gt, None, U, Y, psi, B, lam_t, dt=0.5, tol=1e-4,
                                         max_iters=40, use_jacobi=jacobi)
        op = tcoh._gather_operator(gt, None, lam_t, B, 0.5)
        rhs, x0 = U + 0.5 * tcoh.query_rhs(lam_t, Y, psi, B), U
        diag = tcoh._settle_diag(None, lam_t, B, 0.5) if jacobi else None
        tol, iters = 1e-4, 40
    assert tsolver.fused_iterations == itt and tsolver.classic_iterations == 0
    assert torch.equal(Y, Y0) and torch.equal(U, U0)
    assert itt == int(itj)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=1e-5, atol=1e-5)
    Uc, itc, resc = _classic(op, rhs, x0, diag, tol, iters)
    assert tsolver.classic_iterations == itc
    assert (itc, resc) == (itt, rest) and torch.equal(Uc, Ut)


def test_cg_solve_n1_and_plain_operator_match_jax():
    """One row, and an operator that returns a plain block (the dot pass),
    against the JAX cg_solve."""
    for n, d in ((1, 5), (3, 97)):
        rng = np.random.default_rng(n)
        a = (1.0 + rng.random((n, 1))).astype(np.float32)
        b = rng.standard_normal((n, d)).astype(np.float32)
        xj, itj, _ = jcg_solve(lambda X: jnp.asarray(a) * X, jnp.asarray(b),
                               M_diag=jnp.asarray(a[:, 0]), tol=1e-6, max_iters=10)
        tsolver.fused_iterations = 0
        xt, itt, _ = tsolver.cg_solve(lambda X: _t(a) * X, _t(b), M_diag=_t(a[:, 0]), tol=1e-6,
                                      max_iters=10)
        assert itt == int(itj) == tsolver.fused_iterations
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-6)


def test_counters_and_where_the_classic_body_stays(monkeypatch):
    """`fused_iterations` counts a qualifying block's iterations;
    `classic_iterations` a lanes-first layout's, a per-lane diagonal's, an
    iteration with a stopped lane and a float64 block's.  A chain prior's
    operator returns a plain block and takes the fused passes with the dot
    pass."""
    gj, gt, h = _system(80, 16, 4, seed=3)
    lam = interop.energy_from_numpy(*LAMS, device="cpu")
    Y, psi, B = (_t(h[key]) for key in ("Y", "psi", "B"))

    def counts(fn):
        tsolver.fused_iterations = tsolver.classic_iterations = 0
        out = fn()
        return out, tsolver.fused_iterations, tsolver.classic_iterations

    (_, it, _), fused, classic = counts(
        lambda: tcoh.solve_stationary(gt, None, Y, psi, B, lam, tol=1e-5))
    assert fused == it > 0 and classic == 0

    dots = []
    real_dot = cg_fused.dot
    monkeypatch.setattr(cg_fused, "dot", lambda p, Ap: dots.append(1) or real_dot(p, Ap))
    pt = tbuild_path(80, [2, 5, 7, 9], device=torch.device("cpu"))
    (_, it, _), fused, classic = counts(
        lambda: tcoh.solve_stationary(gt, pt, Y, psi, B, lam, tol=1e-5))
    assert fused == it == len(dots) > 0 and classic == 0
    monkeypatch.undo()

    op = tcoh._gather_operator(gt, None, lam, B)
    rhs = tcoh.query_rhs(lam, Y, psi, B)
    (_, it, _), fused, classic = counts(
        lambda: _classic(op, rhs, Y, lam.lamG + lam.lamQ * B, 1e-5, 64))
    assert classic == it > 0 and fused == 0
    (_, its, _), fused, classic = counts(lambda: tsolver.cg_solve_lanes(
        lambda X: op(X.reshape(80, -1))[0].view(X.shape), torch.stack([rhs, rhs], 1),
        M_diag=(lam.lamG + lam.lamQ * B)[:, None, None].expand(80, 2, 1), tol=1e-5,
        row_dim=0))
    assert classic == max(its) and fused == 0
    (_, it, _), fused, classic = counts(lambda: tsolver.cg_solve(
        lambda X: op(X.float())[0].double(), rhs.double(), tol=1e-5))
    assert classic == it > 0 and fused == 0

    # two lanes on one diagonal: fused while both are live, classic after
    # the easy lane stops
    A = (1.0 + torch.arange(80.0) / 8)[:, None, None]
    b2 = torch.stack([torch.ones(80), torch.sin(torch.arange(80.0) * 0.7) * A[:, 0, 0] ** 2], 1)
    (_, its, _), fused, classic = counts(lambda: tsolver.cg_solve_lanes(
        lambda X: A * X + 0.3 * X.roll(1, 0) + 0.3 * X.roll(-1, 0), b2[:, :, None],
        M_diag=A, tol=1e-6, max_iters=50, row_dim=0))
    assert its[0] != its[1]
    assert fused == min(its) and classic == max(its) - min(its) > 0
