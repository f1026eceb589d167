"""The coherence-lattice energy model and its SPD operator algebra (port of
the non-windowed part of ``oscillink_tpu/models/coherence.py``).

Energy (reference README.md:192-204, docs/foundations/SPEC.md:3-18):

    H(U) = lamG ||U - Y||_F^2 + lamC tr(U^T L_sym U)
         + lamQ tr((U - 1 psi^T)^T B (U - 1 psi^T)) + lamP tr(U^T L_path U)

Stationary point:  M U* = lamG Y + lamQ B 1 psi^T,
    M = lamG I + lamC L_sym + lamQ B + lamP L_path        (SPD for lamG > 0).

Implicit Euler settle step (reference lattice.py:159-230):
    (I + dt M) U+ = U + dt (lamG Y + lamQ B 1 psi^T).

The gather solves here are the classic `cg_solve`.  The JAX package switches
to a low-memory CG above 1 GB b-blocks, a threshold sized for a 16 GB chip;
that variant is not ported yet (ROADMAP.md queue A item 9).

The windowed solves (`WindowCtx`) run the Laplacian through kernels K2–K4
(`ops/kernels/window_spmv.py`): rows are permuted into the plan's locality
order and padded to its geometry, CG runs entirely in permuted space (padded
rows carry decoupled λ_G-only equations), and the solution is permuted back.
The fused forms fold the operator's diagonal into K4 and solve with
`cg_solve_kpap`.  Their column-chunked variants are not ported (queue A
item 9).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.graph import Graph, lap_matvec
from ..ops.path import PathGraph, path_lap_matvec
from ..ops.kernels.window_spmv import OneHots, WindowPlan, k_matvec_windowed, lap_matvec_windowed, pad_rows
from ..ops.solver import cg_solve, cg_solve_kpap

__all__ = [
    "EnergyParams",
    "stationary_matvec",
    "solve_stationary",
    "settle_step",
    "query_rhs",
    "WindowCtx",
    "solve_stationary_windowed",
    "solve_stationary_windowed_fused",
    "settle_step_windowed",
    "settle_step_windowed_fused",
    "solve_stationary_windowed_chunked",
    "settle_step_windowed_chunked",
]


class EnergyParams(NamedTuple):
    """Energy coefficients as 0-d float32 tensors on the lattice's device."""

    lamG: torch.Tensor
    lamC: torch.Tensor
    lamQ: torch.Tensor
    lamP: torch.Tensor

    @classmethod
    def make(cls, lamG: float, lamC: float, lamQ: float, lamP: float = 0.0, *, device):
        def f(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(f(lamG), f(lamC), f(lamQ), f(lamP))


def query_rhs(lam: EnergyParams, Y: torch.Tensor, psi: torch.Tensor, B: torch.Tensor):
    """RHS = lamG Y + lamQ (B ⊙ 1) psi^T (reference lattice.py:171, 245)."""
    return lam.lamG * Y + lam.lamQ * (B[:, None] * psi[None, :])


def stationary_matvec(
    g: Graph, pg: Optional[PathGraph], lam: EnergyParams, B: torch.Tensor, X: torch.Tensor
) -> torch.Tensor:
    """M X = lamG X + lamC L_sym X + lamQ B X (+ lamP L_path X)."""
    out = lam.lamG * X + lam.lamC * lap_matvec(g, X) + lam.lamQ * (B[:, None] * X)
    if pg is not None:
        out = out + lam.lamP * path_lap_matvec(pg, X)
    return out


def solve_stationary(
    g: Graph,
    pg: Optional[PathGraph],
    Y: torch.Tensor,
    psi: torch.Tensor,
    B: torch.Tensor,
    lam: EnergyParams,
    tol: float = 1e-4,
    max_iters: int = 64,
    x0: Optional[torch.Tensor] = None,
):
    """Solve M U* = RHS with Jacobi CG, x0 = Y by default (lattice.py:232-263)."""
    rhs = query_rhs(lam, Y, psi, B)
    M_diag = lam.lamG + lam.lamQ * B
    if pg is not None:
        M_diag = M_diag + lam.lamP

    def M_mul(X):
        return stationary_matvec(g, pg, lam, B, X)

    return cg_solve(
        M_mul, rhs, x0=Y if x0 is None else x0, M_diag=M_diag, tol=tol, max_iters=max_iters
    )


def settle_step(
    g: Graph,
    pg: Optional[PathGraph],
    U: torch.Tensor,
    Y: torch.Tensor,
    psi: torch.Tensor,
    B: torch.Tensor,
    lam: EnergyParams,
    dt: float = 1.0,
    tol: float = 1e-3,
    max_iters: int = 12,
    x0: Optional[torch.Tensor] = None,
    use_jacobi: bool = True,
):
    """One implicit Euler step (I + dt M) U+ = U + dt RHS (lattice.py:159-205).
    ``dt`` is a Python number: it scales float32 tensors in float32, as the
    JAX package's float32 ``dt`` does, without a host-to-device copy."""
    dt = float(dt)
    rhs = U + dt * query_rhs(lam, Y, psi, B)

    def A_mul(X):
        return X + dt * stationary_matvec(g, pg, lam, B, X)

    M_diag = None
    if use_jacobi:
        diag_base = lam.lamG + lam.lamQ * B
        if pg is not None:
            diag_base = diag_base + lam.lamP
        M_diag = 1.0 + dt * diag_base

    return cg_solve(
        A_mul, rhs, x0=U if x0 is None else x0, M_diag=M_diag, tol=tol, max_iters=max_iters
    )


# -- windowed-matvec solves (kernels K2-K4) ---------------------------------


class WindowCtx(NamedTuple):
    """Locality-ordered window-matvec context, built once per graph.  The
    kernels read the plan alone; the one-hots exist only for the CPU route's
    one-hot plain versions (None on the card)."""

    plan: WindowPlan
    order: torch.Tensor  # [N] int32: permuted position -> original row
    inv_order: torch.Tensor  # [N] int32: original row -> permuted position
    W: int  # window rows
    s_max: int  # straggler window (rows of a block's segment read)
    oh: Optional[OneHots] = None


def _permuted_operands(ctx: WindowCtx, arrays):
    order = ctx.order.long()
    return [pad_rows(a.index_select(0, order), ctx.plan.n_pad) for a in arrays]


def _unpermute(ctx: WindowCtx, Up: torch.Tensor) -> torch.Tensor:
    return Up.index_select(0, ctx.inv_order.long())


def solve_stationary_windowed(
    ctx: WindowCtx,
    Y: torch.Tensor,
    psi: torch.Tensor,
    B: torch.Tensor,
    lam: EnergyParams,
    tol: float = 1e-4,
    max_iters: int = 64,
    x0: Optional[torch.Tensor] = None,
):
    """Stationary solve with the windowed Laplacian matvec (no chain prior)."""
    ops = [Y, B[:, None]] + ([x0] if x0 is not None else [])
    perm = _permuted_operands(ctx, ops)
    Yp, Bp = perm[0], perm[1][:, 0]
    x0p = perm[2] if x0 is not None else Yp
    rhs = lam.lamG * Yp + lam.lamQ * (Bp[:, None] * psi[None, :])
    M_diag = lam.lamG + lam.lamQ * Bp

    def M_mul(X):
        return (
            lam.lamG * X
            + lam.lamC * lap_matvec_windowed(ctx.plan, ctx.oh, X, W=ctx.W, s_max=ctx.s_max)
            + lam.lamQ * (Bp[:, None] * X)
        )

    Up, iters, res = cg_solve(M_mul, rhs, x0=x0p, M_diag=M_diag, tol=tol, max_iters=max_iters)
    return _unpermute(ctx, Up), iters, res


def solve_stationary_windowed_fused(
    ctx: WindowCtx,
    Y: torch.Tensor,
    psi: torch.Tensor,
    B: torch.Tensor,
    lam: EnergyParams,
    tol: float = 1e-4,
    max_iters: int = 64,
    x0: Optional[torch.Tensor] = None,
):
    """Stationary solve through the fused operator (λ_C ≠ 0, which the
    lattice's router guarantees): one K4 launch per CG iteration gives
    M p / λ_C and ⟨p, Mp⟩ / λ_C."""
    ops = [Y, B[:, None]] + ([x0] if x0 is not None else [])
    perm = _permuted_operands(ctx, ops)
    Yp, Bp = perm[0], perm[1][:, 0]
    x0p = perm[2] if x0 is not None else Yp
    rhs = lam.lamG * Yp + lam.lamQ * (Bp[:, None] * psi[None, :])
    M_diag = lam.lamG + lam.lamQ * Bp
    s = lam.lamC
    g = ((lam.lamG + lam.lamC + lam.lamQ * Bp) / s)[:, None]

    def K_mul(X):
        return k_matvec_windowed(ctx.plan, ctx.oh, X, g, W=ctx.W, s_max=ctx.s_max)

    Up, iters, res = cg_solve_kpap(K_mul, s, rhs, x0=x0p, M_diag=M_diag, tol=tol, max_iters=max_iters)
    return _unpermute(ctx, Up), iters, res


def settle_step_windowed_fused(
    ctx: WindowCtx,
    U: torch.Tensor,
    Y: torch.Tensor,
    psi: torch.Tensor,
    B: torch.Tensor,
    lam: EnergyParams,
    dt: float = 1.0,
    tol: float = 1e-3,
    max_iters: int = 12,
    x0: Optional[torch.Tensor] = None,
    use_jacobi: bool = True,
):
    """Implicit Euler step through the fused operator (dt·λ_C ≠ 0, which the
    lattice's router guarantees): A = I + dt·M = s·K with s = dt·λ_C and the
    diagonal folded into K4's g."""
    dt = float(dt)
    ops = [U, Y, B[:, None]] + ([x0] if x0 is not None else [])
    perm = _permuted_operands(ctx, ops)
    Up0, Yp, Bp = perm[0], perm[1], perm[2][:, 0]
    x0p = perm[3] if x0 is not None else Up0
    rhs = Up0 + dt * (lam.lamG * Yp + lam.lamQ * (Bp[:, None] * psi[None, :]))
    s = dt * lam.lamC
    g = ((1.0 + dt * (lam.lamG + lam.lamQ * Bp) + dt * lam.lamC) / s)[:, None]
    M_diag = 1.0 + dt * (lam.lamG + lam.lamQ * Bp) if use_jacobi else None

    def K_mul(X):
        return k_matvec_windowed(ctx.plan, ctx.oh, X, g, W=ctx.W, s_max=ctx.s_max)

    Up, iters, res = cg_solve_kpap(K_mul, s, rhs, x0=x0p, M_diag=M_diag, tol=tol, max_iters=max_iters)
    return _unpermute(ctx, Up), iters, res


def settle_step_windowed(
    ctx: WindowCtx,
    U: torch.Tensor,
    Y: torch.Tensor,
    psi: torch.Tensor,
    B: torch.Tensor,
    lam: EnergyParams,
    dt: float = 1.0,
    tol: float = 1e-3,
    max_iters: int = 12,
    x0: Optional[torch.Tensor] = None,
    use_jacobi: bool = True,
):
    """Implicit Euler step with the windowed Laplacian matvec (no chain)."""
    dt = float(dt)
    ops = [U, Y, B[:, None]] + ([x0] if x0 is not None else [])
    perm = _permuted_operands(ctx, ops)
    Up0, Yp, Bp = perm[0], perm[1], perm[2][:, 0]
    x0p = perm[3] if x0 is not None else Up0
    rhs = Up0 + dt * (lam.lamG * Yp + lam.lamQ * (Bp[:, None] * psi[None, :]))

    def A_mul(X):
        return X + dt * (
            lam.lamG * X
            + lam.lamC * lap_matvec_windowed(ctx.plan, ctx.oh, X, W=ctx.W, s_max=ctx.s_max)
            + lam.lamQ * (Bp[:, None] * X)
        )

    M_diag = 1.0 + dt * (lam.lamG + lam.lamQ * Bp) if use_jacobi else None
    Up, iters, res = cg_solve(A_mul, rhs, x0=x0p, M_diag=M_diag, tol=tol, max_iters=max_iters)
    return _unpermute(ctx, Up), iters, res


_CHUNKED = (
    "{name} (the column-chunked windowed solve) is not ported to "
    "oscillink_tpu_torch yet (ROADMAP.md queue A item 9)"
)


def solve_stationary_windowed_chunked(*args, **kwargs):
    raise NotImplementedError(_CHUNKED.format(name="solve_stationary_windowed_chunked"))


def settle_step_windowed_chunked(*args, **kwargs):
    raise NotImplementedError(_CHUNKED.format(name="settle_step_windowed_chunked"))
