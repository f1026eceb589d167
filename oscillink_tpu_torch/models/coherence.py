"""The coherence-lattice energy model and its SPD operator algebra (port of
the non-windowed part of ``oscillink_tpu/models/coherence.py``).

Energy (reference README.md:192-204, docs/foundations/SPEC.md:3-18):

    H(U) = lamG ||U - Y||_F^2 + lamC tr(U^T L_sym U)
         + lamQ tr((U - 1 psi^T)^T B (U - 1 psi^T)) + lamP tr(U^T L_path U)

Stationary point:  M U* = lamG Y + lamQ B 1 psi^T,
    M = lamG I + lamC L_sym + lamQ B + lamP L_path        (SPD for lamG > 0).

Implicit Euler settle step (reference lattice.py:159-230):
    (I + dt M) U+ = U + dt (lamG Y + lamQ B 1 psi^T).

Every solve here is the classic `cg_solve`.  The JAX package switches to a
low-memory CG above 1 GB b-blocks, a threshold sized for a 16 GB chip; that
variant is not ported yet (ROADMAP.md queue A item 9).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.graph import Graph, lap_matvec
from ..ops.path import PathGraph, path_lap_matvec
from ..ops.solver import cg_solve

__all__ = [
    "EnergyParams",
    "stationary_matvec",
    "solve_stationary",
    "settle_step",
    "query_rhs",
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
