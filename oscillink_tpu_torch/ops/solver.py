"""Jacobi-preconditioned multi-RHS conjugate gradient (port of ``oscillink_tpu/ops/solver.py``).

Behavioral contract (reference: oscillink/core/solver.py:6-37): operates on a
linear operator ``A_mul`` over [N, D] blocks; per-column alpha/beta; residual
is the max column L2 norm; epsilon guards 1e-18 (denominators) and 1e-12
(preconditioner diagonal); ALWAYS runs at least one iteration; returns
(x, iters, res) where res is the residual at exit.

The loop is a Python loop: it reads ``res`` on the host once per iteration
(one device sync each), and stops where the JAX ``lax.while_loop`` stops —
``tol`` is compared in float32, as the JAX package stages it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["cg_solve", "cg_solve_kpap"]


def cg_solve(
    A_mul: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M_diag: Optional[torch.Tensor] = None,
    tol: float = 1e-3,
    max_iters: int = 100,
) -> tuple[torch.Tensor, int, float]:
    """CG for an SPD operator; multi-RHS [N, D]. Returns (x, iters, res) with
    iters and res as host numbers.  ``M_diag`` is the Jacobi diagonal [N]."""
    b2 = b[:, None] if b.ndim == 1 else b
    x = torch.zeros_like(b2) if x0 is None else x0.reshape(b2.shape).to(b2.dtype)
    inv_M = None if M_diag is None else 1.0 / (M_diag[:, None] + 1e-12)

    def precond(r):
        return r if inv_M is None else r * inv_M

    tol32 = float(np.float32(tol))
    max_iters = int(max_iters)

    r = b2 - A_mul(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z, dim=0)
    it, res = 0, float("inf")
    # the reference's for-loop always performs >= 1 iteration
    while it == 0 or (it < max_iters and res > tol32):
        Ap = A_mul(p)
        denom = torch.sum(p * Ap, dim=0) + 1e-18
        alpha = rz / denom
        x = x + p * alpha
        r = r - Ap * alpha
        res_t = torch.max(torch.linalg.vector_norm(r, dim=0))
        z = precond(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = rz_new / (rz + 1e-18)
        p = z + p * beta
        rz = rz_new
        it += 1
        res = float(res_t)
    if b.ndim == 1:
        x = x[:, 0]
    return x, it, res


def cg_solve_kpap(
    K_mul: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    s: torch.Tensor | float,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M_diag: Optional[torch.Tensor] = None,
    tol: float = 1e-3,
    max_iters: int = 100,
) -> tuple[torch.Tensor, int, float]:
    """`cg_solve` for A = s·K where the operator returns its own denominator.

    ``K_mul(x)`` returns ``(K x, per-column Σ_rows x⊙Kx)`` — kernel K4
    (`ops.kernels.window_spmv.k_matvec_windowed`) computes the reduction
    while its output tile is on chip.  Inside the loop the scale s is applied
    to the scalars (α·s on the residual update, s·⟨p, Kp⟩ on the
    denominator), never to the [N, D] blocks; the initial residual
    r0 = b − (K x0)·s is the one block-wide use.  Same contract as
    `cg_solve`: at least one iteration, one host read of ``res`` per
    iteration, ``tol`` compared in float32.  ``b`` is [N, D]; s ≠ 0."""
    x = torch.zeros_like(b) if x0 is None else x0.reshape(b.shape).to(b.dtype)
    inv_M = None if M_diag is None else 1.0 / (M_diag[:, None] + 1e-12)

    def precond(r):
        return r if inv_M is None else r * inv_M

    s = torch.as_tensor(s, dtype=torch.float32, device=b.device)
    tol32 = float(np.float32(tol))
    max_iters = int(max_iters)

    Kx, _ = K_mul(x)
    r = b - Kx * s
    z = precond(r)
    p = z
    rz = torch.sum(r * z, dim=0)
    it, res = 0, float("inf")
    while it == 0 or (it < max_iters and res > tol32):
        Kp, pkp = K_mul(p)
        denom = s * pkp + 1e-18
        alpha = rz / denom
        x = x + p * alpha
        r = r - Kp * (alpha * s)
        res_t = torch.max(torch.linalg.vector_norm(r, dim=0))
        z = precond(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = rz_new / (rz + 1e-18)
        p = z + p * beta
        rz = rz_new
        it += 1
        res = float(res_t)
    return x, it, res
