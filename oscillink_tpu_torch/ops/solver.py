"""Jacobi-preconditioned multi-RHS conjugate gradient (port of ``oscillink_tpu/ops/solver.py``).

Behavioral contract (reference: oscillink/core/solver.py:6-37): operates on a
linear operator ``A_mul`` over [N, D] blocks; per-column alpha/beta; residual
is the max column L2 norm; epsilon guards 1e-18 (denominators) and 1e-12
(preconditioner diagonal); ALWAYS runs at least one iteration; returns
(x, iters, res) where res is the residual at exit.

The loop is a Python loop: it reads ``res`` on the host once per iteration
(one device sync each), and stops where the JAX ``lax.while_loop`` stops —
``tol`` is compared in float32, as the JAX package stages it.

`cg_solve_lanes` is the port of ``jax.vmap`` over `cg_solve`: independent
systems stacked on a lane axis, one operator application an iteration for
all of them, and each lane frozen at its own trip count.  `cg_solve` is its
one-lane call, so the two cannot drift apart.  Where the block allows, an
iteration runs as three hand-written passes and three small launches
(`ops.kernels.cg_fused`) in place of some 25 eager ones.

`cg_solve_lowmem` is `cg_solve` with four live [N, D] blocks (x, r, p, Ap):
its updates run in place, row block by row block, so no [N, D] product is
ever materialised.  The coherence solves take it for b-blocks above
`LOWMEM_SOLVE_BYTES`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..utils.profiling import span
from .kernels import cg_fused

__all__ = ["cg_solve", "cg_solve_kpap", "cg_solve_lanes", "cg_solve_lowmem", "LOWMEM_SOLVE_BYTES",
           "row_blocks"]

# Above this b-block size (bytes) the coherence solves take `cg_solve_lowmem`
# (models/coherence.py `_pick_cg`).  Set from chip_smoke.py's `million`
# phase (1,000,000 x 768 x k8, NVIDIA H100 80GB HBM3, 700 W): the
# low-memory form was no faster there (U* 882.2 against 836.3 ms, medians
# in turns; settle 800.8 against 776.2 / 755.1 ms), so
# it takes over where the classic form's measured working set leaves the
# card's budget with the most the lattice holds beside a solve (Y, U and
# the U* cache) resident: 3 + 10.1 live blocks, the graph and small
# tensors against 85.02 GB less 1.26 GB of headroom (`core/lattice.py`'s
# working-set model), just above b = 6.357 GB (N = 2.07M at D = 768).
LOWMEM_SOLVE_BYTES = 6_350_000_000

fused_iterations = 0
"""CG iterations `cg_solve_lanes` ran through the fused passes
(`ops.kernels.cg_fused`) since the count was last reset."""

classic_iterations = 0
"""CG iterations `cg_solve_lanes` ran as its classic eager body since the
count was last reset."""

# Bytes of one row block of the low-memory forms' temporaries: each update
# or reduction materialises at most a [rows, D] product of this size.
ROW_BLOCK_BYTES = 1 << 28


def row_blocks(n: int, d: int) -> list[slice]:
    """Row slices of an [n, d] f32 block, each at most `ROW_BLOCK_BYTES`."""
    rows = max(1, ROW_BLOCK_BYTES // max(1, 4 * d))
    return [slice(r0, min(r0 + rows, n)) for r0 in range(0, n, rows)]


def _col_dot(a: torch.Tensor, b: torch.Tensor, blocks: list[slice],
             w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-column Σ_rows a ⊙ b, or a ⊙ (b ⊙ w) with a [N, 1] ``w``, summed
    row block by row block: each product rounds as the full-width one."""
    out = None
    for sl in blocks:
        t = a[sl] * (b[sl] if w is None else b[sl] * w[sl])
        s = torch.sum(t, dim=0)
        out = s if out is None else out.add_(s)
    return out


def cg_solve(
    A_mul: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M_diag: Optional[torch.Tensor] = None,
    tol: float = 1e-3,
    max_iters: int = 100,
) -> tuple[torch.Tensor, int, float]:
    """CG for an SPD operator; multi-RHS [N, D]. Returns (x, iters, res) with
    iters and res as host numbers.  ``M_diag`` is the Jacobi diagonal [N].

    The one-lane call of `cg_solve_lanes` on the [N, D] block."""
    b2 = b[:, None] if b.ndim == 1 else b
    x, its, res = cg_solve_lanes(
        A_mul, b2, x0=None if x0 is None else x0.reshape(b2.shape),
        M_diag=None if M_diag is None else M_diag[:, None], tol=tol, max_iters=max_iters,
        row_dim=0,
    )
    return x.reshape(b.shape), int(its[0]), float(res[0])


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
        with span("cg.wait"):
            res = float(res_t)
    return x, it, res


def _fused_layout(b: torch.Tensor, inv_M: Optional[torch.Tensor], row_dim: int) -> bool:
    """Whether `cg_solve_lanes` runs ``b`` through the fused passes
    (`ops.kernels.cg_fused`): a non-empty float32 block on the card or the
    CPU with its rows on dim 0, and a float32 Jacobi inverse of one value a
    row ([N, 1] or [N, 1, 1]), or none."""
    if (row_dim != 0 or b.dtype != torch.float32 or b.numel() == 0
            or b.device.type not in ("cuda", "cpu")):
        return False
    return inv_M is None or (inv_M.dtype == torch.float32 and inv_M.dim() == b.dim()
                             and inv_M.numel() == b.shape[0] == inv_M.shape[0])


def cg_solve_lanes(
    A_mul: Callable[[torch.Tensor], torch.Tensor | tuple[torch.Tensor, torch.Tensor]],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M_diag: Optional[torch.Tensor] = None,
    tol: float = 1e-3,
    max_iters: int = 100,
    *,
    row_dim: int,
) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """`cg_solve` on L independent systems at once: the port of a vmapped
    `cg_solve` (``jax.vmap`` over its ``lax.while_loop``).

    ``b`` is 3-D with its rows on ``row_dim``, lanes on the other leading
    axis and D columns last: ``row_dim=0`` is ``[N, L, D]`` (L queries on
    one graph), ``row_dim=1`` is ``[L, N, D]`` (L corpora on their disjoint
    union); a 2-D ``[N, D]`` block (``row_dim=0``) is one lane.  ``A_mul``
    maps such a block to one of its shape, or to ``(A p, ⟨p, A p⟩
    partials)`` (`ops.kernels.cg_fused.combine`'s pair); it sees the whole
    block, so the operator launches once an iteration for all lanes.
    ``M_diag`` (the Jacobi diagonal) broadcasts against ``b``.

    Each lane runs `cg_solve`'s arithmetic with its own residual (the max
    column norm over its D columns), trip count and stop test
    ``(it == 0) | ((it < max_iters) & (res > tol))``, ``tol`` in float32.
    A lane that has stopped keeps its state by a select, as the vmapped
    ``while_loop`` does; its columns are still computed and discarded, and
    while every lane is live no select runs.  The loop reads the [L]
    residuals on the host once an iteration and runs the stop test there,
    so one lane costs the device what `cg_solve` always did.

    A float32 block with its rows on dim 0 whose Jacobi diagonal is one
    value a row, or absent (`_fused_layout`), runs its start and every
    iteration in which all lanes are live through the fused passes of
    `ops.kernels.cg_fused` (their kernels on the card, their twins on the
    CPU), x, r and p updated in place (x0 is never written): x, r, p and
    A p as the classic expressions give them, bit for bit; on the card the
    column sums in float64 and another order, on the CPU as the classic
    body takes them.  An operator that returns a plain block gets the dot
    pass for ⟨p, A p⟩.  Other layouts, and an iteration with a stopped
    lane, take the classic eager body.  `fused_iterations` and
    `classic_iterations` count the two.

    Returns (x, iterations [L] int32, residuals [L] float32), the last two
    on the host."""
    global fused_iterations, classic_iterations
    if b.dim() not in (2, 3) or row_dim not in (0, 1) or (b.dim() == 2 and row_dim != 0):
        raise ValueError(f"cg_solve_lanes: b must be [N, D] or 3-D with row_dim 0 or 1, "
                         f"got {tuple(b.shape)} and row_dim {row_dim}")
    inv_M = None if M_diag is None else 1.0 / (M_diag + 1e-12)

    def precond(r):
        return r if inv_M is None else r * inv_M

    def col_sum(t):
        return torch.sum(t, dim=row_dim, keepdim=True)

    def block(out):
        return out[0] if isinstance(out, tuple) else out

    lane_shape = [1] * b.dim()
    if b.dim() == 3:
        lane_shape[1 - row_dim] = b.shape[1 - row_dim]
    n_lanes = int(np.prod(lane_shape))
    tol32 = float(np.float32(tol))
    max_iters = int(max_iters)

    fused = _fused_layout(b, inv_M, row_dim)
    if fused:
        b = b.contiguous()
        inv_rows = None if inv_M is None else inv_M.reshape(-1).contiguous()
        rz_shape = (1,) + tuple(b.shape[1:])
        x_owned = x0 is None  # x0's own buffer is never written
        x = torch.zeros_like(b) if x0 is None else x0.reshape(b.shape).to(b.dtype).contiguous()
        r, p, prz = cg_fused.residual(b, block(A_mul(x)), inv_rows)
        rz = cg_fused.finish(prz)[0].view(rz_shape)
    else:
        x = torch.zeros_like(b) if x0 is None else x0.reshape(b.shape).to(b.dtype)
        r = b - block(A_mul(x))
        z = precond(r)
        p = z
        rz = col_sum(r * z)
    it = [0] * n_lanes
    res = [float("inf")] * n_lanes
    while True:
        # the reference's for-loop always performs >= 1 iteration
        active = [i == 0 or (i < max_iters and e > tol32) for i, e in zip(it, res)]
        if not any(active):
            break
        out = A_mul(p)
        Ap = block(out)
        if fused and all(active):
            pap = out[1] if isinstance(out, tuple) else cg_fused.dot(p, Ap)
            alpha = cg_fused.alpha(pap, rz.reshape(-1))
            x_out = x if x_owned else torch.empty_like(b)
            prz, prr = cg_fused.update(x, x_out, r, p, Ap, alpha, inv_rows)
            x, x_owned = x_out, True
            rz_n, beta, res_t = cg_fused.finish(prz, rz.reshape(-1), prr, n_lanes)
            cg_fused.direction(p, r, beta, inv_rows)
            rz = rz_n.view(rz_shape)
            fused_iterations += 1
        else:
            denom = col_sum(p * Ap) + 1e-18
            alpha = rz / denom
            x_n = x + p * alpha
            r_n = r - Ap * alpha
            res_t = torch.amax(torch.linalg.vector_norm(r_n, dim=row_dim, keepdim=True), dim=-1)
            z = precond(r_n)
            rz_n = col_sum(r_n * z)
            beta = rz_n / (rz + 1e-18)
            p_n = z + p * beta
            if all(active):
                x, r, p, rz = x_n, r_n, p_n, rz_n
            else:
                keep = torch.tensor(active, device=b.device).reshape(lane_shape)
                x = torch.where(keep, x_n, x)
                r = torch.where(keep, r_n, r)
                p = torch.where(keep, p_n, p)
                rz = torch.where(keep, rz_n, rz)
            classic_iterations += 1
        with span("cg.wait"):
            res_h = res_t.reshape(-1).tolist()  # the one host read of the iteration
        res = [e_n if a else e for a, e_n, e in zip(active, res_h, res)]
        it = [i + a for a, i in zip(active, it)]
    return x, np.asarray(it, dtype=np.int32), np.asarray(res, dtype=np.float32)


def cg_solve_lowmem(
    A_mul: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M_diag: Optional[torch.Tensor] = None,
    tol: float = 1e-3,
    max_iters: int = 100,
    *,
    overwrite_x0: bool = False,
    overwrite_b: bool = False,
) -> tuple[torch.Tensor, int, float]:
    """`cg_solve` with the minimum large-N live set: x, r, p and Ap.

    Same contract (at least one iteration, ``tol`` in float32, one host read
    of ``res`` an iteration, the same return values) and the same update
    expressions: each product is rounded on its own and then added, as the
    classic form's ``x + p * alpha`` is, so no fused multiply-add can change
    an iterate.  The preconditioned residual z = r·inv_M is never a named
    block: it is formed a row block at a time inside the ⟨r, z⟩ reduction
    and the p update.  The updates of x, r and p run in place, and the two
    reductions Σ p·Ap and Σ r·(r·inv_M) in row blocks (`row_blocks`), so the
    only temporaries are row-block sized.  Only the reduction order differs
    from `cg_solve`: the iteration counts are the same and x agrees to
    rounding.

    ``overwrite_x0=True`` makes x0's own buffer (contiguous float32 of b's
    shape) the iterate, and ``overwrite_b=True`` computes the residual in
    b's buffer: each saves a block when the caller no longer needs it.
    ``A_mul`` should itself hold no extra [N, D] temporaries (the coherence
    solves pass their in-place operator)."""
    b2 = b[:, None] if b.ndim == 1 else b
    if x0 is None:
        x = torch.zeros_like(b2)
    elif overwrite_x0:
        if not (x0.is_contiguous() and x0.dtype == b2.dtype and x0.numel() == b2.numel()):
            raise ValueError("cg_solve_lowmem: overwrite_x0 needs a contiguous x0 of b's "
                             "shape and dtype")
        x = x0.view(b2.shape)
    else:
        x = torch.empty_like(b2, memory_format=torch.contiguous_format)
        x.copy_(x0.reshape(b2.shape))
    inv_M = None if M_diag is None else 1.0 / (M_diag[:, None] + 1e-12)
    blocks = row_blocks(*b2.shape)
    tol32 = float(np.float32(tol))
    max_iters = int(max_iters)

    Ax = A_mul(x)
    r = b2.sub_(Ax) if overwrite_b else b2 - Ax
    del Ax
    rz = _col_dot(r, r, blocks, inv_M)
    p = r.clone() if inv_M is None else r * inv_M
    it, res = 0, float("inf")
    while it == 0 or (it < max_iters and res > tol32):
        Ap = A_mul(p)
        alpha = rz / (_col_dot(p, Ap, blocks) + 1e-18)
        for sl in blocks:
            x[sl].add_(p[sl] * alpha)
            r[sl].sub_(Ap[sl] * alpha)
        del Ap
        res_t = torch.max(torch.linalg.vector_norm(r, dim=0))
        rz_new = _col_dot(r, r, blocks, inv_M)
        beta = rz_new / (rz + 1e-18)
        for sl in blocks:
            p[sl].mul_(beta).add_(r[sl] if inv_M is None else r[sl] * inv_M[sl])
        rz = rz_new
        it += 1
        with span("cg.wait"):
            res = float(res_t)  # the one host read of the iteration
    return x.view(b.shape), it, res
