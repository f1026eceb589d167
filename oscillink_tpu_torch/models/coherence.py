"""The coherence-lattice energy model and its SPD operator algebra (port of
the non-windowed part of ``oscillink_tpu/models/coherence.py``).

Energy (reference README.md:192-204, docs/foundations/SPEC.md:3-18):

    H(U) = lamG ||U - Y||_F^2 + lamC tr(U^T L_sym U)
         + lamQ tr((U - 1 psi^T)^T B (U - 1 psi^T)) + lamP tr(U^T L_path U)

Stationary point:  M U* = lamG Y + lamQ B 1 psi^T,
    M = lamG I + lamC L_sym + lamQ B + lamP L_path        (SPD for lamG > 0).

Implicit Euler settle step (reference lattice.py:159-230):
    (I + dt M) U+ = U + dt (lamG Y + lamQ B 1 psi^T).

The gather solves take the classic `cg_solve` up to `LOWMEM_SOLVE_BYTES`
b-blocks and `cg_solve_lowmem` above (`_pick_cg`).  The JAX low-memory CG
saves memory because XLA fuses its operator; in eager PyTorch the operator
is where the blocks go, so the low-memory route also builds its right-hand
side and applies its operator in place, row block by row block, into the
one block kernel K1 returns (`_apply_inplace`), with the classic
operator's arithmetic.  `settle_step(donate_u=True)` is the settle that
starts from, and writes into, U's own buffer.

The column-chunked solves (`solve_stationary_chunked`,
`settle_step_chunked`) solve D/c columns at a time, one chunk to
completion before the next: CG acts per column, so each chunk is the
full-width solve of its columns, and the working set of the solve falls
by c.  Each chunk's columns are copied once into a contiguous block (K1
takes contiguous operands only) and written back into one preallocated
[N, D] buffer.

The windowed solves (`WindowCtx`) run the Laplacian through kernels K2–K4
(`ops/kernels/window_spmv.py`): rows are permuted into the plan's locality
order and padded to its geometry, CG runs entirely in permuted space (padded
rows carry decoupled λ_G-only equations), and the solution is permuted back.
The fused forms fold the operator's diagonal into K4 and solve with
`cg_solve_kpap`.  Their column-chunked variants run each chunk through the
same solves at width D/c, so the width picks the kernel: K4 or K3 at a
multiple of 128, K2 and its straggler epilogue otherwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops.graph import Graph, lap_matvec
from ..ops.path import PathGraph, path_lap_matvec
from ..ops.kernels.window_spmv import OneHots, WindowPlan, k_matvec_windowed, lap_matvec_windowed, pad_rows
from ..ops.solver import LOWMEM_SOLVE_BYTES, cg_solve, cg_solve_kpap, cg_solve_lowmem, row_blocks

__all__ = [
    "EnergyParams",
    "stationary_matvec",
    "solve_stationary",
    "settle_step",
    "solve_stationary_chunked",
    "settle_step_chunked",
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


def _pick_cg(b):
    """Shape-gated solver choice: `cg_solve_lowmem` for b-blocks above
    `LOWMEM_SOLVE_BYTES`, the classic `cg_solve` below.  Only ``b.shape``
    and ``b.dtype.itemsize`` are read, so the solves gate on Y (the
    b-block's shape) before they build the right-hand side."""
    big = math.prod(b.shape) * b.dtype.itemsize > LOWMEM_SOLVE_BYTES
    return cg_solve_lowmem if big else cg_solve


def _path_rows(pg: PathGraph, X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows of ``path_lap_matvec(pg, X)`` that differ from X: the chain's
    nodes (sorted) and X − acc on them, with acc summed in the same
    index_add order as the full-width form, into a [nodes, D] block."""
    nodes = torch.unique(torch.cat([pg.src, pg.dst]))
    pos = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    pos[nodes.long()] = torch.arange(nodes.numel(), device=X.device)
    src, dst = pg.src.long(), pg.dst.long()
    acc = X.new_zeros((nodes.numel(), X.shape[1]))
    acc.index_add_(0, pos[src], pg.wn[:, None] * X.index_select(0, dst))
    acc.index_add_(0, pos[dst], pg.wn[:, None] * X.index_select(0, src))
    return nodes.long(), X.index_select(0, nodes.long()) - acc


def _apply_inplace(
    g: Graph, pg: Optional[PathGraph], lam: EnergyParams, B: torch.Tensor, X: torch.Tensor,
    dt: Optional[float] = None,
) -> torch.Tensor:
    """`stationary_matvec` (or ``X + dt·M X`` with ``dt``) with one new
    [N, D] block: K1's output, which the λ-combination then overwrites row
    block by row block.  Each product and sum rounds as in the classic
    expression ``((λ_G X + λ_C L X) + λ_Q (B X)) + λ_P L_path X``."""
    out = lap_matvec(g, X)
    chain = None
    if pg is not None and pg.n_edges > 0:
        chain = _path_rows(pg, X)
    for sl in row_blocks(*X.shape):
        Xb = X[sl]
        t = lam.lamG * Xb
        t.add_(out[sl].mul_(lam.lamC))
        t.add_((B[sl, None] * Xb).mul_(lam.lamQ))
        if pg is not None:
            lp = Xb.clone()
            if chain is not None:
                nodes, rows = chain
                hit = (nodes >= sl.start) & (nodes < sl.stop)
                lp[nodes[hit] - sl.start] = rows[hit]
            t.add_(lp.mul_(lam.lamP))
        if dt is not None:
            t.mul_(dt).add_(Xb)
        out[sl].copy_(t)
    return out


def _rhs_inplace(
    lam: EnergyParams, Y: torch.Tensor, psi: torch.Tensor, B: torch.Tensor,
    U: Optional[torch.Tensor] = None, dt: Optional[float] = None,
) -> torch.Tensor:
    """`query_rhs` (or ``U + dt·query_rhs`` with U and dt) built into one
    new block, row block by row block, with the same roundings."""
    out = torch.empty_like(Y, memory_format=torch.contiguous_format)
    for sl in row_blocks(*Y.shape):
        t = lam.lamG * Y[sl]
        t.add_((B[sl, None] * psi[None, :]).mul_(lam.lamQ))
        if U is not None:
            t.mul_(dt).add_(U[sl])
        out[sl].copy_(t)
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
    """Solve M U* = RHS with Jacobi CG, x0 = Y by default (lattice.py:232-263).
    Above `LOWMEM_SOLVE_BYTES` the low-memory route (`_pick_cg`)."""
    M_diag = lam.lamG + lam.lamQ * B
    if pg is not None:
        M_diag = M_diag + lam.lamP
    x0 = Y if x0 is None else x0
    if _pick_cg(Y) is cg_solve_lowmem:
        return cg_solve_lowmem(
            lambda X: _apply_inplace(g, pg, lam, B, X), _rhs_inplace(lam, Y, psi, B), x0=x0,
            M_diag=M_diag, tol=tol, max_iters=max_iters, overwrite_b=True,
        )
    rhs = query_rhs(lam, Y, psi, B)

    def M_mul(X):
        return stationary_matvec(g, pg, lam, B, X)

    return cg_solve(M_mul, rhs, x0=x0, M_diag=M_diag, tol=tol, max_iters=max_iters)


def _chunk_width(d: int, col_chunks: int) -> int:
    if d % col_chunks != 0:
        raise ValueError(f"D={d} must divide col_chunks={col_chunks}")
    return d // col_chunks


def _accumulate_chunks(buf: torch.Tensor, w: int, solve_chunk):
    """Solve the column chunks of width ``w`` one after another, each to
    completion, writing chunk c's result into ``buf[:, c·w:(c+1)·w]``.
    ``solve_chunk(sl)`` returns (U_c, iters, res).  A finished chunk's
    result is dropped before the next starts, so the caching allocator
    never holds two chunks' state.  Returns (buf, max iters, max res)."""
    iters_all, res_all = [], []
    for off in range(0, buf.shape[1], w):
        sl = slice(off, off + w)
        U_c, it_c, res_c = solve_chunk(sl)
        buf[:, sl].copy_(U_c)
        del U_c
        iters_all.append(it_c)
        res_all.append(res_c)
    return buf, max(iters_all), max(res_all)


def solve_stationary_chunked(
    g: Graph,
    pg: Optional[PathGraph],
    Y: torch.Tensor,
    psi: torch.Tensor,
    B: torch.Tensor,
    lam: EnergyParams,
    tol: float = 1e-4,
    max_iters: int = 64,
    col_chunks: int = 2,
    x0: Optional[torch.Tensor] = None,
):
    """Stationary solve with the embedding columns split into ``col_chunks``
    chunks, solved one after another (`_accumulate_chunks`).  Termination
    is each chunk's own max column norm, so a chunk's iteration count may
    differ from the full-width solve's by one; every column still reaches
    ``tol``.  Returns (U* [N, D], max iters over chunks, max residual)."""
    w = _chunk_width(Y.shape[1], col_chunks)

    def chunk(sl):
        return solve_stationary(
            g, pg, Y[:, sl].contiguous(), psi[sl], B, lam, tol, max_iters,
            None if x0 is None else x0[:, sl].contiguous(),
        )

    return _accumulate_chunks(torch.empty_like(Y, memory_format=torch.contiguous_format), w,
                              chunk)


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
    donate_u: bool = False,
):
    """One implicit Euler step (I + dt M) U+ = U + dt RHS (lattice.py:159-205).
    ``dt`` is a Python number: it scales float32 tensors in float32, as the
    JAX package's float32 ``dt`` does, without a host-to-device copy.  Above
    `LOWMEM_SOLVE_BYTES` the low-memory route (`_pick_cg`).

    ``donate_u=True`` lets the low-memory route consume U (the JAX package's
    donated settle): the right-hand side is built from U, then U's own
    buffer (contiguous float32) becomes the CG iterate, holding x0 when x0
    is another tensor, and U+ is written into it.  Pass it only when U is
    being replaced by the result and nothing else holds it; the classic
    route ignores it."""
    dt = float(dt)
    M_diag = _settle_diag(pg, lam, B, dt) if use_jacobi else None
    x0 = U if x0 is None else x0
    if _pick_cg(U) is cg_solve_lowmem:
        rhs = _rhs_inplace(lam, Y, psi, B, U, dt)
        if donate_u:
            if x0 is not U:
                U.copy_(x0)
            x0 = U
        return cg_solve_lowmem(
            lambda X: _apply_inplace(g, pg, lam, B, X, dt), rhs, x0=x0, M_diag=M_diag, tol=tol,
            max_iters=max_iters, overwrite_x0=donate_u, overwrite_b=True,
        )
    rhs = U + dt * query_rhs(lam, Y, psi, B)

    def A_mul(X):
        return X + dt * stationary_matvec(g, pg, lam, B, X)

    return cg_solve(A_mul, rhs, x0=x0, M_diag=M_diag, tol=tol, max_iters=max_iters)


def _settle_diag(pg: Optional[PathGraph], lam: EnergyParams, B: torch.Tensor, dt: float):
    """The settle operator's Jacobi diagonal 1 + dt (λ_G + λ_Q B (+ λ_P))."""
    diag_base = lam.lamG + lam.lamQ * B
    if pg is not None:
        diag_base = diag_base + lam.lamP
    return 1.0 + dt * diag_base


def settle_step_chunked(
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
    col_chunks: int = 2,
    donate_u: bool = False,
):
    """Implicit Euler step with the embedding columns split into chunks: the
    settle analogue of `solve_stationary_chunked`.

    ``donate_u=True`` makes U's buffer the result: chunk c copies its own
    columns of U before the result overwrites them, and the chunks' columns
    are disjoint.  The caller's U then holds U+; pass it only when U is
    being replaced by the result and nothing else holds it."""
    w = _chunk_width(Y.shape[1], col_chunks)
    if donate_u and x0 is U:
        # settle_step's default start (x0 = its U input) is the same vector,
        # and its chunk copy is taken before the chunk's columns are written
        x0 = None
    buf = U if donate_u else torch.empty_like(U, memory_format=torch.contiguous_format)

    def chunk(sl):
        return settle_step(
            g, pg, U[:, sl].contiguous(), Y[:, sl].contiguous(), psi[sl], B, lam, dt, tol,
            max_iters, None if x0 is None else x0[:, sl].contiguous(), use_jacobi,
        )

    return _accumulate_chunks(buf, w, chunk)


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


def solve_stationary_windowed_chunked(
    ctx: WindowCtx,
    Y: torch.Tensor,
    psi: torch.Tensor,
    B: torch.Tensor,
    lam: EnergyParams,
    tol: float = 1e-4,
    max_iters: int = 64,
    col_chunks: int = 2,
    x0: Optional[torch.Tensor] = None,
    fused: bool = False,
):
    """Column-chunked windowed stationary solve: each chunk is
    `solve_stationary_windowed` (or its fused form) at width D/c, one after
    another (`_accumulate_chunks`).  The column slices go in as they are:
    the solve's row permutation copies them into contiguous blocks."""
    w = _chunk_width(Y.shape[1], col_chunks)
    solve = solve_stationary_windowed_fused if fused else solve_stationary_windowed

    def chunk(sl):
        return solve(ctx, Y[:, sl], psi[sl], B, lam, tol, max_iters,
                     None if x0 is None else x0[:, sl])

    return _accumulate_chunks(torch.empty_like(Y, memory_format=torch.contiguous_format), w,
                              chunk)


def settle_step_windowed_chunked(
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
    col_chunks: int = 2,
    fused: bool = False,
):
    """Column-chunked windowed settle: the windowed analogue of
    `settle_step_chunked`, each chunk `settle_step_windowed` (or its fused
    form) at width D/c."""
    w = _chunk_width(Y.shape[1], col_chunks)
    settle = settle_step_windowed_fused if fused else settle_step_windowed

    def chunk(sl):
        return settle(ctx, U[:, sl], Y[:, sl], psi[sl], B, lam, dt, tol, max_iters,
                      None if x0 is None else x0[:, sl], use_jacobi)

    return _accumulate_chunks(torch.empty_like(U, memory_format=torch.contiguous_format), w,
                              chunk)
