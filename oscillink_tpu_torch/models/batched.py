"""Batched multi-query solves: one graph, many queries (port of
``oscillink_tpu/models/batched.py``).

The JAX package maps `solve_stationary` over the query axis with
``jax.vmap``; its ``while_loop`` then stops each query at its own trip
count.  The port stacks the queries on a lane axis and runs
`ops.solver.cg_solve_lanes`, which freezes each lane at its own stop, so
every query's iterations and U* are those of its single solve:

* `solve_stationary_batch` — Q queries on one graph as U ``[N, Q, D]``;
  the Laplacian sees one ``[N, Q·D]`` block (kernel K1 on ``cuda``, one
  launch an iteration for all queries);
* `settle_lattice_batch` — B same-shape corpora, each graph built by
  `build_graph`, settled together on their disjoint union (ids offset by
  b·N) as ``[B, N, D]``: the Laplacian sees ``[B·N, D]``;
* `bundle_scores_batch` — per-query bundle scores over the shared graph.

As in the JAX package the batch takes no chain prior and no window context:
with ``OSCILLINK_WINDOWED_MATVEC=1`` the batch still runs on K1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.graph import Graph, build_graph, lap_matvec
from ..ops.receipts import bundle_scores
from ..ops.solver import cg_solve_lanes
from .coherence import EnergyParams

__all__ = [
    "solve_stationary_batch",
    "settle_lattice_batch",
    "bundle_scores_batch",
    "union_graph",
    "lanes_lap_matvec",
    "settle_lanes",
    "solve_stationary_lanes",
]


def union_graph(graphs: list[Graph]) -> Graph:
    """The disjoint union of same-shape graphs: graph b's ids offset by b·N,
    rows stacked in lane order."""
    n = graphs[0].n_nodes
    return Graph(
        idx=torch.cat([g.idx + b * n for b, g in enumerate(graphs)]).contiguous(),
        w=torch.cat([g.w for g in graphs]),
        wn=torch.cat([g.wn for g in graphs]).contiguous(),
        sqrt_deg=torch.cat([g.sqrt_deg for g in graphs]),
    )


def lanes_lap_matvec(g: Graph, X: torch.Tensor, row_dim: int) -> torch.Tensor:
    """L_sym over a lane block through one contiguous 2-D view: rows first
    ``[N, L, D]`` as ``[N, L·D]`` on ``g``; lanes first ``[L, N, D]`` as
    ``[L·N, D]`` on the union graph ``g``."""
    shape = X.shape
    X2 = X.reshape(shape[0], -1) if row_dim == 0 else X.reshape(-1, shape[2])
    return lap_matvec(g, X2).reshape(shape)


def solve_stationary_lanes(g, Y, psi, B, lam, *, row_dim, tol=1e-4, max_iters=64):
    """Stationary solves M U* = λ_G Y + λ_Q B ψᵀ from x0 = Y on a lane block,
    each lane stopped at its own count.  ``Y``, ``psi`` and ``B`` broadcast
    to the block: rows first (``row_dim=0``, one graph ``g``) as Y [N, 1, D],
    ψ [1, Q, D], B [N, Q, 1]; lanes first (``row_dim=1``, ``g`` the union
    graph) as Y [L, N, D], ψ [L, 1, D], B [L, N, 1]."""
    rhs = lam.lamG * Y + lam.lamQ * (B * psi)

    def M_mul(X):
        return lam.lamG * X + lam.lamC * lanes_lap_matvec(g, X, row_dim) + lam.lamQ * (B * X)

    return cg_solve_lanes(M_mul, rhs, x0=Y.expand_as(rhs), M_diag=lam.lamG + lam.lamQ * B,
                          tol=tol, max_iters=max_iters, row_dim=row_dim)


def settle_lanes(g, Y, psi, B, lam, *, row_dim, dt=1.0, tol=1e-3, max_iters=12):
    """Implicit-Euler steps (I + dt M) U+ = Y + dt (λ_G Y + λ_Q B ψᵀ) from
    U = x0 = Y on a lane block, in `solve_stationary_lanes`'s layouts."""
    dt = float(dt)
    rhs = Y + dt * (lam.lamG * Y + lam.lamQ * (B * psi))

    def A_mul(X):
        return X + dt * (lam.lamG * X + lam.lamC * lanes_lap_matvec(g, X, row_dim)
                         + lam.lamQ * (B * X))

    M_diag = 1.0 + dt * (lam.lamG + lam.lamQ * B)
    return cg_solve_lanes(A_mul, rhs, x0=Y.expand_as(rhs), M_diag=M_diag, tol=tol,
                          max_iters=max_iters, row_dim=row_dim)


def solve_stationary_batch(
    g: Graph,
    Y: torch.Tensor,
    psis: torch.Tensor,  # [Q, D]
    Bs: torch.Tensor,  # [Q, N]
    lam: EnergyParams,
    tol: float = 1e-4,
    max_iters: int = 64,
) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """U* for Q queries over one shared graph: M_q U_q = λ_G Y + λ_Q B_q ψ_qᵀ
    from x0 = Y, Jacobi diagonal λ_G + λ_Q B_q.  Returns (U* as a ``[Q, N,
    D]`` view of the ``[N, Q, D]`` solve, iterations [Q], residuals [Q])."""
    U, iters, res = solve_stationary_lanes(g, Y[:, None, :], psis[None], Bs.T[:, :, None], lam,
                                           row_dim=0, tol=tol, max_iters=max_iters)
    return U.permute(1, 0, 2), iters, res


def settle_lattice_batch(
    Ys: torch.Tensor,  # [B, N, D] — a batch of same-shape corpora
    psis: torch.Tensor,  # [B, D]
    Bs: torch.Tensor,  # [B, N]
    lam: EnergyParams,
    k: int,
    dt: float = 1.0,
    tol: float = 1e-3,
    max_iters: int = 12,
) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Batch of lattices: each corpus's graph built by `build_graph` (``k``
    pre-clamped), then one implicit-Euler step from U = Y for all of them
    on their disjoint union.  Returns (U+ [B, N, D], iterations [B],
    residuals [B]); each lane stops at its own count."""
    gu = union_graph([build_graph(Y, k) for Y in Ys])
    return settle_lanes(gu, Ys, psis[:, None, :], Bs[:, :, None], lam, row_dim=1, dt=dt, tol=tol,
                        max_iters=max_iters)


def bundle_scores_batch(
    g: Graph,
    Y: torch.Tensor,
    Ustars: torch.Tensor,  # [Q, N, D]
    psis: torch.Tensor,  # [Q, D]
    lamC: torch.Tensor,
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query bundle scores and alignments over the shared graph:
    ([Q, N], [Q, N])."""
    outs = [bundle_scores(g, Y, Ustars[q], psis[q], lamC, alpha) for q in range(psis.shape[0])]
    return torch.stack([s for s, _ in outs]), torch.stack([a for _, a in outs])
