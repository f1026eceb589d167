"""Row-sharded lattice build, settle, U* and ΔH over a device mesh (port of
``oscillink_tpu/parallel/sharded.py``).

The JAX module jits the single-device program with row shardings and lets
GSPMD partition it.  The port writes that program per shard: the graph
from `sharded_build.build_graph_sharded`, and every solve a `sharded_cg`
over `ShardedOperator`, whose apply is the all-gather tier's (one gather of
the operand, kernel K1's ``src`` form on each shard) plus, for a chain
prior, the path Laplacian's rows.  ΔH is per-shard partials and a `psum`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.coherence import EnergyParams, _path_rows
from ..ops.graph import Graph
from ..ops.path import PathGraph
from .mesh import Mesh, all_gather, psum, split_rows
from .shardmap_cg import (Blocks, lam_on, lap_matvec_src, replicate, shard_graph, sharded_cg,
                          stationary_rhs)

__all__ = ["ShardedOperator", "sharded_settle_fn", "sharded_build_and_settle"]


class ShardedOperator:
    """M = λ_G I + λ_C L_sym + λ_Q B (+ λ_P L_path) on per-shard blocks.

    ``g`` is the full graph (split here by rows), ``B`` the per-shard gate
    blocks and ``pg`` an optional chain-prior path graph over all N rows
    (copied to every shard's device: it is a few edges)."""

    def __init__(self, mesh: Mesh, g: Graph, B: Blocks, lam: EnergyParams,
                 pg: Optional[PathGraph] = None):
        self.mesh = mesh
        self.idx, self.wn = shard_graph(mesh, g)
        self.B = B
        self.lams = lam_on(mesh, lam)
        self.rows = g.idx.shape[0] // mesh.size
        self.pg = None
        if pg is not None:
            per_device: dict = {}
            self.pg = [per_device.setdefault(dev, PathGraph(*(t.to(dev) for t in pg)))
                       for dev in mesh.devices]

    def apply(self, X: Blocks, dt: Optional[float] = None) -> Blocks:
        """M X, or X + dt·M X with ``dt``, each shard's rows from one
        all-gather of X."""
        X_full = all_gather(self.mesh, X)
        chains: dict = {}
        out = []
        for s, lm in enumerate(self.lams):
            lap = lap_matvec_src(self.idx[s], self.wn[s], X[s], X_full[s])
            t = lm.lamG * X[s] + lm.lamC * lap + lm.lamQ * (self.B[s][:, None] * X[s])
            if self.pg is not None:
                t = t + lm.lamP * self._path_block(s, X[s], X_full[s], chains)
            out.append(t if dt is None else X[s] + dt * t)
        return out

    def _path_block(self, s: int, X_s, X_full, chains: dict) -> torch.Tensor:
        """Shard s's rows of L_path X: X's rows, the chain's nodes replaced
        by X − W_path X computed once per device from the gathered rows."""
        pg = self.pg[s]
        if pg.n_edges == 0:
            return X_s
        key = X_full.data_ptr()
        if key not in chains:
            chains[key] = _path_rows(pg, X_full)
        nodes, rows = chains[key]
        lo = s * self.rows
        hit = (nodes >= lo) & (nodes < lo + self.rows)
        lp = X_s.clone()
        lp[nodes[hit] - lo] = rows[hit]
        return lp

    def diag(self, dt: Optional[float] = None) -> Blocks:
        """The Jacobi diagonal λ_G + λ_Q B (+ λ_P), or 1 + dt·(...)."""
        out = []
        for lm, b in zip(self.lams, self.B):
            base = lm.lamG + lm.lamQ * b
            if self.pg is not None:
                base = base + lm.lamP
            out.append(base if dt is None else 1.0 + dt * base)
        return out


def _inv(diag: Blocks) -> Blocks:
    return [1.0 / (d[:, None] + 1e-12) for d in diag]


def mesh_settle(op: ShardedOperator, U: Blocks, Y: Blocks, psi: Blocks, dt: float, tol: float,
                max_iters: int) -> tuple[Blocks, int, float]:
    """One implicit Euler step (I + dt M) U+ = U + dt RHS on the mesh, x0 = U."""
    dt = float(dt)
    rhs = [u + dt * r for u, r in zip(U, stationary_rhs(op.lams, Y, op.B, psi)[0])]
    return sharded_cg(op.mesh, lambda X: op.apply(X, dt), rhs, U, _inv(op.diag(dt)), tol,
                      max_iters)


def mesh_stationary(op: ShardedOperator, Y: Blocks, psi: Blocks, tol: float,
                    max_iters: int) -> tuple[Blocks, int, float]:
    """M U* = RHS on the mesh, x0 = Y."""
    rhs = stationary_rhs(op.lams, Y, op.B, psi)[0]
    return sharded_cg(op.mesh, op.apply, rhs, Y, _inv(op.diag()), tol, max_iters)


def mesh_deltaH(op: ShardedOperator, U: Blocks, Ustar: Blocks) -> torch.Tensor:
    """ΔH = tr((U − U*)ᵀ M (U − U*)): per-shard partials and a psum."""
    diff = [u - us for u, us in zip(U, Ustar)]
    term = op.apply(diff)
    return psum(op.mesh, [torch.sum(d * t) for d, t in zip(diff, term)])[0]


def sharded_settle_fn(mesh: Mesh, k: int, axis_name: str = "rows"):
    """A callable (Y, psi, B, lam, dt, tol, max_iters) -> (U+, U*, ΔH,
    settle iters, settle res, U* iters, U* res) with rows sharded over
    ``mesh``: graph build, settle from Y, stationary solve and ΔH.  U+ and
    U* are per-shard blocks."""
    from .sharded_build import build_graph_sharded

    def fn(Y, psi, B, lam, dt, tol, max_iters):
        g = build_graph_sharded(mesh, Y, k, axis_name=axis_name)
        Y_l = split_rows(mesh, Y, torch.float32)
        B_l = split_rows(mesh, B, torch.float32)
        psi_l = replicate(mesh, psi)
        op = ShardedOperator(mesh, g, B_l, lam)
        U, it_s, res_s = mesh_settle(op, Y_l, Y_l, psi_l, dt, tol, max_iters)
        Ustar, it_u, res_u = mesh_stationary(op, Y_l, psi_l, tol, max_iters)
        dH = mesh_deltaH(op, U, Ustar)
        return U, Ustar, dH, it_s, res_s, it_u, res_u

    return fn


def sharded_build_and_settle(
    Y,
    psi,
    B=None,
    *,
    k: int = 6,
    lamG: float = 1.0,
    lamC: float = 0.5,
    lamQ: float = 4.0,
    dt: float = 1.0,
    tol: float = 1e-3,
    max_iters: int = 12,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
):
    """One-call sharded build + settle + receipt over ``mesh`` (default:
    every visible CUDA device).  Returns a dict with U (settled) and Ustar
    as per-shard blocks, deltaH, and the CG diagnostics."""
    from .mesh import lattice_mesh

    if mesh is None:
        mesh = lattice_mesh(axis_name=axis_name)
    Y = np.asarray(Y, dtype=np.float32)
    psi = np.asarray(psi, dtype=np.float32)
    n = Y.shape[0]
    B = np.ones(n, dtype=np.float32) if B is None else np.asarray(B, dtype=np.float32)
    if n % mesh.size != 0:
        raise ValueError(f"N={n} must be divisible by mesh size {mesh.size}")
    lam = EnergyParams.make(lamG, lamC, lamQ, 0.0, device=mesh.devices[0])
    k = min(int(k), max(1, n - 1))  # build_graph's precondition
    U, Ustar, dH, it_s, res_s, it_u, res_u = sharded_settle_fn(mesh, k, axis_name)(
        Y, psi, B, lam, dt, tol, max_iters)
    return {
        "U": U,
        "Ustar": Ustar,
        "deltaH": float(dH),
        "settle_iters": int(it_s),
        "settle_res": float(res_s),
        "ustar_iters": int(it_u),
        "ustar_res": float(res_u),
        "mesh_devices": int(mesh.size),
    }
