"""Explicit-collective row-sharded CG: the all-gather tier (port of
``oscillink_tpu/parallel/shardmap_cg.py``).

Each shard owns a contiguous row block of Y, B and U and its graph rows
(global neighbour ids).  Every operator apply

  1. all-gathers the search direction over the mesh (`mesh.all_gather`:
     mutual-kNN neighbours of unordered rows land anywhere, so the halo is
     effectively every row),
  2. runs kernel K1's ``src`` form on each shard: the shard's rows against
     the gathered direction (`lap_matvec_src`), then the diagonal
     terms;

and every reduction — the first ⟨r, z⟩, then ⟨p, Ap⟩, the column norms and
⟨r, z⟩ in each iteration — is per-shard partials summed in shard order
(`mesh.psum`).  The collective order is fixed by construction, so receipts
do not depend on a scheduler.  The contract is the reference CG's
(epsilons 1e-12 and 1e-18, at least one iteration, termination on the
largest column norm, ``tol`` compared in float32); as in the port's
`cg_solve` the host reads the residual once an iteration.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..models.coherence import EnergyParams
from ..ops.graph import Graph
from ..ops.kernels import spmv
from .mesh import Mesh, all_gather, psum, split_rows

__all__ = ["shardmap_solve", "sharded_cg", "lam_on", "lap_matvec_src", "replicate", "shard_graph",
           "stationary_rhs"]

Blocks = list[torch.Tensor]


def lap_matvec_src(idx: torch.Tensor, wn: torch.Tensor, X: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """A shard's rows of the gather-SpMV: ``X[i] - sum_a wn[i,a] src[idx[i,a]]``
    with ``src`` the [M, D] rows gathered from (the all-gathered direction
    or a received halo frame).  A CUDA tensor goes through K1's ``src`` form
    (it launches or raises); a CPU tensor through its plain version."""
    if X.device.type == "cuda":
        return spmv.lap_matvec_cuda(idx, wn, X, src=src)
    if X.device.type == "cpu":
        return spmv.lap_matvec_ref(idx, wn, X, src=src)
    raise ValueError(f"lap_matvec_src: unsupported device {X.device}")


def lam_on(mesh: Mesh, lam: EnergyParams) -> list[EnergyParams]:
    """``lam`` on each shard's device (shards on one device share it)."""
    per_device: dict[torch.device, EnergyParams] = {}
    out = []
    for dev in mesh.devices:
        if dev not in per_device:
            per_device[dev] = EnergyParams(*(t.to(dev) for t in lam))
        out.append(per_device[dev])
    return out


def stationary_rhs(lams: Sequence[EnergyParams], Y: Blocks, B: Blocks,
                   psi: Blocks) -> tuple[Blocks, Blocks]:
    """Per shard: the right-hand side λ_G Y + λ_Q (B ⊙ 1) ψᵀ and the inverse
    Jacobi diagonal 1 / (λ_G + λ_Q B + 1e-12), as [rows, 1]."""
    rhs = [lm.lamG * y + lm.lamQ * (b[:, None] * p[None, :]) for lm, y, b, p in zip(lams, Y, B, psi)]
    inv_M = [1.0 / ((lm.lamG + lm.lamQ * b)[:, None] + 1e-12) for lm, b in zip(lams, B)]
    return rhs, inv_M


def sharded_cg(mesh: Mesh, M_mul: Callable[[Blocks], Blocks], rhs: Blocks, x0: Blocks,
               inv_M: Blocks, tol: float, max_iters: int) -> tuple[Blocks, int, float]:
    """Jacobi CG over per-shard blocks, the JAX mesh tiers' loop: every
    reduction a `psum` of per-shard column partials, ``res`` the square
    root of the largest column's Σ r², read on the host once an
    iteration.  Returns (x blocks, iterations, residual)."""

    def dot(a: Blocks, b: Blocks) -> Blocks:
        return psum(mesh, [torch.sum(ai * bi, dim=0) for ai, bi in zip(a, b)])

    tol32 = float(np.float32(tol))
    max_iters = int(max_iters)
    x = list(x0)
    Ax = M_mul(x)
    r = [b - a for b, a in zip(rhs, Ax)]
    del Ax
    z = [ri * im for ri, im in zip(r, inv_M)]
    p = z
    rz = dot(r, z)
    it, res = 0, float("inf")
    while it == 0 or (it < max_iters and res > tol32):
        Ap = M_mul(p)
        alpha = [a / (d + 1e-18) for a, d in zip(rz, dot(p, Ap))]
        x = [xi + pi * al for xi, pi, al in zip(x, p, alpha)]
        r = [ri - api * al for ri, api, al in zip(r, Ap, alpha)]
        del Ap
        res_t = torch.sqrt(torch.max(dot(r, r)[0]))
        z = [ri * im for ri, im in zip(r, inv_M)]
        rz_new = dot(r, z)
        beta = [a / (b + 1e-18) for a, b in zip(rz_new, rz)]
        p = [zi + pi * be for zi, pi, be in zip(z, p, beta)]
        rz = rz_new
        it += 1
        res = float(res_t)  # the one host read of the iteration
    return x, it, res


def replicate(mesh: Mesh, x) -> Blocks:
    """A float32 copy of ``x`` (a tensor or numpy array) on every shard's
    device; shards on one device share it."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, dtype=np.float32))
    per_device: dict = {}
    return [per_device.setdefault(dev, t.to(device=dev, dtype=torch.float32))
            for dev in mesh.devices]


def shard_graph(mesh: Mesh, g: Graph) -> tuple[Blocks, Blocks]:
    """The graph's idx and wn rows split into the shards' blocks."""
    return split_rows(mesh, g.idx), split_rows(mesh, g.wn)


def shardmap_solve(
    mesh: Mesh,
    g: Graph,
    Y,
    psi,
    B,
    lam: EnergyParams,
    tol: float = 1e-4,
    max_iters: int = 64,
    axis_name: str = "rows",
) -> tuple[Blocks, int, float]:
    """Stationary solve M U* = λ_G Y + λ_Q B ψᵀ with explicit collectives.

    Y, B and the graph rows are split by rows over ``mesh`` (N must divide
    it); ψ is copied to every shard.  Y, ψ and B may be tensors on any
    device or numpy arrays.  Returns (U* as per-shard blocks, iterations,
    residual)."""
    n = Y.shape[0]
    if n % mesh.size != 0:
        raise ValueError(f"N={n} is not divisible by mesh size {mesh.size}")
    lams = lam_on(mesh, lam)
    Y_l = split_rows(mesh, Y, torch.float32)
    B_l = split_rows(mesh, B, torch.float32)
    psi_l = replicate(mesh, psi)
    idx_l, wn_l = shard_graph(mesh, g)

    def M_mul(p_l: Blocks) -> Blocks:
        p_full = all_gather(mesh, p_l)
        out = []
        for s, lm in enumerate(lams):
            lap = lap_matvec_src(idx_l[s], wn_l[s], p_l[s], p_full[s])
            out.append(lm.lamG * p_l[s] + lm.lamC * lap + lm.lamQ * (B_l[s][:, None] * p_l[s]))
        return out

    rhs, inv_M = stationary_rhs(lams, Y_l, B_l, psi_l)
    return sharded_cg(mesh, M_mul, rhs, Y_l, inv_M, tol, max_iters)
