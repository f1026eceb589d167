"""Screened-diffusion gate preprocessor (port of
``oscillink_tpu/preprocess/diffusion.py``).

Solves the screened Poisson problem over the anchor graph
(reference: oscillink/preprocess/diffusion.py:35-163):

    (L_sym + gamma I) h = beta * max(0, cos(Y, psi))

and min-max normalizes h to [0, 1] for use as per-node query gates.

The graph is the lattice's k-sparse structure and the solve is Jacobi-CG
over `ops.graph.lap_matvec` (kernel K1 on ``cuda``, at D = 1; the batch
solves Q right-hand sides as one ``[N, Q]`` block, each column a lane of
`cg_solve_lanes`, so K1 runs at D = Q).  ``method="direct"`` is honoured for
N <= 4096 by a dense solve of the densified operator (`torch.linalg.solve`,
as the JAX package uses ``jnp.linalg.solve``); above that it takes CG.

Fallbacks are numerical only: a non-finite h, a lane whose h is not finite,
and a singular dense system (`torch.linalg.LinAlgError`) give uniform ones.
Any other error — a kernel that fails to build or launch among them —
raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.graph import Graph, build_graph, lap_matvec, normalize_rows
from ..ops.solver import cg_solve, cg_solve_lanes
from ..utils.device import DeviceLike, resolve_device

__all__ = [
    "compute_diffusion_gates",
    "compute_diffusion_gates_from_graph",
    "compute_diffusion_gates_from_graph_batch",
    "gates_from_graph",
    "gates_from_graph_batch",
    "screened_solve",
    "diffusion_sources",
]

_DENSE_DIRECT_LIMIT = 4096


def _f32(v: float) -> float:
    """A number as the JAX package stages it: rounded to float32."""
    return float(np.float32(v))


def _normalize_gates(h: np.ndarray, n: int) -> np.ndarray:
    """Min-max normalize to [0, 1] with the uniform-ones fallback on a
    degenerate spread."""
    h_min, h_max = float(np.min(h)), float(np.max(h))
    if h_max - h_min < 1e-12:
        return np.ones(n, dtype=np.float32)
    return ((h - h_min) / (h_max - h_min)).astype(np.float32)


def diffusion_sources(Y: torch.Tensor, psis: np.ndarray, beta: float) -> torch.Tensor:
    """[N, Q] right-hand sides beta * max(0, cos(Y, psi_q)) for [Q, D]
    queries, on Y's device."""
    P = torch.from_numpy(np.asarray(psis, dtype=np.float32)).to(Y.device)
    P = P / (torch.linalg.vector_norm(P, dim=1, keepdim=True) + 1e-12)
    return _f32(beta) * torch.clamp_min(normalize_rows(Y) @ P.T, 0.0)


def screened_solve(g: Graph, S: torch.Tensor, gamma: float, tol: float, max_iters: int):
    """H = (L_sym + gamma I)^-1 S by Jacobi CG from 0; diag(L_sym) = 1 (the
    mutual-kNN graph has no self loops).  ``S`` [N] is one solve
    (`cg_solve`, K1 at D = 1); ``S`` [N, Q] is Q solves, each column a lane
    of `cg_solve_lanes` (K1 at D = Q), each stopped at its own count.
    Returns (H, iterations, residuals): host numbers for [N], [Q] arrays
    for [N, Q]."""
    gamma = _f32(gamma)
    n = S.shape[0]
    if S.dim() == 1:
        M_diag = torch.full((n,), 1.0 + gamma, dtype=torch.float32, device=S.device)
        return cg_solve(lambda x: lap_matvec(g, x) + gamma * x, S, x0=None, M_diag=M_diag,
                        tol=tol, max_iters=max_iters)
    q = S.shape[1]

    def A_mul(x):  # [N, Q, 1]: K1 reads the [N, Q] block
        return lap_matvec(g, x.reshape(n, q)).reshape(n, q, 1) + gamma * x

    M_diag = torch.full((n, 1, 1), 1.0 + gamma, dtype=torch.float32, device=S.device)
    H, iters, res = cg_solve_lanes(A_mul, S.reshape(n, q, 1), M_diag=M_diag, tol=tol,
                                   max_iters=max_iters, row_dim=0)
    return H.reshape(n, q), iters, res


def _finish(h: torch.Tensor, n: int, clamp: bool) -> np.ndarray:
    h = h.cpu().numpy()
    if not np.all(np.isfinite(h)):
        return np.ones(n, dtype=np.float32)
    if clamp:
        h = _normalize_gates(h, n)
    return np.clip(h, 0.0, 1.0).astype(np.float32)


def compute_diffusion_gates_from_graph_batch(
    g: Graph,
    Y_dev: torch.Tensor,
    psis: np.ndarray,  # [Q, D]
    *,
    beta: float = 1.0,
    gamma: float = 0.1,
    tol: float = 1e-4,
    max_iters: int = 256,
) -> np.ndarray:
    """[Q, N] gates for Q queries over an already-built graph, on its
    device.  The Q right-hand sides are one ``[N, Q]`` block, each column
    its own lane of `cg_solve_lanes` (own iterations, frozen at its own
    stop); per-query semantics are those of
    `compute_diffusion_gates_from_graph` (normalize, uniform ones on a
    degenerate spread or a non-finite lane)."""
    return gates_from_graph_batch(g, Y_dev, psis, beta=beta, gamma=gamma, tol=tol,
                                  max_iters=max_iters)[0]


def gates_from_graph_batch(g, Y_dev, psis, *, beta, gamma, tol, max_iters):
    """`compute_diffusion_gates_from_graph_batch`, also returning the
    solve's per-query iterations and residuals ([Q] host arrays)."""
    if gamma <= 0:
        raise ValueError("gamma must be > 0 for SPD")
    psis = np.asarray(psis, dtype=np.float32)
    q = int(psis.shape[0])
    n, d = int(Y_dev.shape[0]), int(Y_dev.shape[1])
    if psis.ndim != 2 or psis.shape[1] != d:
        raise ValueError(f"psis must have shape [Q, {d}], got {psis.shape}")
    H, iters, res = screened_solve(g, diffusion_sources(Y_dev, psis, beta), gamma, tol, max_iters)
    H = H.T
    finite = torch.isfinite(H).all(dim=1, keepdim=True)
    h_min = H.amin(dim=1, keepdim=True)
    spread = H.amax(dim=1, keepdim=True) - h_min
    hn = torch.where(spread < 1e-12, 1.0, (H - h_min) / torch.clamp_min(spread, 1e-12))
    out = torch.where(finite, torch.clamp(hn, 0.0, 1.0), 1.0)
    return out.cpu().numpy().astype(np.float32), iters, res


def compute_diffusion_gates_from_graph(
    g: Graph,
    Y_dev: torch.Tensor,
    psi: np.ndarray,
    *,
    beta: float = 1.0,
    gamma: float = 0.1,
    tol: float = 1e-4,
    max_iters: int = 256,
    clamp: bool = True,
) -> np.ndarray:
    """Screened-diffusion gates over an already-built lattice graph, on its
    device (CG only; the similarity scan is paid once, by the lattice).
    Uniform ones where h is not finite."""
    return gates_from_graph(g, Y_dev, psi, beta=beta, gamma=gamma, tol=tol,
                            max_iters=max_iters, clamp=clamp)[0]


def gates_from_graph(g, Y_dev, psi, *, beta, gamma, tol, max_iters, clamp=True):
    """`compute_diffusion_gates_from_graph`, also returning the solve's
    iterations and residual (host numbers)."""
    if gamma <= 0:
        raise ValueError("gamma must be > 0 for SPD")
    n, d = int(Y_dev.shape[0]), int(Y_dev.shape[1])
    psi = np.asarray(psi, dtype=np.float32)
    if psi.shape != (d,):
        raise ValueError(f"psi must have shape ({d},), got {psi.shape}")
    s = diffusion_sources(Y_dev, psi[None], beta)[:, 0]
    h, iters, res = screened_solve(g, s, gamma, tol, max_iters)
    return _finish(h, n, clamp), iters, res


def compute_diffusion_gates(
    Y: np.ndarray,
    psi: np.ndarray,
    *,
    kneighbors: int = 6,
    row_cap_val: float = 1.0,
    beta: float = 1.0,
    gamma: float = 0.1,
    similarity: str = "cosine",
    deterministic_k: bool = False,
    neighbor_seed: Optional[int] = None,
    clamp: bool = True,
    method: str = "direct",
    tol: float = 1e-4,
    max_iters: int = 256,
    device: DeviceLike = None,
) -> np.ndarray:
    """Compute screened diffusion gates h in [0, 1] for `set_query(psi, gates=h)`.

    Builds its own mutual-kNN graph on ``device`` (``cuda`` unless the
    caller asks for the CPU).  Validation and defaults mirror the reference
    (diffusion.py:35-124); a non-finite h or a singular dense system gives
    uniform ones."""
    Y = np.asarray(Y)
    psi = np.asarray(psi)
    if Y.ndim != 2:
        raise ValueError("Y must be 2D")
    N, D = Y.shape
    if psi.shape[0] != D:
        raise ValueError("psi dimension mismatch")
    if gamma <= 0:
        raise ValueError("gamma must be > 0 for SPD")
    if kneighbors < 1:
        raise ValueError("kneighbors must be >=1")
    if similarity != "cosine":
        raise ValueError("unsupported similarity metric")
    dev = resolve_device(device)

    k_eff = min(int(kneighbors), max(1, N - 1))
    jitter = None
    if neighbor_seed is not None and not deterministic_k:
        if N > _DENSE_DIRECT_LIMIT:
            raise ValueError(
                f"neighbor_seed requires N <= {_DENSE_DIRECT_LIMIT} in "
                "compute_diffusion_gates (dense jitter path)"
            )
        rng = np.random.default_rng(neighbor_seed)
        jitter = torch.from_numpy(rng.uniform(-1e-8, 1e-8, size=(N, N)).astype(np.float32)).to(dev)

    Yd = torch.from_numpy(Y.astype(np.float32)).to(dev)
    g = build_graph(Yd, k_eff, row_cap=_f32(row_cap_val), jitter=jitter)
    s = diffusion_sources(Yd, psi[None], beta)[:, 0]
    if method == "direct" and N <= _DENSE_DIRECT_LIMIT:
        # densify L_sym + gamma I from the sparse rows (small N only)
        W = torch.zeros((N, N), dtype=torch.float32, device=dev)
        rows = torch.arange(N, device=dev)[:, None].expand_as(g.idx)
        W.index_put_((rows, g.idx.long()), g.wn, accumulate=True)
        eye = torch.eye(N, dtype=torch.float32, device=dev)
        try:
            h = torch.linalg.solve(eye - W + _f32(gamma) * eye, s)
        except torch.linalg.LinAlgError:
            return np.ones(N, dtype=np.float32)
    else:
        h = screened_solve(g, s, gamma, tol, max_iters)[0]
    return _finish(h, N, clamp)
