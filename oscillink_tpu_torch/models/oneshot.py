"""One-shot settle + light receipt (port of ``oscillink_tpu/models/oneshot.py``).

Serving traffic is one-shot by nature: a /v1/settle request carries Y + psi
+ params and wants scalars back.  This module runs the whole pipeline

    mutual-kNN graph build -> implicit-Euler settle -> stationary solve
    -> deltaH trace (light receipt)

on the device and fetches one small scalar pack at the end.  Unlike the JAX
package's single compiled program, the two CG loops still read their
residual on the host once an iteration (`ops.solver.cg_solve`), so the
pack is the one fetch after the solves, not the only device-to-host read.
(Reference pipeline: oscillink/core/lattice.py:33-110, 159-230, 232-290,
298-332.)
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..ops.graph import build_graph
from ..ops.receipts import deltaH_trace
from ..utils.device import DeviceLike, resolve_device
from .coherence import EnergyParams, settle_step, solve_stationary

__all__ = ["fused_settle_receipt", "settle_receipt_light"]


def fused_settle_receipt(
    Y: torch.Tensor,
    psi: torch.Tensor,
    B: torch.Tensor,
    lam: EnergyParams,
    opts: Sequence[float],
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pipeline on Y's device.  ``opts`` packs
    [row_cap, dt, settle_tol, settle_iters, ustar_tol, ustar_iters], each
    rounded to float32 as the JAX package stages them.

    Returns (U_plus, Ustar, scalar_pack), the pack a [6] float32 tensor on
    the device: [deltaH, settle_iters, settle_res, ustar_iters, ustar_res,
    n_edges]."""
    row_cap, dt, s_tol, s_it, u_tol, u_it = (float(np.float32(v)) for v in opts)
    g = build_graph(Y, k, row_cap=row_cap)
    U_plus, s_iters, s_res = settle_step(g, None, Y, Y, psi, B, lam, dt=dt, tol=s_tol,
                                         max_iters=int(s_it))
    Ustar, u_iters, u_res = solve_stationary(g, None, Y, psi, B, lam, tol=u_tol,
                                             max_iters=int(u_it))
    dH = deltaH_trace(g, None, U_plus, Ustar, lam, B)
    n_edges = torch.count_nonzero(g.w > 0) // 2
    solves = torch.tensor([s_iters, s_res, u_iters, u_res], dtype=torch.float32, device=Y.device)
    pack = torch.cat([dH.reshape(1), solves, n_edges.to(torch.float32).reshape(1)])
    return U_plus, Ustar, pack


def settle_receipt_light(
    Y: np.ndarray,
    psi: np.ndarray,
    *,
    kneighbors: int = 6,
    gates: Optional[np.ndarray] = None,
    lamG: float = 1.0,
    lamC: float = 0.5,
    lamQ: float = 4.0,
    row_cap: float = 1.0,
    dt: float = 1.0,
    settle_tol: float = 1e-3,
    settle_max_iters: int = 12,
    ustar_tol: float = 1e-4,
    ustar_max_iters: int = 64,
    device: DeviceLike = None,
) -> dict[str, Any]:
    """Host-facing one-shot on ``device`` (``cuda`` unless the caller asks
    for the CPU): returns the light-receipt scalars as a dict.  The settled
    state and U* never leave the device; the scalar pack is fetched once."""
    dev = resolve_device(device)
    Yd = torch.from_numpy(np.array(Y, dtype=np.float32)).to(dev)
    psid = torch.from_numpy(np.array(psi, dtype=np.float32)).to(dev)
    n = Yd.shape[0]
    if gates is not None:
        Bd = torch.from_numpy(np.clip(np.asarray(gates, dtype=np.float32), 0.0, 1.0)).to(dev)
    else:
        Bd = torch.ones(n, dtype=torch.float32, device=dev)
    k = min(kneighbors, max(1, n - 1))
    lam = EnergyParams.make(lamG, lamC, lamQ, 0.0, device=dev)
    opts = [row_cap, dt, settle_tol, settle_max_iters, ustar_tol, ustar_max_iters]
    _, _, pack = fused_settle_receipt(Yd, psid, Bd, lam, opts, k)
    vals = pack.tolist()
    return {
        "deltaH_total": float(vals[0]),
        "settle_iters": int(vals[1]),
        "settle_res": float(vals[2]),
        "ustar_iters": int(vals[3]),
        "ustar_res": float(vals[4]),
        "edge_count": int(vals[5]),
    }
