"""Hierarchical lattice-of-lattices: the scale-out composition contract
(port of ``oscillink_tpu/parallel/hierarchical.py``).

Shard the anchors into equal row blocks, settle each shard locally, take a
query-gate-weighted summary embedding per shard, solve a super-lattice over
the summaries, and compose the receipts (docs/SCALING.md):

* each shard's graph build and stationary solve is `shard_solve_body`, the
  port's `build_graph` and `solve_stationary`, so on the card every shard
  operator apply is one launch of kernel K1.  The JAX package maps the body
  over a stacked [S, n_s, D] array (``lax.map``); here it is a loop over
  the shards, in shard order;
* the super-lattice runs the same coherence model over the S summaries;
* the composed receipt carries per-shard ΔH, the super-level ΔH, per-shard
  alignment and a deterministic composition signature, each shard receipt
  (and the composed one) optionally HMAC-signed on its own
  (`core.receipts.sign_component`).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Optional

import numpy as np
import torch

from ..models.coherence import EnergyParams, solve_stationary
from ..ops.graph import build_graph
from ..utils.device import DeviceLike, resolve_device

__all__ = ["hierarchical_settle", "shard_solve_body", "composition_sig"]


def shard_solve_body(Y_s: torch.Tensor, psi: torch.Tensor, B_s: torch.Tensor,
                     lam: EnergyParams, k: int, tol: float, max_iters: int):
    """One shard's local solve — the shared definition of the composition
    contract's per-shard receipt (graph build, stationary solve, energy drop
    proxy, gate-weighted summary, alignment), used by `hierarchical_settle`
    and by the streaming tier's micro-solve, so the two cannot drift apart.
    Returns (U*, summary, ΔH, align) as tensors and (iters, res) as host
    numbers."""
    g = build_graph(Y_s, k)
    Ustar, iters, res = solve_stationary(g, None, Y_s, psi, B_s, lam, tol=tol,
                                         max_iters=max_iters)
    diff = Ustar - Y_s
    dH = torch.sum(diff * (lam.lamG * diff))
    wsum = torch.sum(B_s) + 1e-12
    summary = torch.sum(Ustar * B_s[:, None], dim=0) / wsum
    align = torch.dot(
        summary / (torch.linalg.vector_norm(summary) + 1e-12),
        psi / (torch.linalg.vector_norm(psi) + 1e-12),
    )
    return Ustar, summary, dH, align, iters, res


def _super_solve(summaries: torch.Tensor, psi: torch.Tensor, lam: EnergyParams, k: int,
                 tol: float, max_iters: int):
    B = torch.ones(summaries.shape[0], dtype=torch.float32, device=summaries.device)
    g = build_graph(summaries, k)
    Ustar, iters, res = solve_stationary(g, None, summaries, psi, B, lam, tol=tol,
                                         max_iters=max_iters)
    diff = Ustar - summaries
    dH = torch.sum(diff * (lam.lamG * diff))
    u_n = Ustar / (torch.linalg.vector_norm(Ustar, dim=1, keepdim=True) + 1e-12)
    psi_n = psi / (torch.linalg.vector_norm(psi) + 1e-12)
    return Ustar, u_n @ psi_n, dH, iters, res


def composition_sig(n_shards: int, deltaH, super_deltaH: float, super_align) -> str:
    """SHA-256 over the rounded shard and super-level values (6 decimals)."""
    return hashlib.sha256(
        json.dumps(
            {
                "shards": n_shards,
                "deltaH": [round(float(x), 6) for x in deltaH],
                "super_deltaH": round(float(super_deltaH), 6),
                "super_align": [round(float(x), 6) for x in super_align],
            },
            sort_keys=True,
        ).encode()
    ).hexdigest()


def hierarchical_settle(
    Y: np.ndarray,
    psi: np.ndarray,
    gates: Optional[np.ndarray] = None,
    *,
    n_shards: int = 8,
    kneighbors: int = 6,
    super_k: int = 3,
    lamG: float = 1.0,
    lamC: float = 0.5,
    lamQ: float = 4.0,
    tol: float = 1e-4,
    max_iters: int = 64,
    receipt_secret: Optional[bytes | str] = None,
    device: DeviceLike = None,
) -> dict[str, Any]:
    """Shard -> local settle -> summary super-lattice -> composed receipt,
    on ``device`` (``cuda`` unless given).

    N must be divisible by ``n_shards``.  Returns the composed receipt plus
    per-shard diagnostics, the settled U* per shard (``Ustar_shards``,
    [S, n_s, D]) and the summaries.  With ``receipt_secret`` every shard
    receipt and the composed receipt carry HMAC blocks."""
    dev = resolve_device(device)
    Y = np.asarray(Y, dtype=np.float32)
    psi = np.asarray(psi, dtype=np.float32)
    n, d = Y.shape
    if n % n_shards != 0:
        raise ValueError(f"N={n} not divisible by n_shards={n_shards}")
    ns = n // n_shards
    gates = np.ones(n, dtype=np.float32) if gates is None else np.asarray(gates, dtype=np.float32)

    lam = EnergyParams.make(lamG, lamC, lamQ, 0.0, device=dev)
    psi_d = torch.from_numpy(psi).to(dev)
    k_local = min(kneighbors, max(1, ns - 1))
    Ustars, summaries, dHs, aligns, iters_s, res_s = [], [], [], [], [], []
    for s in range(n_shards):
        Y_s = torch.from_numpy(np.ascontiguousarray(Y[s * ns:(s + 1) * ns])).to(dev)
        B_s = torch.from_numpy(np.ascontiguousarray(gates[s * ns:(s + 1) * ns])).to(dev)
        U_s, summ, dH, align, it, res = shard_solve_body(Y_s, psi_d, B_s, lam, k_local,
                                                         tol, max_iters)
        Ustars.append(U_s)
        summaries.append(summ)
        dHs.append(dH)
        aligns.append(align)
        iters_s.append(it)
        res_s.append(res)
    summaries = torch.stack(summaries)

    k_super = min(super_k, max(1, n_shards - 1))
    _, super_align, super_dH, s_iters, s_res = _super_solve(summaries, psi_d, lam, k_super, tol,
                                                            max_iters)
    dHs = torch.stack(dHs).cpu().numpy()
    aligns = torch.stack(aligns).cpu().numpy()
    super_align = super_align.cpu().numpy()
    super_dH = float(super_dH)

    shard_receipts = [
        {
            "shard": int(s),
            "deltaH": float(dHs[s]),
            "align": float(aligns[s]),
            "iters": int(iters_s[s]),
            "res": float(res_s[s]),
        }
        for s in range(n_shards)
    ]
    if receipt_secret is not None:
        from ..core.receipts import sign_component

        for r in shard_receipts:
            r["signature"] = sign_component(dict(r), receipt_secret)
    order = np.argsort(-super_align).tolist()

    out = {
        "n_shards": n_shards,
        "shard_receipts": shard_receipts,
        "deltaH_composed": float(np.sum(dHs)) + super_dH,
        "super": {
            "deltaH": super_dH,
            "align": [float(a) for a in super_align],
            "ranking": [int(i) for i in order],
            "iters": int(s_iters),
            "res": float(s_res),
        },
        "composition_sig": composition_sig(n_shards, dHs, super_dH, super_align),
        "Ustar_shards": torch.stack(Ustars),
        "summaries": summaries,
    }
    if receipt_secret is not None:
        from ..core.receipts import sign_component

        # every JSON-serialisable field is signed; the tensors stay out
        out["signature"] = sign_component(
            {k: v for k, v in out.items() if k not in ("Ustar_shards", "summaries")},
            receipt_secret,
        )
    return out
