"""Ragged batch settle: many different-size corpora in one padded batch
(port of ``oscillink_tpu/models/ragged.py``).

Corpora are zero-padded to one bucket shape.  Zero rows are isolated in the
mutual-kNN build — their similarities are 0, so every incident weight clips
to 0 (`graph_from_topk` keeps only w > 0) — which makes the padded build's
real subgraph identical to each corpus's standalone build: padding can
displace only zero-weight (non-positive-similarity) top-k entries.

Lanes with the same effective k form a group.  Each lane's graph is built by
`build_graph`; the group is settled and solved on the disjoint union of its
graphs (lanes first, ``[L, Npad, D]``) by `cg_solve_lanes`, one K1 launch an
iteration for the whole group, each lane stopped at its own count, as the
JAX package's vmapped solves stop.

The bundle's z-statistics run over each lane's ``n_valid`` prefix (the
reference's z-normalization is over the corpus's own N rows); padded rows
score -inf and are never picked.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..ops.graph import build_graph, mmr_select, normalize_rows
from ..ops.receipts import coherence_drop
from ..utils.device import DeviceLike, resolve_device
from .batched import settle_lanes, solve_stationary_lanes, union_graph
from .coherence import EnergyParams

__all__ = ["bundle_ragged"]

_BUCKET = 64  # pad corpora to a multiple of this


def _ragged_group(Ys, psis, Bs, n_valids, lam, k, bundle_k, alpha, dt, tol, max_iters):
    """Settle, U* and MMR bundle of L padded corpora ``[L, Npad, D]`` that
    share the effective ``k``.  Returns per lane (picks, score, align) and
    the settle's and the U* solve's iterations and residuals."""
    n_lanes, n_pad, d = Ys.shape
    gu = union_graph([build_graph(Y, k) for Y in Ys])
    P, B = psis[:, None, :], Bs[:, :, None]
    _, it_s, res_s = settle_lanes(gu, Ys, P, B, lam, row_dim=1, dt=dt, tol=tol,
                                  max_iters=max_iters)
    Ustar, it_u, res_u = solve_stationary_lanes(gu, Ys, P, B, lam, row_dim=1, tol=tol,
                                                max_iters=max_iters)
    coh = coherence_drop(gu, Ys.reshape(-1, d), Ustar.reshape(-1, d), lam.lamC)
    coh = coh.reshape(n_lanes, n_pad)
    valid = torch.arange(n_pad, device=Ys.device)[None, :] < n_valids[:, None]
    nv = torch.clamp_min(n_valids.to(torch.float32), 1.0)[:, None]
    coh = torch.where(valid, coh, 0.0)
    mu = torch.sum(coh, dim=1, keepdim=True) / nv
    sigma = torch.sqrt(torch.sum(torch.where(valid, (coh - mu) ** 2, 0.0), dim=1, keepdim=True)
                       / nv) + 1e-12
    u_norm = torch.linalg.vector_norm(Ustar, dim=2, keepdim=True) + 1e-12
    psi_n = psis / (torch.linalg.vector_norm(psis, dim=1, keepdim=True) + 1e-12)
    align = torch.where(valid, torch.bmm(Ustar / u_norm, psi_n[:, :, None])[:, :, 0], 0.0)
    score = alpha * ((coh - mu) / sigma) + (1.0 - alpha) * align
    score = torch.where(valid, score, -torch.inf)
    picks = [mmr_select(normalize_rows(Ys[i]), score[i], bundle_k, lambda_div=0.5)
             for i in range(n_lanes)]
    return picks, score, align, (it_s, res_s, it_u, res_u)


def bundle_ragged(
    corpora: Sequence[np.ndarray],
    psis: Sequence[np.ndarray],
    gates: Optional[Sequence[Optional[np.ndarray]]] = None,
    *,
    kneighbors: int = 6,
    lamG: float = 1.0,
    lamC: float = 0.5,
    lamQ: float = 4.0,
    bundle_k: int = 8,
    alpha: float = 0.5,
    dt: float = 1.0,
    tol: float = 1e-3,
    max_iters: int = 12,
    device: DeviceLike = None,
) -> list[dict[str, Any]]:
    """Settle + bundle every corpus, one padded batch per effective k, on
    ``device`` (``cuda`` unless the caller asks for the CPU).

    Returns one dict per corpus: {bundle, iters, res, n} with the same
    bundle entry shape as `OscillinkLattice.bundle`, plus the U* solve's
    ``ustar_iters`` and ``ustar_res``; the bundles are those of serving
    each corpus alone (see the module docstring)."""
    if len(corpora) == 0:
        return []
    if len(psis) != len(corpora):
        raise ValueError("psis must match corpora")
    dev = resolve_device(device)
    d = int(np.asarray(corpora[0]).shape[1])
    ns = [int(np.asarray(c).shape[0]) for c in corpora]
    n_pad = ((max(ns) + _BUCKET - 1) // _BUCKET) * _BUCKET

    b = len(corpora)
    Ys = np.zeros((b, n_pad, d), dtype=np.float32)
    Bs = np.zeros((b, n_pad), dtype=np.float32)
    Ps = np.zeros((b, d), dtype=np.float32)
    for i, (c, p) in enumerate(zip(corpora, psis)):
        c = np.asarray(c, dtype=np.float32)
        if c.shape[1] != d:
            raise ValueError("all corpora must share D")
        Ys[i, : ns[i]] = c
        Ps[i] = np.asarray(p, dtype=np.float32)
        g = None if gates is None else gates[i]
        Bs[i, : ns[i]] = 1.0 if g is None else np.asarray(g, dtype=np.float32)

    kb = min(int(bundle_k), max(ns))
    lam = EnergyParams.make(lamG, lamC, lamQ, 0.0, device=dev)
    alpha = float(np.float32(alpha))
    dt = float(np.float32(dt))

    # each corpus clamps k to its own N-1 (lattice semantics); lanes with
    # the same effective k run as one group so a tiny corpus never changes
    # a larger one's graph
    k_effs = [min(int(kneighbors), max(1, n_i - 1)) for n_i in ns]
    out: list[Optional[dict[str, Any]]] = [None] * b
    for k_eff in sorted(set(k_effs)):
        lanes = [i for i in range(b) if k_effs[i] == k_eff]
        picks, score, align, (iters, res, u_iters, u_res) = _ragged_group(
            torch.from_numpy(Ys[lanes]).to(dev),
            torch.from_numpy(Ps[lanes]).to(dev),
            torch.from_numpy(Bs[lanes]).to(dev),
            torch.tensor([ns[i] for i in lanes], dtype=torch.int32, device=dev),
            lam, k_eff, kb, alpha, dt, tol, max_iters,
        )
        picks = torch.stack(picks).tolist()
        score, align = score.cpu().numpy(), align.cpu().numpy()
        for li, i in enumerate(lanes):
            entries = [
                {"id": int(j), "score": float(score[li, j]), "align": float(align[li, j])}
                for j in picks[li]
                if j < ns[i] and np.isfinite(score[li, j])
            ][: min(kb, ns[i])]
            out[i] = {"bundle": entries, "iters": int(iters[li]), "res": float(res[li]), "n": ns[i],
                      "ustar_iters": int(u_iters[li]), "ustar_res": float(u_res[li])}
    return out  # type: ignore[return-value]
