"""Receipt diagnostics, edge-parallel and never O(N^2) (port of ``oscillink_tpu/ops/receipts.py``).

Behavioral contracts from the reference (oscillink/core/receipts.py):
  * deltaH_trace (receipts.py:10-25): one operator application + full sum.
  * per_node_components (receipts.py:28-60): one gather + reduction.
  * null_points (receipts.py:63-83): residuals live only on the k-sparse
    edges, but row mean/std are taken over ALL N columns (zeros included) to
    reproduce the reference's z-scores exactly:
        mu_i    = sum_j R_ij / N
        sigma_i = sqrt(E[R^2] - mu^2) + 1e-12
    and the zero (non-edge) entries have z = -mu/sigma <= any edge z, so the
    per-row argmax over the dense row equals the max over the sparse edges.
  * chain edge stats (lattice.py:466-515) reuse the same sparse row moments.

`receipt_full_chunked` is the full receipt's sums over column slices: the
stationary operator and the anchor and query terms act per column, so ΔH
and the per-row sums accumulate over D/c columns at a time, and no
full-width [N, D] temporary is made.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.coherence import EnergyParams, stationary_matvec
from .graph import Graph, stable_topk
from .path import PathGraph

__all__ = [
    "deltaH_trace",
    "per_node_components",
    "receipt_full_chunked",
    "coherence_drop",
    "null_points_sparse",
    "chain_edge_stats",
    "bundle_scores",
    "dynamics_core",
    "deltaH_trace_deterministic",
    "deltaH_tree_np",
]


def deltaH_trace(
    g: Graph,
    pg: Optional[PathGraph],
    U: torch.Tensor,
    Ustar: torch.Tensor,
    lam: EnergyParams,
    B: torch.Tensor,
) -> torch.Tensor:
    """deltaH = tr((U - U*)^T M (U - U*)) via one operator application."""
    diff = (U - Ustar).to(torch.float32)
    term = stationary_matvec(g, pg, lam, B, diff)
    return torch.sum(diff * term)


def _deg_normalized(g: Graph, X: torch.Tensor) -> torch.Tensor:
    return X / (g.sqrt_deg[:, None] + 1e-12)


# direct-path budget for the [N, K, D] gathered-neighbor temp; above it the
# edge distances are computed in row blocks (131072 x 8 x 768 f32 is 3.2 GB
# direct, 201 MB per 8192-row block)
_EDGE_TEMP_BUDGET_BYTES = 1 << 30
_EDGE_BLOCK_ROWS = 8192


def _edge_sq_dists(
    g: Graph, X: torch.Tensor, inv_row_scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[N, K] squared distances ||s_i X_i - s_j X_j||^2 along graph edges,
    with optional per-row scaling s = ``inv_row_scale``.  Row-blocked above
    the temp budget; the scaling is applied inside each block, so both
    regimes compute the same f32 values."""
    n, d = X.shape
    k = g.idx.shape[1]
    idx = g.idx.long()
    if 4 * n * k * d <= _EDGE_TEMP_BUDGET_BYTES or n <= _EDGE_BLOCK_ROWS:
        Xn = X if inv_row_scale is None else X * inv_row_scale[:, None]
        diff = Xn[:, None, :] - Xn[idx]
        return torch.sum(diff * diff, dim=-1).to(torch.float32)

    out = torch.empty((n, k), dtype=torch.float32, device=X.device)
    for r0 in range(0, n, _EDGE_BLOCK_ROWS):
        r1 = min(r0 + _EDGE_BLOCK_ROWS, n)
        ib = idx[r0:r1]
        xb = X[r0:r1]
        xg = X[ib]
        if inv_row_scale is not None:
            xb = xb * inv_row_scale[r0:r1, None]
            xg = xg * inv_row_scale[ib][:, :, None]
        diff = xb[:, None, :] - xg
        out[r0:r1] = torch.sum(diff * diff, dim=-1)
    return out


def _inv_sqrt_deg(g: Graph) -> torch.Tensor:
    return 1.0 / (g.sqrt_deg + 1e-12)


def coherence_drop(
    g: Graph, Y: torch.Tensor, Ustar: torch.Tensor, lamC: torch.Tensor
) -> torch.Tensor:
    """Per-node coherence drop (reference receipts.py:44-55, lattice.py:803-822):
    coh_i = sum_j 0.5 lamC w_ij (||Yn_i - Yn_j||^2 - ||Un_i - Un_j||^2)."""
    inv = _inv_sqrt_deg(g)
    dy2 = _edge_sq_dists(g, Y, inv)
    du2 = _edge_sq_dists(g, Ustar, inv)
    return torch.sum(0.5 * lamC * g.w * (dy2 - du2), dim=1)


def per_node_components(
    g: Graph,
    Y: torch.Tensor,
    Ustar: torch.Tensor,
    lam: EnergyParams,
    B: torch.Tensor,
    psi: torch.Tensor,
):
    """(coh_drop, anchor_pen, query_term) per node (receipts.py:28-60)."""
    coh = coherence_drop(g, Y, Ustar, lam.lamC)
    anchor_pen = lam.lamG * torch.sum((Ustar - Y) ** 2, dim=1)
    qp = Ustar - psi[None, :]
    query_term = lam.lamQ * B * torch.sum(qp * qp, dim=1)
    return coh, anchor_pen, query_term


def receipt_full_chunked(
    g: Graph,
    pg: Optional[PathGraph],
    U: torch.Tensor,
    Ustar: torch.Tensor,
    lam: EnergyParams,
    B: torch.Tensor,
    Y: torch.Tensor,
    psi: torch.Tensor,
    col_chunks: int,
):
    """(ΔH, Σ coh_drop, Σ anchor_pen, Σ query_term) of the full receipt with
    the columns in ``col_chunks`` slices (port of the JAX lattice's
    ``_jit_receipt_full_chunked``).  Each slice's operator apply is one
    `stationary_matvec` at width D/c (kernel K1 on the card, plus the chain
    term); the coherence drop stays full width on the row-blocked edge
    distances.  ``col_chunks`` must divide D."""
    n, d = U.shape
    if d % col_chunks != 0:
        raise ValueError(f"D={d} must divide col_chunks={col_chunks}")
    w = d // col_chunks
    dH = torch.zeros((), dtype=torch.float32, device=U.device)
    anchor_vec = torch.zeros(n, dtype=torch.float32, device=U.device)
    query_vec = torch.zeros(n, dtype=torch.float32, device=U.device)
    for c in range(col_chunks):
        sl = slice(c * w, (c + 1) * w)
        us = Ustar[:, sl]
        diff = U[:, sl] - us
        dH = dH + torch.sum(diff * stationary_matvec(g, pg, lam, B, diff))
        del diff
        av = us - Y[:, sl]
        anchor_vec += torch.sum(av * av, dim=1)
        qp = us - psi[None, sl]
        query_vec += torch.sum(qp * qp, dim=1)
        del av, qp
    anchor_sum = lam.lamG * torch.sum(anchor_vec)
    query_sum = torch.sum(lam.lamQ * B * query_vec)
    coh = coherence_drop(g, Y, Ustar, lam.lamC)
    return dH, torch.sum(coh), anchor_sum, query_sum


class SparseRowStats(NamedTuple):
    """Row moments of an edge-sparse residual matrix taken over N dense columns."""

    R: torch.Tensor  # [N, K] edge residuals
    mu: torch.Tensor  # [N]
    sigma: torch.Tensor  # [N]


def _row_stats_over_dense(R: torch.Tensor, n_cols: int) -> SparseRowStats:
    s1 = torch.sum(R, dim=1)
    s2 = torch.sum(R * R, dim=1)
    mu = s1 / n_cols
    var = torch.clamp_min(s2 / n_cols - mu * mu, 0.0)
    sigma = torch.sqrt(var) + 1e-12
    return SparseRowStats(R=R, mu=mu, sigma=sigma)


def structural_residuals(g: Graph, Ustar: torch.Tensor, lamC: torch.Tensor) -> SparseRowStats:
    """R_ij = lamC * w_ij * ||Un_i - Un_j||^2 with dense-row moments."""
    d2 = _edge_sq_dists(g, Ustar, _inv_sqrt_deg(g))
    return _row_stats_over_dense(lamC * g.w * d2, g.n_nodes)


def null_points_sparse(g: Graph, Ustar: torch.Tensor, lamC: torch.Tensor, z_th: float = 3.0):
    """Anomalous-edge detection (receipts.py:63-83), edge-sparse.

    Returns (flag[N] bool, j[N] int32, z[N], r[N]): per row, the argmax-z edge
    with flag set when r > 0 and z > z_th."""
    st = structural_residuals(g, Ustar, lamC)
    # argmax over the dense row == edge with max residual (zeros have minimal z)
    slot = torch.argmax(st.R, dim=1, keepdim=True)
    r_best = torch.gather(st.R, 1, slot)[:, 0]
    z_best = (r_best - st.mu) / st.sigma
    j_best = torch.gather(g.idx, 1, slot)[:, 0]
    flag = (r_best > 0) & (z_best > z_th)
    return flag, j_best, z_best, r_best


def _edge_weight_lookup(g: Graph, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """w_ij for query edges (i[e], j[e]) — 0 when absent from row i."""
    hit = g.idx[i] == j[:, None]
    return torch.sum(torch.where(hit, g.w[i], 0.0), dim=1)


def chain_edge_stats(
    g: Graph,
    pg: PathGraph,
    Ustar: torch.Tensor,
    Y: torch.Tensor,
    lamC: torch.Tensor,
    ci: torch.Tensor,
    cj: torch.Tensor,
):
    """Per-chain-edge z-scores and residuals (reference lattice.py:466-515).
    Returns (z_struct, z_path, r_struct, r_path, gain_terms) each [E]."""
    n = g.n_nodes
    Un = _deg_normalized(g, Ustar)
    st = structural_residuals(g, Ustar, lamC)

    # path residuals R_p = max(lamC, 1e-6) * A_path * d2 over path edges
    lamC_p = torch.clamp_min(lamC, 1e-6)
    src, dst = pg.src.long(), pg.dst.long()
    dsq_path = torch.sum((Un[src] - Un[dst]) ** 2, dim=1)
    Rp = lamC_p * pg.w * dsq_path
    Rp_dst = torch.where(src == dst, 0.0, Rp)
    zeros = torch.zeros(n, dtype=torch.float32, device=Ustar.device)
    s1 = zeros.index_add(0, src, Rp).index_add(0, dst, Rp_dst)
    s2 = zeros.index_add(0, src, Rp**2).index_add(0, dst, torch.where(src == dst, 0.0, Rp**2))
    mu_p = s1 / n
    var_p = torch.clamp_min(s2 / n - mu_p * mu_p, 0.0)
    sig_p = torch.sqrt(var_p) + 1e-12

    d2_c = torch.sum((Un[ci] - Un[cj]) ** 2, dim=1)
    w_c = _edge_weight_lookup(g, ci, cj)
    r_struct = lamC * w_c * d2_c
    z_struct = (r_struct - st.mu[ci]) / st.sigma[ci]

    key_i = torch.minimum(ci, cj)
    key_j = torch.maximum(ci, cj)
    hit = (pg.src[None, :] == key_i[:, None]) & (pg.dst[None, :] == key_j[:, None])
    wp_c = torch.sum(torch.where(hit, pg.w[None, :], 0.0), dim=1)
    r_path = lamC_p * wp_c * d2_c
    z_path = (r_path - mu_p[ci]) / sig_p[ci]

    di = g.sqrt_deg + 1e-12
    Ynorm = Y / di[:, None]
    ydiff2 = torch.sum((Ynorm[ci] - Ynorm[cj]) ** 2, dim=1)
    gain_terms = 0.5 * lamC * torch.clamp_min(w_c, 0.0) * (ydiff2 - d2_c)
    return z_struct, z_path, r_struct, r_path, gain_terms


def bundle_scores(
    g: Graph,
    Y: torch.Tensor,
    Ustar: torch.Tensor,
    psi: torch.Tensor,
    lamC: torch.Tensor,
    alpha: float,
):
    """score = alpha * z(coherence_drop) + (1 - alpha) * cos(U*, psi)
    (reference lattice.py:530-568). Returns (score[N], align[N])."""
    u_norm = torch.linalg.vector_norm(Ustar, dim=1, keepdim=True) + 1e-12
    psi_n = psi / (torch.linalg.vector_norm(psi) + 1e-12)
    align = (Ustar / u_norm) @ psi_n
    coh = coherence_drop(g, Y, Ustar, lamC)
    mu = torch.mean(coh)
    sigma = torch.std(coh, correction=0) + 1e-12
    z = (coh - mu) / sigma
    score = alpha * z + (1.0 - alpha) * align
    return score, align


def dynamics_core(
    g: Graph,
    pg: Optional[PathGraph],
    U_prev: torch.Tensor,
    U_next: torch.Tensor,
    lam: EnergyParams,
    B: torch.Tensor,
    top_k_flows: int = 16,
):
    """Single-step dynamics snapshot (reference lattice.py:824-903).

    Returns (move2[N], dH_step, flow_total, top_flow_vals[T], top_flow_i[T],
    top_flow_j[T]); edge flows f_ij = max(0, e_prev - e_next) with
    e = 0.5 lamC w ||Xn_i - Xn_j||^2."""
    dU = (U_next - U_prev).to(torch.float32)
    move2 = torch.sum(dU * dU, dim=1)
    dH_step = deltaH_trace(g, pg, U_prev, U_next, lam, B)

    inv = _inv_sqrt_deg(g)
    e_prev = 0.5 * lam.lamC * g.w * _edge_sq_dists(g, U_prev, inv)
    e_next = 0.5 * lam.lamC * g.w * _edge_sq_dists(g, U_next, inv)
    flow = torch.where(g.w > 0, torch.clamp_min(e_prev - e_next, 0.0), 0.0)
    flow_total = torch.sum(flow)

    flat = flow.reshape(1, -1)
    t = min(top_k_flows, flat.shape[1])
    vals, pos = stable_topk(flat, t)
    vals, pos = vals[0], pos[0]
    fi = pos // g.k_max
    fj = g.idx.reshape(-1)[pos]
    return move2, dH_step, flow_total, vals, fi, fj


# -- deterministic (bit-reproducible) deltaH ---------------------------------
#
# Every accumulation order is fixed: all arithmetic in float64, the K
# neighbour contributions in slot order, the D-axis and N-axis sums as fixed
# pairwise binary trees, each product and sum its own tensor op (no fused
# multiply-add).  On identical float32 inputs the result is bit-identical to
# the NumPy specification `deltaH_tree_np`, on the CPU and on the card.


def _tree_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Fixed pairwise-tree sum over the last axis."""
    n = x.shape[-1]
    while n > 1:
        if n % 2:
            x = torch.nn.functional.pad(x, (0, 1))
            n += 1
        x = x[..., 0::2] + x[..., 1::2]
        n //= 2
    return x[..., 0]


def deltaH_trace_deterministic(
    g: Graph,
    pg: Optional[PathGraph],
    U: torch.Tensor,
    Ustar: torch.Tensor,
    lam: EnergyParams,
    B: torch.Tensor,
) -> torch.Tensor:
    """deltaH = tr((U-U*)^T M (U-U*)) with fixed-order f64 accumulation."""
    f64 = torch.float64
    diff = U.to(f64) - Ustar.to(f64)
    wn = g.wn.to(f64)
    acc = diff
    for a in range(g.k_max):
        acc = acc - wn[:, a, None] * diff.index_select(0, g.idx[:, a])
    term = lam.lamG.to(f64) * diff + lam.lamC.to(f64) * acc + lam.lamQ.to(f64) * (
        B.to(f64)[:, None] * diff
    )
    if pg is not None and pg.n_edges > 0:
        # sorted edges, each as two single-row scatters in e-ascending,
        # src-before-dst order (chains are tiny)
        pwn = pg.wn.to(f64)
        pacc = torch.zeros_like(diff)
        src, dst = pg.src.tolist(), pg.dst.tolist()
        for e in range(pg.n_edges):
            s, d = src[e], dst[e]
            pacc[s] = pacc[s] + pwn[e] * diff[d]
            pacc[d] = pacc[d] + pwn[e] * diff[s]
        term = term + lam.lamP.to(f64) * (diff - pacc)
    return _tree_sum_last(_tree_sum_last(diff * term))


def deltaH_tree_np(
    idx, wn, U, Ustar, lamG, lamC, lamQ, B,
    path_src=None, path_dst=None, path_wn=None, lamP=0.0,
):
    """NumPy twin of `deltaH_trace_deterministic` — the executable spec; the
    lambdas round through float32 as they do on the device."""

    def lam64(v):
        return np.float64(np.float32(v))

    diff = U.astype(np.float64) - Ustar.astype(np.float64)
    wn64 = wn.astype(np.float64)
    acc = diff.copy()
    for a in range(idx.shape[1]):
        acc = acc - wn64[:, a][:, None] * diff[idx[:, a]]
    term = (
        lam64(lamG) * diff
        + lam64(lamC) * acc
        + lam64(lamQ) * (B.astype(np.float64)[:, None] * diff)
    )
    if path_src is not None and len(path_src) > 0:
        pwn = np.asarray(path_wn, dtype=np.float64)
        pacc = np.zeros_like(diff)
        for e in range(len(path_src)):
            s, d = int(path_src[e]), int(path_dst[e])
            pacc[s] = pacc[s] + pwn[e] * diff[d]
            pacc[d] = pacc[d] + pwn[e] * diff[s]
        term = term + lam64(lamP) * (diff - pacc)

    def tree(x):
        n = x.shape[-1]
        while n > 1:
            if n % 2:
                x = np.concatenate([x, np.zeros(x.shape[:-1] + (1,), dtype=x.dtype)], axis=-1)
                n += 1
            x = x[..., 0::2] + x[..., 1::2]
            n //= 2
        return x[..., 0]

    return tree(tree(diff * term))
