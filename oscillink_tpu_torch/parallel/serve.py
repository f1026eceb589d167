"""Sharded serving tier: the full settle, receipt and bundle under a device
mesh (port of ``oscillink_tpu/parallel/serve.py``).

Requests above the service's sharded threshold are served here and still
get a complete receipt — ΔH, per-node component sums, edge-sparse null
points, bundle picks — without U or U* ever gathered into one host buffer:

* the graph from `sharded_build.build_graph_sharded` (or a prebuilt
  ``graph=``);
* the settle (implicit Euler, with the chain prior's path Laplacian applied
  to the gathered rows), then U*, each a `sharded_cg` over the all-gather
  tier's operator (kernel K1's ``src`` form on every shard);
* ΔH, `per_node_components` and `null_points_sparse` per shard, the
  neighbour rows from one all-gather of U* (and one of Y); their sums are
  per-shard partials and a psum;
* `bundle_scores` per shard (the coherence drop's mean and spread over the
  gathered [N] drops), then `mmr_select` on the gathered [N] scores.

Only receipt-sized values go to the host: scalars, four [N] null-point
vectors, [N] scores and alignments, [k] bundle picks.  U and U* come back
as per-shard tensors.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.receipts import chain_receipt_body
from ..models.coherence import EnergyParams
from ..native.listing import list_flagged
from ..ops.graph import Graph, mmr_select, normalize_rows, resolve_similarity
from ..ops.path import build_path_graph
from .mesh import Mesh, all_gather, gather_rows, psum, split_rows
from .sharded import ShardedOperator, mesh_deltaH, mesh_settle, mesh_stationary
from .shardmap_cg import Blocks, replicate
from .sharded_build import build_graph_sharded

__all__ = ["sharded_chain_receipt", "sharded_serve"]

# rows a block of the [rows, K, D] neighbour temporaries (the port's
# ops/receipts.py row block)
_EDGE_BLOCK_ROWS = 8192


def _edge_sq_dists(idx: torch.Tensor, lo: int, X_full: torch.Tensor,
                   inv_full: torch.Tensor) -> torch.Tensor:
    """[rows, K] squared distances ||s_i X_i − s_j X_j||² along a shard's
    edges (rows lo.. of the gathered X, neighbours anywhere in it, s the
    inverse degree scale), in row blocks; the same f32 values as the
    single-device receipts."""
    n, k = idx.shape
    out = torch.empty((n, k), dtype=torch.float32, device=idx.device)
    for r0 in range(0, n, _EDGE_BLOCK_ROWS):
        r1 = min(r0 + _EDGE_BLOCK_ROWS, n)
        ib = idx[r0:r1].long()
        xb = X_full[lo + r0:lo + r1] * inv_full[lo + r0:lo + r1, None]
        xg = X_full[ib] * inv_full[ib][:, :, None]
        diff = xb[:, None, :] - xg
        out[r0:r1] = torch.sum(diff * diff, dim=-1)
    return out


class _Receipt:
    """A shard's receipt quantities off (U, U*) and its gathered rows."""

    def __init__(self, op: ShardedOperator, g: Graph, Y: Blocks, Ustar: Blocks):
        mesh = op.mesh
        self.mesh, self.op, self.rows, self.n = mesh, op, op.rows, g.idx.shape[0]
        self.w = split_rows(mesh, g.w)
        inv = 1.0 / (g.sqrt_deg + 1e-12)
        self.inv_full = replicate(mesh, inv)
        self.Y_full = all_gather(mesh, Y)
        self.U_full = all_gather(mesh, Ustar)
        self.dy2, self.du2 = [], []
        for s in range(mesh.size):
            lo = s * self.rows
            self.dy2.append(_edge_sq_dists(op.idx[s], lo, self.Y_full[s], self.inv_full[s]))
            self.du2.append(_edge_sq_dists(op.idx[s], lo, self.U_full[s], self.inv_full[s]))

    def coherence_drop(self) -> Blocks:
        return [torch.sum(0.5 * lm.lamC * w * (dy - du), dim=1)
                for lm, w, dy, du in zip(self.op.lams, self.w, self.dy2, self.du2)]

    def null_points(self, z_th: float = 3.0):
        """Per shard (flag, j, z, r): the argmax-residual edge of each row,
        its row moments over all N dense columns."""
        out = []
        for s, lm in enumerate(self.op.lams):
            R = lm.lamC * self.w[s] * self.du2[s]
            mu = torch.sum(R, dim=1) / self.n
            var = torch.clamp_min(torch.sum(R * R, dim=1) / self.n - mu * mu, 0.0)
            sigma = torch.sqrt(var) + 1e-12
            slot = torch.argmax(R, dim=1, keepdim=True)
            r_best = torch.gather(R, 1, slot)[:, 0]
            z_best = (r_best - mu) / sigma
            j_best = torch.gather(self.op.idx[s], 1, slot)[:, 0]
            out.append(((r_best > 0) & (z_best > z_th), j_best, z_best, r_best))
        return out


def sharded_serve(
    mesh: Mesh,
    Y: np.ndarray,
    psi: Optional[np.ndarray],
    gates: Optional[np.ndarray] = None,
    *,
    k: int = 6,
    lamG: float = 1.0,
    lamC: float = 0.5,
    lamQ: float = 4.0,
    dt: float = 1.0,
    settle_tol: float = 1e-3,
    settle_iters: int = 12,
    ustar_tol: float = 1e-4,
    ustar_iters: int = 64,
    similarity: str = "auto",
    bundle_k: Optional[int] = None,
    alpha: float = 0.5,
    chain: Optional[list] = None,
    chain_weights: Optional[list] = None,
    lamP: float = 0.0,
    axis_name: str = "rows",
    graph: Optional[Graph] = None,
) -> dict[str, Any]:
    """Full sharded settle + receipt over ``mesh``.  N must divide the mesh
    size (route to a divisor mesh upstream).  Returns receipt-sized host
    values plus U and U* as per-shard tensors.  ``graph`` skips the
    similarity build and serves over a prebuilt `ops.graph.Graph`."""
    Y = np.asarray(Y, dtype=np.float32)
    n, d = Y.shape
    if n % mesh.size != 0:
        raise ValueError(f"N={n} must divide mesh size {mesh.size}")
    dev0 = mesh.devices[0]
    if graph is None:
        g = build_graph_sharded(mesh, Y, k, similarity=similarity, axis_name=axis_name)
    else:
        g = Graph(*(t.to(dev0) for t in graph))
    psi_h = np.zeros(d, dtype=np.float32) if psi is None else np.asarray(psi, dtype=np.float32)
    B_h = np.ones(n, dtype=np.float32) if gates is None else np.asarray(gates, dtype=np.float32)
    lam = EnergyParams.make(lamG, lamC, lamQ, lamP if chain else 0.0, device=dev0)
    pg = build_path_graph(n, chain, chain_weights, device=dev0) if chain else None

    Y_l = split_rows(mesh, Y, torch.float32)
    B_l = split_rows(mesh, B_h, torch.float32)
    psi_l = replicate(mesh, psi_h)
    op = ShardedOperator(mesh, g, B_l, lam, pg)
    U, it_s, res_s = mesh_settle(op, Y_l, Y_l, psi_l, dt, settle_tol, settle_iters)
    Ustar, it_u, res_u = mesh_stationary(op, Y_l, psi_l, ustar_tol, ustar_iters)
    dH = mesh_deltaH(op, U, Ustar)

    rc = _Receipt(op, g, Y_l, Ustar)
    coh = rc.coherence_drop()
    anchor = [lm.lamG * torch.sum((us - y) ** 2, dim=1) for lm, us, y in zip(op.lams, Ustar, Y_l)]
    query = [lm.lamQ * b * torch.sum((us - p[None, :]) ** 2, dim=1)
             for lm, b, us, p in zip(op.lams, B_l, Ustar, psi_l)]

    def total(parts):
        return psum(mesh, [torch.sum(t) for t in parts])[0]

    nulls = rc.null_points(3.0)
    # bundle scores: z of the coherence drop over all N rows, then alignment
    coh_full = all_gather(mesh, coh)[0]
    mu, sigma = torch.mean(coh_full), torch.std(coh_full, correction=0) + 1e-12
    mu_l, sigma_l = replicate(mesh, mu), replicate(mesh, sigma)
    score, align = [], []
    for s, (us, p) in enumerate(zip(Ustar, psi_l)):
        psi_n = p / (torch.linalg.vector_norm(p) + 1e-12)
        al = (us / (torch.linalg.vector_norm(us, dim=1, keepdim=True) + 1e-12)) @ psi_n
        score.append(alpha * ((coh[s] - mu_l[s]) / sigma_l[s]) + (1.0 - alpha) * al)
        align.append(al)
    k_bundle = 0 if not bundle_k else min(int(bundle_k), n)
    score_full = all_gather(mesh, score)[0]
    picks = (mmr_select(normalize_rows(rc.Y_full[0]), score_full, k_bundle, lambda_div=0.5)
             if k_bundle else torch.zeros(0, dtype=torch.int64, device=dev0))
    n_edges = psum(mesh, [torch.sum(w > 0) for w in rc.w])[0]
    scalars = torch.stack([dH, total(coh), total(anchor), total(query),
                           n_edges.to(torch.float32)]).cpu().numpy()

    null_points = list_flagged(*(gather_rows([part[i] for part in nulls]) for i in range(4)))
    score_h, picks_h = score_full.cpu().numpy(), picks.cpu().numpy()
    align_h = gather_rows(align).numpy()
    bundle = (
        [{"id": int(i), "score": float(score_h[i]), "align": float(align_h[i])} for i in picks_h]
        if k_bundle else None
    )
    return {
        "U": U,
        "Ustar": Ustar,
        "deltaH": float(scalars[0]),
        "coh_drop_sum": float(scalars[1]),
        "anchor_pen_sum": float(scalars[2]),
        "query_term_sum": float(scalars[3]),
        "settle_iters": int(it_s),
        "settle_res": float(res_s),
        "ustar_iters": int(it_u),
        "ustar_res": float(res_u),
        "ustar_converged": bool(float(res_u) <= ustar_tol),
        "n_edges": int(scalars[4]),
        "null_points": null_points,
        "bundle": bundle,
        "mesh_devices": int(mesh.size),
    }


def sharded_chain_receipt(
    mesh: Mesh,
    Y: np.ndarray,
    psi: Optional[np.ndarray],
    gates: Optional[np.ndarray],
    chain: list,
    *,
    k: int = 6,
    lamG: float = 1.0,
    lamC: float = 0.5,
    lamQ: float = 4.0,
    lamP: float = 0.0,
    z_th: float = 2.5,
    ustar_tol: float = 1e-4,
    ustar_iters: int = 64,
    similarity: str = "auto",
    axis_name: str = "rows",
) -> dict[str, Any]:
    """Chain receipt computed under the mesh: sharded graph build,
    stationary solve with the chain prior, per-edge z-scores; the response
    shape of `OscillinkLattice.chain_receipt`.  The row moments are taken
    for the chain's rows only, from the gathered U*."""
    Y = np.asarray(Y, dtype=np.float32)
    n, d = Y.shape
    if n % mesh.size != 0:
        raise ValueError(f"N={n} must divide mesh size {mesh.size}")
    if chain and (min(chain) < 0 or max(chain) >= n):
        raise ValueError("chain indices out of bounds")
    if resolve_similarity(n, similarity) == "cluster":
        similarity = "fast"  # IVF is single-device; the state signature keys this realisation
    dev0 = mesh.devices[0]
    g = build_graph_sharded(mesh, Y, k, similarity=similarity, axis_name=axis_name)
    psi_h = np.zeros(d, dtype=np.float32) if psi is None else np.asarray(psi, dtype=np.float32)
    B_h = np.ones(n, dtype=np.float32) if gates is None else np.asarray(gates, dtype=np.float32)
    lam = EnergyParams.make(lamG, lamC, lamQ, lamP, device=dev0)
    pg = build_path_graph(n, chain, device=dev0)
    Y_l = split_rows(mesh, Y, torch.float32)
    op = ShardedOperator(mesh, g, split_rows(mesh, B_h, torch.float32), lam, pg)
    Ustar, it_u, res_u = mesh_stationary(op, Y_l, replicate(mesh, psi_h), ustar_tol, ustar_iters)
    stats = _chain_edge_stats(g, pg, all_gather(mesh, Ustar)[0], all_gather(mesh, Y_l)[0],
                              lam.lamC, chain)
    z_s, z_p, r_s, r_p = (t.cpu().numpy() for t in stats[:4])
    return {
        **chain_receipt_body(chain, z_s, z_p, r_s, r_p, torch.sum(stats[4]), z_th),
        "mesh_devices": int(mesh.size),
        "ustar_iters": int(it_u),
        "ustar_res": float(res_u),
    }


def _chain_edge_stats(g: Graph, pg, Ustar: torch.Tensor, Y: torch.Tensor, lamC: torch.Tensor,
                      chain: list):
    """`ops.receipts.chain_edge_stats` with the structural row moments taken
    for the chain's rows only (their values are the full computation's)."""
    from ..ops.receipts import _edge_weight_lookup

    dev = Ustar.device
    n = g.n_nodes
    ci = torch.tensor(chain[:-1], dtype=torch.int64, device=dev)
    cj = torch.tensor(chain[1:], dtype=torch.int64, device=dev)
    inv = 1.0 / (g.sqrt_deg + 1e-12)
    # _edge_sq_dists reads rows and neighbours from one tensor: the chain's
    # rows come first, the neighbour ids shift past them
    rows_idx = g.idx[ci].long() + ci.numel()
    src = torch.cat([Ustar[ci], Ustar])
    inv_src = torch.cat([inv[ci], inv])
    d2 = _edge_sq_dists(rows_idx, 0, src, inv_src)
    R = lamC * g.w[ci] * d2
    mu_s = torch.sum(R, dim=1) / n
    sig_s = torch.sqrt(torch.clamp_min(torch.sum(R * R, dim=1) / n - mu_s * mu_s, 0.0)) + 1e-12

    Un = Ustar / (g.sqrt_deg[:, None] + 1e-12)
    lamC_p = torch.clamp_min(lamC, 1e-6)
    src_p, dst_p = pg.src.long(), pg.dst.long()
    Rp = lamC_p * pg.w * torch.sum((Un[src_p] - Un[dst_p]) ** 2, dim=1)
    Rp_dst = torch.where(src_p == dst_p, 0.0, Rp)
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    s1 = zeros.index_add(0, src_p, Rp).index_add(0, dst_p, Rp_dst)
    s2 = zeros.index_add(0, src_p, Rp**2).index_add(0, dst_p, torch.where(src_p == dst_p, 0.0,
                                                                           Rp**2))
    mu_p = s1 / n
    sig_p = torch.sqrt(torch.clamp_min(s2 / n - mu_p * mu_p, 0.0)) + 1e-12

    d2_c = torch.sum((Un[ci] - Un[cj]) ** 2, dim=1)
    w_c = _edge_weight_lookup(g, ci, cj)
    r_struct = lamC * w_c * d2_c
    z_struct = (r_struct - mu_s) / sig_s
    key_i, key_j = torch.minimum(ci, cj), torch.maximum(ci, cj)
    hit = (pg.src[None, :] == key_i[:, None]) & (pg.dst[None, :] == key_j[:, None])
    wp_c = torch.sum(torch.where(hit, pg.w[None, :], 0.0), dim=1)
    r_path = lamC_p * wp_c * d2_c
    z_path = (r_path - mu_p[ci]) / sig_p[ci]
    Ynorm = Y / (g.sqrt_deg + 1e-12)[:, None]
    ydiff2 = torch.sum((Ynorm[ci] - Ynorm[cj]) ** 2, dim=1)
    gain_terms = 0.5 * lamC * torch.clamp_min(w_c, 0.0) * (ydiff2 - d2_c)
    return z_struct, z_path, r_struct, r_path, gain_terms
