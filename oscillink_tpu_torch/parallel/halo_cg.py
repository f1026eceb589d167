"""Halo-exchange sharded CG: an all_to_all of just the boundary rows
(port of ``oscillink_tpu/parallel/halo_cg.py``).

The mesh tier for reordered lattices (`reorder.pca_bisection_order`): on
clustered corpora a shard's gathers touch a small share of the other
shards' rows.  A host plan (`build_halo_plan`, numpy) lists, per shard pair
(s -> d), the padded rows of s that d's gathers touch; each operator apply
then

  1. packs each shard's outgoing rows by ``send_map``, masked by
     ``send_valid``, into an [n_dev, R_max, D] send buffer,
  2. swaps the buffers with one `mesh.all_to_all`,
  3. runs two launches of kernel K1 per shard: its own rows against
     themselves over ``idx_local`` with ``wn·w_local_mask``, then, starting
     from that output, against the received halo frame over ``idx_halo``
     with ``wn·w_halo_mask`` — the JAX package's two slot loops in their
     order,
  4. psums the CG dot products as the all-gather tier does.

``gather_dtype="bfloat16"`` reads the neighbour rows from a bf16 copy of
the direction with f32 sums.  The JAX package computes it as an XLA gather,
not in Pallas; here it is plain PyTorch ops on both devices.

`halo_solve_windowed` runs each shard's local slots through the windowed
kernels instead (`ops.kernels.window_spmv.lap_matvec_windowed`: K3 at
D % 128 == 0, K2 and its straggler epilogue otherwise) on per-shard window
plans (`build_shard_window_plans`), and the halo slots through K1.
`solve_auto` reorders, builds the graph on the mesh, measures the halo and
picks the tier.  The port takes the windowed halo tier only when
``OSCILLINK_WINDOWED_MATVEC`` forces it (1, force, on, true); under
``auto`` or unset it takes the gather halo tier and says why in its info,
as the port's lattice logs ``window_ctx_skipped``: the JAX package's
unforced acceptance (coverage >= ``OSCILLINK_WINDOWED_MIN_COVERAGE``, or a
bounded straggler window) is calibrated for the TPU, not this card, so the
port does not read that variable.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.coherence import EnergyParams
from ..ops.graph import Graph
from ..ops.kernels.window_spmv import (
    OneHots,
    WindowPlan,
    _env_precision,
    build_onehot,
    build_window_plan,
    lap_matvec_windowed,
    pad_rows,
    plan_s_max,
)
from .mesh import Mesh, all_to_all, gather_rows, split_rows
from .shardmap_cg import Blocks, lam_on, lap_matvec_src, replicate, sharded_cg, stationary_rhs

__all__ = [
    "HaloPlan",
    "build_halo_plan",
    "build_shard_window_plans",
    "halo_solve",
    "halo_solve_windowed",
    "solve_auto",
]

# the per-shard window geometry: three 384-row windows with the row block
# aligned to them (R = W), the JAX package's
SHARD_W, SHARD_R, SHARD_WINDOWS = 384, 384, 3
FORCED = {"1", "force", "on", "true"}


class HaloPlan(NamedTuple):
    """Host-precomputed exchange plan for a row-sharded graph.

    send_map: [n_dev, n_dev, R_max] int32 — for source shard s, the LOCAL row
              ids s sends to destination d (slot [s, d]; padded with 0).
    send_valid: same shape, bool padding mask.
    remap:    [N, K] int32 — neighbor indices rewritten into each owning
              shard's extended frame: local rows keep [0, rows_per); halo
              references point at rows_per + d_src * R_max + slot.
    The matvec uses the LOCAL/HALO split of remap, two kernel launches an
    apply (local slots first, then halo slots, JAX's order slot for slot):
    idx_local/w_local: [N, K] — local-frame gather (0-weight on halo edges).
    idx_halo/w_halo:   [N, K] — halo-frame gather (0-weight on local edges).
    r_max:    int — padded per-pair request count.
    rows_per: int
    """

    send_map: np.ndarray
    send_valid: np.ndarray
    remap: np.ndarray
    idx_local: np.ndarray
    w_local_mask: np.ndarray
    idx_halo: np.ndarray
    w_halo_mask: np.ndarray
    r_max: int
    rows_per: int


def build_halo_plan(idx: np.ndarray, w: np.ndarray, n_dev: int) -> HaloPlan:
    """Precompute the exchange plan from a padded [N, K] neighbor structure.

    Vectorised numpy (sort, unique and segment arithmetic; no per-edge
    Python loop), a copy of the JAX package's builder."""
    n, k = idx.shape
    if n % n_dev != 0:
        raise ValueError(f"N={n} must divide n_dev={n_dev}")
    rows_per = n // n_dev
    idx32 = np.ascontiguousarray(idx, dtype=np.int32)
    shard_of = idx32 // rows_per  # [N, K] owning shard per neighbor
    dst_of_row = (np.arange(n, dtype=np.int32) // rows_per)[:, None]  # [N, 1]

    live = w > 0
    halo_edge = live & (shard_of != dst_of_row)

    # unique (dst, j) halo requests, sorted by (dst, j) — within a dst the
    # source shard (j // rows_per) is therefore non-decreasing, making
    # (dst, src) groups contiguous segments
    halo_rows, halo_cols = np.nonzero(halo_edge)
    keys = (halo_rows // rows_per).astype(np.int64) * n + idx32[
        halo_rows, halo_cols
    ].astype(np.int64)
    u = np.unique(keys)  # sorted unique (dst*n + j)
    dst_u = u // n
    j_u = u % n
    src_u = j_u // rows_per

    gid = dst_u * n_dev + src_u  # contiguous segments in u-order
    if len(u):
        seg_start = np.flatnonzero(np.r_[True, gid[1:] != gid[:-1]])
        counts = np.diff(np.r_[seg_start, len(u)])
        r_max = int(counts.max())
        # slot of each entry within its (dst, src) segment
        slots = np.arange(len(u)) - np.repeat(seg_start, counts)
    else:
        r_max = 1
        slots = np.zeros(0, dtype=np.int64)

    send_map = np.zeros((n_dev, n_dev, r_max), dtype=np.int32)
    send_valid = np.zeros((n_dev, n_dev, r_max), dtype=bool)
    send_map[src_u, dst_u, slots] = (j_u - src_u * rows_per).astype(np.int32)
    send_valid[src_u, dst_u, slots] = True

    # remap every edge into its owning shard's extended frame
    local_edge = live & ~halo_edge
    remap = np.where(local_edge, idx32 - dst_of_row * rows_per, 0).astype(np.int32)
    if len(u):
        # halo frame position = src * r_max + slot, found via sorted lookup
        pos = np.searchsorted(u, keys)
        halo_frame = (src_u[pos] * r_max + slots[pos]).astype(np.int32)
        remap[halo_rows, halo_cols] = rows_per + halo_frame

    is_halo = remap >= rows_per
    idx_local = np.where(is_halo, 0, remap).astype(np.int32)
    w_local_mask = (~is_halo).astype(np.float32)
    idx_halo = np.where(is_halo, remap - rows_per, 0).astype(np.int32)
    w_halo_mask = is_halo.astype(np.float32)
    return HaloPlan(
        send_map, send_valid, remap, idx_local, w_local_mask, idx_halo,
        w_halo_mask, r_max, rows_per,
    )


class _HaloOperands:
    """A halo plan's per-shard tensors: the two masked weight sets and their
    index tables, and each shard's send plan."""

    def __init__(self, mesh: Mesh, g: Graph, plan: HaloPlan):
        n = g.idx.shape[0]
        if mesh.size * plan.rows_per != n:
            raise ValueError("plan does not match mesh/N")
        wn = split_rows(mesh, g.wn)
        self.idx_local = split_rows(mesh, plan.idx_local)
        self.idx_halo = split_rows(mesh, plan.idx_halo)
        self.w_local = [w * m for w, m in zip(wn, split_rows(mesh, plan.w_local_mask))]
        self.w_halo = [w * m for w, m in zip(wn, split_rows(mesh, plan.w_halo_mask))]
        self.send_map = [torch.from_numpy(plan.send_map[s].reshape(-1).astype(np.int64)).to(dev)
                         for s, dev in enumerate(mesh.devices)]
        self.send_valid = [torch.from_numpy(plan.send_valid[s]).to(dev)[:, :, None]
                           for s, dev in enumerate(mesh.devices)]
        self.mesh = mesh
        self.r_max = plan.r_max

    def halo(self, X: Blocks) -> Blocks:
        """Each shard's received halo frame [n_dev * R_max, D]: slot s holds
        what shard s sent."""
        n_dev = self.mesh.size
        send = []
        for s, x in enumerate(X):
            rows = x.index_select(0, self.send_map[s]).reshape(n_dev, self.r_max, x.shape[1])
            rows = torch.where(self.send_valid[s], rows, 0.0)
            send.append(list(rows.unbind(0)))
        return [torch.cat(recv, dim=0) for recv in all_to_all(self.mesh, send)]


def _bf16_gather_sub(acc: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """acc − Σ_a w[:, a]·src[idx[:, a]] with src read in bf16 and summed in
    f32, slot by slot (plain PyTorch on both devices)."""
    src = src.to(torch.bfloat16)
    for a in range(idx.shape[1]):
        acc = acc - w[:, a, None] * src.index_select(0, idx[:, a]).to(torch.float32)
    return acc


def _solve(mesh, ops: _HaloOperands, lam, Y, psi, B, tol, max_iters, local_lap):
    lams = lam_on(mesh, lam)
    Y_l = split_rows(mesh, Y, torch.float32)
    B_l = split_rows(mesh, B, torch.float32)
    psi_l = replicate(mesh, psi)

    def M_mul(p_l: Blocks) -> Blocks:
        halo = ops.halo(p_l)
        out = []
        for s, lm in enumerate(lams):
            acc = local_lap(s, p_l[s], halo[s])
            out.append(lm.lamG * p_l[s] + lm.lamC * acc + lm.lamQ * (B_l[s][:, None] * p_l[s]))
        return out

    rhs, inv_M = stationary_rhs(lams, Y_l, B_l, psi_l)
    return sharded_cg(mesh, M_mul, rhs, Y_l, inv_M, tol, max_iters)


def halo_solve(
    mesh: Mesh,
    g: Graph,
    plan: HaloPlan,
    Y,
    psi,
    B,
    lam: EnergyParams,
    tol: float = 1e-4,
    max_iters: int = 64,
    axis_name: str = "rows",
    gather_dtype: str = "float32",
) -> tuple[Blocks, int, float]:
    """Stationary solve with halo-exchange collectives; the all-gather
    tier's numerical contract.  Returns (U* blocks, iterations, residual).
    ``gather_dtype="bfloat16"`` takes the bf16-read gathers."""
    ops = _HaloOperands(mesh, g, plan)
    bf16 = gather_dtype in ("bfloat16", "bf16")

    def local_lap(s, p, halo):
        if bf16:
            acc = _bf16_gather_sub(p, ops.idx_local[s], ops.w_local[s], p)
            return _bf16_gather_sub(acc, ops.idx_halo[s], ops.w_halo[s], halo)
        acc = lap_matvec_src(ops.idx_local[s], ops.w_local[s], p, p)
        return lap_matvec_src(ops.idx_halo[s], ops.w_halo[s], acc, halo)

    return _solve(mesh, ops, lam, Y, psi, B, tol, max_iters, local_lap)


def _pad_strag(p: WindowPlan, s_len: int) -> WindowPlan:
    """The plan's straggler arrays padded to ``s_len`` entries (w = 0,
    destination the last padded row, so destinations stay non-decreasing)."""
    ext = s_len - p.strag_w.shape[0]
    if ext == 0:
        return p
    dev = p.strag_w.device
    return p._replace(
        strag_dst=torch.cat([p.strag_dst, torch.full((ext,), p.n_pad - 1, dtype=torch.int32,
                                                     device=dev)]),
        strag_src=torch.cat([p.strag_src, torch.zeros(ext, dtype=torch.int32, device=dev)]),
        strag_w=torch.cat([p.strag_w, torch.zeros(ext, dtype=torch.float32, device=dev)]),
    )


def build_shard_window_plans(plan: HaloPlan, wn: np.ndarray, n_dev: int, *,
                             mesh: Optional[Mesh] = None):
    """Per-shard window plans over each shard's local frame, on the host
    builder (`ops.kernels.window_spmv.build_window_plan`).

    Local edges (``w_local_mask``) go through the windowed kernels; halo
    edges stay on K1.  Every shard shares one straggler window ``s_max``
    (the largest shard's) and one straggler-array length: the kernels read
    ``[strag_off[b-1], strag_off[b-1] + s_max)`` with the shared s_max, so
    every shard is padded to the worst-case end of that read.  Shard s's
    plan lands on ``mesh.devices[s]`` (the host without a mesh); one-hots
    are built only for shards on the CPU, whose plain versions read them
    (bf16-stored main one-hot under oh16 and dma16), and are None on the
    card.  Returns (plans, one-hots, min coverage, s_max)."""
    rows_per = plan.rows_per
    wn = np.asarray(wn, dtype=np.float32)
    devices = list(mesh.devices) if mesh is not None else [torch.device("cpu")] * n_dev
    plans, covs = [], []
    for s in range(n_dev):
        sl = slice(s * rows_per, (s + 1) * rows_per)
        p_s, cov_s = build_window_plan(plan.idx_local[sl], wn[sl] * plan.w_local_mask[sl],
                                       W=SHARD_W, R=SHARD_R, n_windows=SHARD_WINDOWS,
                                       device="cpu")
        plans.append(p_s)
        covs.append(cov_s)
    s_max = max(plan_s_max(p) for p in plans)
    s_len = max(max(int(p.strag_off[-1]) + s_max for p in plans),
                max(p.strag_w.shape[0] for p in plans))
    plans = [_pad_strag(p, s_len) for p in plans]
    ohs: list[Optional[OneHots]] = []
    for p, dev in zip(plans, devices):
        oh = None
        if dev.type == "cpu":
            oh = build_onehot(p, SHARD_W, s_max)
            if _env_precision() in ("oh16", "dma16"):
                oh = oh._replace(main=oh.main.to(torch.bfloat16))
        ohs.append(oh)
    plans = [WindowPlan(*(t.to(dev) for t in p)) for p, dev in zip(plans, devices)]
    return plans, ohs, float(min(covs)), s_max


def halo_solve_windowed(
    mesh: Mesh,
    g: Graph,
    plan: HaloPlan,
    wplan: list,
    woh: list,
    Y,
    psi,
    B,
    lam: EnergyParams,
    tol: float = 1e-4,
    max_iters: int = 64,
    axis_name: str = "rows",
    *,
    s_max: Optional[int] = None,
) -> tuple[Blocks, int, float]:
    """Halo-exchange CG with each shard's local slots on the windowed
    kernels and its halo slots on K1 (`build_shard_window_plans`'s plans
    and one-hots; ``s_max`` their shared straggler window, read from the
    one-hots or the plans when not given).  The contract of `halo_solve`
    up to the windowed kernels' rounding (~1e-6 a product)."""
    ops = _HaloOperands(mesh, g, plan)
    if s_max is None:
        s_max = (woh[0].strag.shape[1] if woh and woh[0] is not None
                 else max(plan_s_max(p) for p in wplan))
    rows_per = plan.rows_per

    def local_lap(s, p, halo):
        acc = lap_matvec_windowed(wplan[s], woh[s], pad_rows(p, wplan[s].n_pad), W=SHARD_W,
                                  s_max=s_max, R=SHARD_R)[:rows_per].contiguous()
        return lap_matvec_src(ops.idx_halo[s], ops.w_halo[s], acc, halo)

    return _solve(mesh, ops, lam, Y, psi, B, tol, max_iters, local_lap)


def _windowed_mode() -> str:
    return os.getenv("OSCILLINK_WINDOWED_MATVEC", "auto").strip().lower()


def solve_auto(
    mesh: Mesh,
    Y: np.ndarray,
    psi: np.ndarray,
    B: Optional[np.ndarray] = None,
    *,
    k: int = 8,
    lamG: float = 1.0,
    lamC: float = 0.5,
    lamQ: float = 4.0,
    tol: float = 1e-4,
    max_iters: int = 64,
    halo_fraction_cutoff: float = 0.5,
    reorder_levels: int = 4,
    similarity: str = "auto",
):
    """Tier-selecting sharded stationary solve.

    Reorders rows by PCA bisection, builds the graph on the mesh, measures
    the halo (`reorder.halo_stats`) and takes the halo tier when the mean
    halo is below ``halo_fraction_cutoff`` of the all-gather volume, else
    the all-gather tier.  Inside the halo tier the windowed local matvec
    is taken only when ``OSCILLINK_WINDOWED_MATVEC`` forces it and a shard
    has at least 1024 rows; ``OSCILLINK_GATHER_DTYPE`` picks the gather's
    read type.  Returns (U* in the original row order on the host, info:
    the tier, the halo statistics, the window coverage, iterations,
    residual, the reason a windowed tier was not taken, and the stage
    times in ms)."""
    from .reorder import apply_order, halo_stats, pca_bisection_order
    from .sharded_build import build_graph_sharded
    from .shardmap_cg import shardmap_solve

    stage: dict[str, float] = {}

    def lap(name: str, t0: float) -> float:
        if mesh.devices[0].type == "cuda":
            torch.cuda.synchronize(mesh.devices[0])
        stage[name] = 1000.0 * (time.perf_counter() - t0)
        return time.perf_counter()

    t0 = time.perf_counter()
    Y = np.asarray(Y, dtype=np.float32)
    n = Y.shape[0]
    n_dev = mesh.size
    B = np.ones(n, dtype=np.float32) if B is None else np.asarray(B, dtype=np.float32)
    order = pca_bisection_order(Y, levels=reorder_levels, device=mesh.devices[0])
    Y_s, B_s, inv = apply_order(order, Y, B)
    t0 = lap("reorder", t0)

    g = build_graph_sharded(mesh, Y_s, k, similarity=similarity)
    idx_h, w_h = g.idx.cpu().numpy(), g.w.cpu().numpy()
    stats = halo_stats(idx_h, w_h, n_dev)
    t0 = lap("sharded_build", t0)

    lam = EnergyParams.make(lamG, lamC, lamQ, 0.0, device=mesh.devices[0])
    use_halo = stats["halo_mean"] < halo_fraction_cutoff * stats["allgather_rows"]
    win_cov, skipped = None, None
    if use_halo:
        plan = build_halo_plan(idx_h, w_h, n_dev)
        mode = _windowed_mode()
        wargs = None
        if mode not in {"0", "off", "false", "no"} and plan.rows_per >= 1024:
            if mode in FORCED:
                wplan, woh, win_cov, win_smax = build_shard_window_plans(
                    plan, g.wn.cpu().numpy(), n_dev, mesh=mesh)
                wargs = (wplan, woh, win_smax)
            else:
                skipped = ("auto-routing is not calibrated on this device; set "
                           "OSCILLINK_WINDOWED_MATVEC=1 to force the windowed tier")
        t0 = lap("plan", t0)
        if wargs is not None:
            U, it, res = halo_solve_windowed(mesh, g, plan, wargs[0], wargs[1], Y_s, psi, B_s,
                                             lam, tol=tol, max_iters=max_iters, s_max=wargs[2])
            tier = "halo-exchange-windowed"
        else:
            gd = os.getenv("OSCILLINK_GATHER_DTYPE", "float32").strip().lower()
            U, it, res = halo_solve(mesh, g, plan, Y_s, psi, B_s, lam, tol=tol,
                                    max_iters=max_iters, gather_dtype=gd)
            tier = "halo-exchange-bf16gather" if gd in ("bfloat16", "bf16") else "halo-exchange"
    else:
        U, it, res = shardmap_solve(mesh, g, Y_s, psi, B_s, lam, tol=tol, max_iters=max_iters)
        tier = "all-gather"
    U_orig = gather_rows(U).numpy()[inv]
    lap("solve", t0)
    return U_orig, {
        "tier": tier,
        "halo_stats": stats,
        "window_coverage": win_cov,
        "window_skipped": skipped,
        "iters": int(it),
        "res": float(res),
        "stage_ms": stage,
    }
