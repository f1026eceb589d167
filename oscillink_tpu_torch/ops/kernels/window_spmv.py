"""Kernels K2, K3, K4: the windowed block-sparse Laplacian matvec.

Port of ``oscillink_tpu/ops/pallas/window_spmv.py``.  Rows are processed in
blocks of R; for each block the plan elects ``n_windows`` W-aligned row
windows of X (after locality ordering, mutual-kNN neighbours concentrate
near the diagonal) and keeps each row's in-window neighbours as
``idxl``/``wnl`` slots.  Edges outside every window ("stragglers") are
listed by destination row, grouped by row block.  The TPU kernels apply the
windows as a dense ``[R, n_windows*W]`` one-hot *weight* matrix built once
per graph, and the stragglers as an exact 0/1 bf16 one-hot against the
rows ``strag_w ⊙ X[strag_src]`` gathered per apply.

The kernels, all three in ``oscillink_tpu_torch/csrc/window_spmv3f.cu``,
compile-time variants of one kernel that reads the plan and no one-hot: it
stages the windows in shared memory, gathers each row's live slots from
them and each row's stragglers from X:

* K2 ``window_spmv_cuda`` — windows only: ``X − Σ_w OH_w @ X_win(w)``.
  `lap_matvec_windowed` subtracts the stragglers after it
  (`_stragglers_gather`, plain PyTorch).
* K3 ``window_spmv3_cuda`` — K2 minus each row's stragglers.
* K4 ``window_spmv3f_cuda`` — ``g ⊙ x − windows − stragglers`` plus the
  per-block column partials ``Σ_rows x ⊙ out`` (the CG denominator
  ⟨p, Kp⟩, summed over blocks by the wrapper, without atomics).

Beside each kernel are two plain PyTorch versions.  The one-hot forms
(``window_spmv_ref``, ``window_spmv3_ref``, ``window_spmv3f_ref``) take the
precision tier's own arithmetic — bf16 round-to-nearest hi/lo splits of the
one-hot and of the X window, products summed in float32 — in a per-block
batched form, as the TPU kernels do; the CPU route takes them, and the
tests hold them to the JAX kernels.  The gather forms
(``window_spmv_gather_ref``, ``window_spmv3_gather_ref``,
``window_spmv3f_gather_ref``) are the kernels' arithmetic, which the one-hot
forms match to 2^-16 a product.  A CPU tensor takes the one-hot plain
versions; a CUDA tensor launches the kernel or raises.  Each wrapper
counts its launches in its ``launches`` attribute.

Non-finite values.  The gather forms and the kernels compute a row from
the rows it references only (its own, its live slots', its live
stragglers' sources): a NaN or an infinity in a window row that no row
references stays out of every other row.  The one-hot forms, like the TPU
kernels, spread it through 0·NaN to every row of each block whose windows
hold it.  At the lattice the two cannot differ: one non-finite entry of X
makes the CG scalars non-finite for every row.

The precision tier (``OSCILLINK_WINDOW_PRECISION``) is read per call:
bf16x3 (default; ``a_hi·b_hi + a_hi·b_lo + a_lo·b_hi``), bf16x2
(``a_hi·b_hi + a_lo·b_hi``), oh16 and dma16 (bf16-stored one-hot,
``a·b_hi + a·b_lo``; dma16 also stores the weighted straggler rows in
bf16), bf16 (one pass).  ``a`` is the one-hot, ``b`` the X window.

Plan builders: `build_window_plan_device` builds on the graph's device and
hands back only the (coverage, straggler count, fits) scalars for the
accept decision; the lattice and ``chip_smoke.py`` use it.
`build_window_plan` is the host NumPy builder (the port's own copy of the
JAX package's), kept for the parity tests.  `build_onehot` builds the
one-hots for the CPU route; no card path reads them.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...utils.device import DeviceLike, resolve_device
from .build import load_library

__all__ = [
    "WindowPlan",
    "OneHots",
    "PRECISION_TIERS",
    "build_window_plan",
    "build_window_plan_device",
    "build_onehot",
    "plan_s_max",
    "pad_rows",
    "lowcov_smax_bound",
    "min_coverage",
    "accept_window_plan",
    "can_accept",
    "right_size_stragglers",
    "lap_matvec_windowed",
    "k_matvec_windowed",
    "window_spmv_ref",
    "window_spmv3_ref",
    "window_spmv3f_ref",
    "window_spmv_gather_ref",
    "window_spmv3_gather_ref",
    "window_spmv3f_gather_ref",
    "window_spmv_cuda",
    "window_spmv3_cuda",
    "window_spmv3f_cuda",
]

DEFAULT_W = 512  # window rows (a multiple of R or R a multiple of it)
DEFAULT_R = 256  # output row-block rows
DEFAULT_SMAX = 512  # per-block straggler segment rows read by K3/K4
_LANE = 8
PRECISION_TIERS = ("bf16x3", "bf16x2", "bf16", "oh16", "dma16")
# The routing constants' defaults, read on an NVIDIA H100 80GB HBM3 at
# 700.00 W by oscillink_tpu_torch/benchmarks/window_routing.py (PERF.md's
# routing table; its `--derive` on the committed readings
# window_routing_h100.jsonl): the whole flow at 131072 x 768 x k8, median of
# 3 passes a route.  The windowed flow won no coverage from which it wins at
# every rung above: at coverage 1.0 the routes tie, and the one windowed
# verdict (coverage 0.98194) and the gather ones below it came from the
# build and the receipt, which run the same code on both routes.  So
# coverage (at most 1) never meets the bar, and the bounded-straggler rule
# and the low-coverage retry are off (0): `auto` never accepts a plan.
MIN_COVERAGE_DEFAULT = 2.0
LOWCOV_SMAX_DEFAULT = 0


class WindowPlan(NamedTuple):
    """Window plan as tensors on one device; the W/R geometry is passed
    separately and the window count is the leading axis of ``cs``.

    Straggler layout: entries are grouped by DESTINATION ROW BLOCK — block
    i's stragglers occupy ``[strag_off[i], strag_off[i] + p_i)`` where p_i is
    the block's count rounded up to 8 (padding entries carry w = 0 and point
    their dst at the block's last row, keeping the global dst order
    non-decreasing).  The one-hot forms read a fixed ``[s_max]``-row slice
    starting at ``strag_off[i]``; rows past the block's own segment are
    masked out by the straggler one-hot.  The kernels and the gather forms
    read ``[strag_off[i], + min(strag_cnt[i], s_max))`` and take each row's
    run in it as one contiguous range, so they rely on the dst order."""

    cs: torch.Tensor  # [n_win, B] int32 — elected window ids (units of W rows)
    idxl: torch.Tensor  # [n_win, Npad, K] int32 — in-window local col ids
    wnl: torch.Tensor  # [n_win, Npad, K] f32 — in-window edge weights (0 unused)
    strag_dst: torch.Tensor  # [S] int32 — straggler destination rows (sorted)
    strag_src: torch.Tensor  # [S] int32 — straggler source rows
    strag_w: torch.Tensor  # [S] f32 — straggler weights (0 on padding)
    strag_off: torch.Tensor  # [B] int32 — block i's segment start (multiple of 8)
    strag_cnt: torch.Tensor  # [B] int32 — block i's padded count (0 = no stragglers)

    @property
    def n_pad(self) -> int:
        return self.idxl.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.cs.shape[1]

    @property
    def n_windows(self) -> int:
        return self.cs.shape[0]


class OneHots(NamedTuple):
    """Per-graph one-hot operands.

    main:  [Npad, n_windows*W] f32 (bf16 under oh16/dma16) — window
           selection weights; columns [w*W, (w+1)*W) select from window w.
    strag: [Npad, s_max] bf16 — 0/1 straggler selection (exact in bf16);
           column s of row r selects straggler entry strag_off[blk(r)] + s.
    """

    main: torch.Tensor
    strag: torch.Tensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _env_precision() -> str:
    """The window-pass precision tier from ``OSCILLINK_WINDOW_PRECISION``:
    one of `PRECISION_TIERS`, bf16x3 when unset or unknown."""
    v = os.getenv("OSCILLINK_WINDOW_PRECISION", "bf16x3").strip().lower()
    return v if v in PRECISION_TIERS else "bf16x3"


def lowcov_smax_bound() -> int:
    """``OSCILLINK_WINDOWED_LOWCOV_SMAX``: the straggler window (rows) of the
    low-coverage retry, and the bounded-straggler rule's bound: under
    ``auto`` a plan whose per-block straggler segments fit a window of at
    most this many rows is accepted below the coverage bar.  "0" disables
    both; a value that is not an integer gives the default,
    `LOWCOV_SMAX_DEFAULT`."""
    try:
        return int(os.getenv("OSCILLINK_WINDOWED_LOWCOV_SMAX", str(LOWCOV_SMAX_DEFAULT)))
    except ValueError:
        return LOWCOV_SMAX_DEFAULT


def min_coverage() -> float:
    """``OSCILLINK_WINDOWED_MIN_COVERAGE``: the coverage at or above which
    ``auto`` accepts a plan; a value that is not a number gives the default,
    `MIN_COVERAGE_DEFAULT`."""
    try:
        return float(os.getenv("OSCILLINK_WINDOWED_MIN_COVERAGE", str(MIN_COVERAGE_DEFAULT)))
    except ValueError:
        return MIN_COVERAGE_DEFAULT


def accept_window_plan(
    cov: float,
    n_strag: float,
    fits: bool,
    s_max: int,
    strag_cap: float,
    *,
    forced: bool,
    min_cov: float,
    lowcov_bound: int,
) -> tuple[bool, str]:
    """``(accept, reason)`` for a window plan, the JAX package's rule in its
    order.  A truncated straggler list or a straggler window that does not
    fit is refused even when forced; otherwise a plan is accepted when
    forced, at coverage ``>= min_cov``, or when its straggler window is
    bounded (``0 < s_max <= lowcov_bound``), and refused as low coverage."""
    if n_strag > strag_cap or not fits:
        return False, "straggler overflow"
    if forced:
        return True, "forced"
    if cov >= min_cov:
        return True, "coverage"
    if 0 < lowcov_bound and s_max <= lowcov_bound:
        return True, "bounded stragglers"
    return False, "low coverage"


def can_accept(*, forced: bool, min_cov: float, lowcov_bound: int) -> bool:
    """Whether `accept_window_plan` can accept any plan under these
    settings: forced, a coverage bar a plan can meet (coverage is at most
    1), or the bounded-straggler rule on.  Where it cannot, every plan is
    refused as low coverage, so a caller may skip building one."""
    return forced or min_cov <= 1.0 or lowcov_bound > 0


def right_size_stragglers(plan: WindowPlan, off_last: int, s_max: int) -> WindowPlan:
    """The plan with its straggler arrays cut to what the kernels read:
    each apply gathers the whole list, and K3/K4 read at most
    ``strag_off[-1] + s_max`` entries (rounded up to 128)."""
    keep = _round_up(off_last + s_max, 128)
    if keep >= plan.strag_w.shape[0]:
        return plan
    return plan._replace(
        strag_dst=plan.strag_dst[:keep].contiguous(),
        strag_src=plan.strag_src[:keep].contiguous(),
        strag_w=plan.strag_w[:keep].contiguous(),
    )


def pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-pad axis 0 to ``n_pad`` rows."""
    n = x.shape[0]
    if n == n_pad:
        return x
    out = x.new_zeros((n_pad,) + tuple(x.shape[1:]))
    out[:n] = x
    return out


# -- plan construction ---------------------------------------------------


def build_window_plan(
    idx: np.ndarray,
    wn: np.ndarray,
    *,
    W: int = DEFAULT_W,
    R: int = DEFAULT_R,
    n_windows: int = 2,
    device: DeviceLike = None,
) -> tuple[WindowPlan, float]:
    """Build the window plan on the host from padded [N, K] neighbour arrays
    (wn == 0 marks padding).  Returns (plan as tensors on ``device``,
    coverage in [0, 1])."""
    if n_windows < 1:
        raise ValueError("n_windows must be >= 1")
    dev = resolve_device(device)
    idx = np.asarray(idx)
    wn = np.asarray(wn)
    n, k = idx.shape
    n_pad = _round_up(n, int(np.lcm(W, R)))
    b = n_pad // R

    idx_p = np.zeros((n_pad, k), dtype=np.int32)
    wn_p = np.zeros((n_pad, k), dtype=np.float32)
    idx_p[:n] = idx
    wn_p[:n] = wn

    live = wn_p != 0.0
    wblk = idx_p // W
    rowblk = (np.arange(n_pad) // R)[:, None]

    n_aligned = n_pad // W
    hist = np.zeros((b, n_aligned), dtype=np.int64)
    np.add.at(hist, (np.broadcast_to(rowblk, wblk.shape)[live], wblk[live]), 1)

    cs = np.zeros((n_windows, b), dtype=np.int32)
    h = hist.copy()
    for w in range(n_windows):
        cw = np.argmax(h, axis=1).astype(np.int32)
        # degenerate blocks (fewer populated windows than n_windows): point
        # the election somewhere distinct so window ids never collide
        for prev in range(w):
            clash = cw == cs[prev]
            cw[clash] = (cw[clash] + 1 + prev) % max(n_aligned, 1)
        h[np.arange(b), cw] = -1
        cs[w] = cw

    in_any = np.zeros_like(live)
    idxl = np.zeros((n_windows, n_pad, k), dtype=np.int32)
    wnl = np.zeros((n_windows, n_pad, k), dtype=np.float32)
    for w in range(n_windows):
        cw_e = cs[w][rowblk[:, 0]][:, None]
        in_w = live & (wblk == cw_e) & ~in_any
        idxl[w] = np.where(in_w, idx_p - cw_e * W, 0)
        wnl[w] = np.where(in_w, wn_p, 0.0)
        in_any |= in_w
    strag = live & ~in_any

    s_dst, s_k = np.nonzero(strag)  # row-major: sorted by dst, so by block
    s_src = idx_p[s_dst, s_k]
    s_w = wn_p[s_dst, s_k]

    blk_e = s_dst // R
    counts = np.bincount(blk_e, minlength=b)
    padded = ((counts + _LANE - 1) // _LANE) * _LANE
    off = np.zeros(b + 1, dtype=np.int64)
    off[1:] = np.cumsum(padded)
    p_max = int(padded.max()) if len(s_dst) else 0
    # tail slack so a [strag_off[i], strag_off[i] + s_max) read stays in
    # bounds for any s_max <= plan_s_max(plan)
    s_len = int(off[b - 1]) + max(128, _round_up(p_max, 128)) if b else 128

    blk_of_pos = np.clip(np.searchsorted(off, np.arange(s_len), side="right") - 1, 0, b - 1)
    strag_dst = (blk_of_pos * R + (R - 1)).astype(np.int32)
    strag_src = np.zeros(s_len, dtype=np.int32)
    strag_w = np.zeros(s_len, dtype=np.float32)
    start = np.zeros(b, dtype=np.int64)
    start[1:] = np.cumsum(counts)[:-1]
    tgt = off[blk_e] + (np.arange(len(s_dst)) - start[blk_e])
    strag_dst[tgt] = s_dst
    strag_src[tgt] = s_src
    strag_w[tgt] = s_w

    n_live = int(live.sum())
    coverage = 1.0 - (len(s_dst) / max(n_live, 1))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    plan = WindowPlan(
        cs=t(cs),
        idxl=t(idxl),
        wnl=t(wnl),
        strag_dst=t(strag_dst),
        strag_src=t(strag_src),
        strag_w=t(strag_w),
        strag_off=t(off[:b].astype(np.int32)),
        strag_cnt=t(padded.astype(np.int32)),
    )
    return plan, float(coverage)


def plan_s_max(plan: WindowPlan) -> int:
    """Host-side s_max for `build_onehot`: the largest per-block padded
    straggler segment, rounded up to 128 (min 128)."""
    w = plan.strag_w.cpu().numpy()
    dst = plan.strag_dst.cpu().numpy()
    b = plan.n_blocks
    r = plan.n_pad // b
    live = w != 0.0
    if not live.any():
        return 128
    counts = np.bincount(dst[live] // r, minlength=b)
    p_max = int(np.ceil(counts.max() / _LANE) * _LANE)
    return max(128, _round_up(p_max, 128))


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    out[1:] = torch.cumsum(x, 0, dtype=x.dtype)[:-1]
    return out


def build_window_plan_device(
    idx: torch.Tensor,
    wn: torch.Tensor,
    order: torch.Tensor,
    W: int,
    R: int,
    strag_cap: int,
    s_max: int = DEFAULT_SMAX,
    n_windows: int = 2,
):
    """Window plan built on the graph's device from [N, K] idx/wn and the
    locality ``order`` (permuted position -> original row).

    ``strag_cap`` bounds the compacted straggler list; beyond it the list is
    truncated, so callers MUST reject the plan whenever ``n_strag >
    strag_cap``, and also whenever ``fits`` is false (a block's padded
    segment exceeds ``s_max``, or the last block's read would run past
    ``strag_cap``).  Returns (WindowPlan, coverage [0-d f32], n_strag [0-d
    int32], fits [0-d bool])."""
    dev = idx.device
    n, k = idx.shape
    n_pad = _round_up(n, math.lcm(W, R))
    b = n_pad // R
    n_aligned = n_pad // W

    def ar(m, dtype=torch.int32):
        return torch.arange(m, dtype=dtype, device=dev)

    order = order.long()
    inv = torch.zeros(n, dtype=torch.int32, device=dev)
    inv[order] = ar(n)
    idx_p = torch.zeros((n_pad, k), dtype=torch.int32, device=dev)
    idx_p[:n] = inv[idx.long()[order]]
    wn_p = torch.zeros((n_pad, k), dtype=torch.float32, device=dev)
    wn_p[:n] = wn[order]

    live = wn_p != 0.0
    wblk = idx_p // W
    rowblk = (ar(n_pad) // R)[:, None]

    hist = torch.zeros((b, n_aligned), dtype=torch.int32, device=dev)
    hist.index_put_(
        (rowblk.expand_as(wblk).long(), wblk.long()), live.to(torch.int32), accumulate=True
    )

    # argmax returns the first maximal index, as jnp.argmax does
    cs_list: list[torch.Tensor] = []
    h = hist
    for w in range(n_windows):
        cw = torch.argmax(h, dim=1).to(torch.int32)
        for prev in range(w):
            cw = torch.where(cw == cs_list[prev], (cw + 1 + prev) % max(n_aligned, 1), cw)
        h[ar(b, torch.int64), cw.long()] = -1
        cs_list.append(cw)
    cs = torch.stack(cs_list)

    in_any = torch.zeros_like(live)
    idxl_list, wnl_list = [], []
    for w in range(n_windows):
        cw_e = cs[w][rowblk[:, 0].long()][:, None]
        in_w = live & (wblk == cw_e) & ~in_any
        idxl_list.append(torch.where(in_w, idx_p - cw_e * W, 0).to(torch.int32))
        wnl_list.append(torch.where(in_w, wn_p, 0.0))
        in_any = in_any | in_w
    strag = live & ~in_any

    flat = strag.reshape(-1)
    n_strag = flat.sum(dtype=torch.int32)
    # ascending positions -> entries sorted by dst, so grouped by row block;
    # the list is cut at strag_cap and padded with the last row's position
    found = torch.nonzero(flat)[:strag_cap, 0]
    pos = torch.full((strag_cap,), flat.shape[0] - k, dtype=torch.int64, device=dev)
    pos[: found.shape[0]] = found
    e_dst = (pos // k).to(torch.int32)
    e_a = pos % k
    valid = ar(strag_cap) < n_strag
    e_src = torch.where(valid, idx_p[e_dst.long(), e_a], 0).to(torch.int32)
    e_w = torch.where(valid, wn_p[e_dst.long(), e_a], 0.0)

    blk_e = (e_dst // R).long()
    counts = torch.zeros(b, dtype=torch.int32, device=dev)
    counts.index_put_((blk_e,), valid.to(torch.int32), accumulate=True)
    padded = ((counts + _LANE - 1) // _LANE) * _LANE
    off = _exclusive_cumsum(padded)
    p_max = torch.max(padded)
    fits = (p_max <= s_max) & (off[b - 1] + s_max <= strag_cap)
    start = _exclusive_cumsum(counts)
    rank = ar(strag_cap) - start[blk_e]
    tgt = torch.where(valid, off[blk_e] + rank, strag_cap).long()

    blk_of_pos = torch.clamp(
        torch.searchsorted(off, ar(strag_cap), right=True) - 1, 0, b - 1
    ).to(torch.int32)
    # JAX drops out-of-range scatter targets (mode="drop"); mask them here
    keep = tgt < strag_cap
    tk = tgt[keep]
    s_dst = blk_of_pos * R + (R - 1)
    s_dst[tk] = e_dst[keep]
    s_src = torch.zeros(strag_cap, dtype=torch.int32, device=dev)
    s_src[tk] = e_src[keep]
    s_w = torch.zeros(strag_cap, dtype=torch.float32, device=dev)
    s_w[tk] = e_w[keep]

    n_live = torch.clamp_min(live.sum(dtype=torch.int32), 1)
    coverage = 1.0 - n_strag.to(torch.float32) / n_live.to(torch.float32)

    plan = WindowPlan(
        cs=cs,
        idxl=torch.stack(idxl_list),
        wnl=torch.stack(wnl_list),
        strag_dst=s_dst,
        strag_src=s_src,
        strag_w=s_w,
        strag_off=off,
        strag_cnt=padded,
    )
    return plan, coverage, n_strag, fits


def build_onehot(plan: WindowPlan, W: int, s_max: int = DEFAULT_SMAX) -> OneHots:
    """One-hot operands on the plan's device, built once per graph.

    main [Npad, n_windows*W] f32: columns [w*W, (w+1)*W) select from window
    w with edge weights folded in (summed over the K slots in order, as the
    JAX package builds it).  strag [Npad, s_max] bf16: 0/1 selection of the
    block's straggler segment."""
    n_win, n_pad, k = plan.idxl.shape
    dev = plan.idxl.device
    cols = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    parts = []
    for w in range(n_win):
        oh_w = torch.zeros((n_pad, W), dtype=torch.float32, device=dev)
        for a in range(k):
            oh_w = oh_w + torch.where(
                cols == plan.idxl[w, :, a][:, None], plan.wnl[w, :, a][:, None], 0.0
            )
        parts.append(oh_w)
    main = torch.cat(parts, dim=1)

    r = n_pad // plan.n_blocks
    rows = torch.arange(n_pad, dtype=torch.int64, device=dev)
    e = plan.strag_off.long()[rows // r][:, None] + torch.arange(s_max, device=dev)
    hit = (plan.strag_dst[e] == rows[:, None]) & (plan.strag_w[e] != 0.0)
    return OneHots(main=main, strag=hit.to(torch.bfloat16))


# -- plain versions --------------------------------------------------------


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    t = t.to(torch.float32)
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _window_dot(oh: torch.Tensor, win: torch.Tensor, precision: str) -> torch.Tensor:
    """Batched ``oh @ win`` in the tier's bf16 passes, each pass an f32
    product of bf16-valued operands (exact products, f32 sums)."""
    if precision == "bf16x3":
        a_hi, a_lo = _split(oh)
        b_hi, b_lo = _split(win)
        return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
    if precision == "bf16x2":
        a_hi, a_lo = _split(oh)
        b_hi = _bf16(win)
        return a_hi @ b_hi + a_lo @ b_hi
    if precision in ("oh16", "dma16"):
        a = _bf16(oh)
        b_hi, b_lo = _split(win)
        return a @ b_hi + a @ b_lo
    if precision == "bf16":
        return _bf16(oh) @ _bf16(win)
    raise ValueError(f"unknown window precision tier {precision!r}")


def _windows_sub(plan: WindowPlan, oh: torch.Tensor, Xpad: torch.Tensor, acc: torch.Tensor,
                 W: int, R: int, precision: str) -> torch.Tensor:
    """``acc − Σ_w OH_w @ X_win(w)`` per row block, acc [B, R, D]."""
    n_pad, d = Xpad.shape
    b = n_pad // R
    ohb = oh.view(b, R, -1)
    xw = Xpad.view(n_pad // W, W, d)
    for w in range(plan.n_windows):
        acc = acc - _window_dot(ohb[:, :, w * W:(w + 1) * W], xw[plan.cs[w].long()], precision)
    return acc


def _contrib(plan: WindowPlan, Xpad: torch.Tensor, precision: str) -> torch.Tensor:
    """Per-apply straggler contributions ``strag_w ⊙ X[strag_src]``, stored
    in bf16 under dma16."""
    c = plan.strag_w[:, None] * Xpad.index_select(0, plan.strag_src.long())
    return c.to(torch.bfloat16) if precision == "dma16" else c


def _strag_corr(plan: WindowPlan, oh3: torch.Tensor, contrib: torch.Tensor, R: int,
                precision: str) -> torch.Tensor:
    """Per-block straggler correction ``OH3_blk @ contrib[off : off + s_max]``
    ([B, R, D] f32): one exact-one-hot pass under dma16, else two passes
    against the hi/lo split of the contributions."""
    b, s_max = plan.n_blocks, oh3.shape[1]
    seg = plan.strag_off.long()[:, None] + torch.arange(s_max, device=contrib.device)
    c = contrib[seg]
    a = oh3.view(b, R, s_max).to(torch.float32)
    if precision == "dma16":
        return a @ c.to(torch.float32)
    c_hi, c_lo = _split(c)
    return a @ c_hi + a @ c_lo


def _apply_stragglers(plan, oh3, Xpad, acc, R, precision):
    has = (plan.strag_cnt > 0)[:, None, None]
    corr = _strag_corr(plan, oh3, _contrib(plan, Xpad, precision), R, precision)
    return torch.where(has, acc - corr, acc)


def window_spmv_ref(plan: WindowPlan, oh: torch.Tensor, Xpad: torch.Tensor, W: int, R: int,
                    precision: str) -> torch.Tensor:
    """Plain K2: ``X_blk − Σ_w OH_w @ X_win(w)`` for every row block."""
    n_pad, d = Xpad.shape
    acc = _windows_sub(plan, oh, Xpad, Xpad.view(n_pad // R, R, d), W, R, precision)
    return acc.reshape(n_pad, d)


def window_spmv3_ref(plan: WindowPlan, oh: torch.Tensor, oh3: torch.Tensor, Xpad: torch.Tensor,
                     W: int, R: int, s_max: int, precision: str) -> torch.Tensor:
    """Plain K3: K2 minus the straggler correction in blocks that have any."""
    n_pad, d = Xpad.shape
    acc = _windows_sub(plan, oh, Xpad, Xpad.view(n_pad // R, R, d), W, R, precision)
    return _apply_stragglers(plan, oh3, Xpad, acc, R, precision).reshape(n_pad, d)


def window_spmv3f_ref(plan: WindowPlan, oh: torch.Tensor, oh3: torch.Tensor, Xpad: torch.Tensor,
                      g: torch.Tensor, W: int, R: int, s_max: int,
                      precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K4: ``(g ⊙ x − windows − stragglers, Σ_blocks Σ_rows x ⊙ out)``."""
    n_pad, d = Xpad.shape
    xb = Xpad.view(n_pad // R, R, d)
    acc = _windows_sub(plan, oh, Xpad, g.view(-1, R, 1) * xb, W, R, precision)
    acc = _apply_stragglers(plan, oh3, Xpad, acc, R, precision)
    pap = torch.sum(xb * acc, dim=1)  # [B, D] per-block partials
    return acc.reshape(n_pad, d), torch.sum(pap, dim=0)


def _merged_weights(idxl: torch.Tensor, wnl: torch.Tensor) -> torch.Tensor:
    """One window's [Npad, K] slot weights as the one-hot holds them: a
    column named by several live slots of a row gets their sum, in slot
    order, on its first live slot and 0 on the others."""
    k = idxl.shape[1]
    live = wnl != 0.0
    out = wnl.clone()
    for a in range(k):
        same = (idxl == idxl[:, a:a + 1]) & live
        s = wnl[:, a]
        for b in range(a + 1, k):
            s = torch.where(same[:, b], s + wnl[:, b], s)
        first = ~(same[:, :a].any(dim=1))
        out[:, a] = torch.where(live[:, a] & first, s, 0.0)
    return out


def _windows_gather(plan: WindowPlan, Xpad: torch.Tensor, acc: torch.Tensor, W: int, R: int,
                    precision: str) -> torch.Tensor:
    """``acc − Σ_w Σ_a A(wn_a)·B(x[cs[w, blk]·W + idxl_a])`` per live slot
    (repeated columns merged as the one-hot merges them, `_merged_weights`),
    in slot order.  A = bf16 under oh16, dma16 and bf16; B = bf16 under
    bf16x2 and bf16; identity otherwise."""
    if precision not in PRECISION_TIERS:
        raise ValueError(f"unknown window precision tier {precision!r}")
    blk = torch.arange(Xpad.shape[0], device=Xpad.device) // R
    xs = _bf16(Xpad) if precision in ("bf16x2", "bf16") else Xpad
    for w in range(plan.n_windows):
        base = plan.cs[w].long()[blk] * W
        wt = _merged_weights(plan.idxl[w], plan.wnl[w])
        if precision in ("oh16", "dma16", "bf16"):
            wt = _bf16(wt)
        for a in range(wt.shape[1]):
            nb = xs.index_select(0, base + plan.idxl[w, :, a].long())
            acc = acc - torch.where(wt[:, a:a + 1] != 0.0, wt[:, a:a + 1] * nb, 0.0)
    return acc


def _stragglers_gather(plan: WindowPlan, Xpad: torch.Tensor, acc: torch.Tensor, R: int,
                       s_max: int, precision: str) -> torch.Tensor:
    """``acc − Σ_{e in r's run} C(strag_w[e]·x[strag_src[e]])`` for every
    row r: its run of the destination-sorted list within its block's
    segment ``[strag_off, strag_off + min(strag_cnt, s_max))``, live
    entries only, subtracted one at a time in entry order (C = bf16 under
    dma16, identity otherwise).  It is a per-row segment walk, not
    ``index_add_``, whose CUDA sum uses atomics: the result repeats to the
    bit.  K2's straggler epilogue on both devices."""
    n_pad = Xpad.shape[0]
    rows = torch.arange(n_pad, device=Xpad.device)
    blk = rows // R
    off = plan.strag_off.long()[blk]
    end = off + torch.clamp(plan.strag_cnt.long(), max=s_max)[blk]
    dst = plan.strag_dst
    r32 = rows.to(dst.dtype)
    lo = torch.minimum(torch.maximum(torch.searchsorted(dst, r32), off), end)
    hi = torch.minimum(torch.maximum(torch.searchsorted(dst, r32, right=True), off), end)
    n_run = int((hi - lo).max()) if n_pad else 0
    last = max(dst.shape[0] - 1, 0)
    for j in range(n_run):
        e = torch.clamp(lo + j, max=last)
        w_e = plan.strag_w[e]
        live = (lo + j < hi) & (w_e != 0.0)
        c = w_e[:, None] * Xpad.index_select(0, plan.strag_src.long()[e])
        if precision == "dma16":
            c = _bf16(c)
        acc = acc - torch.where(live[:, None], c, 0.0)
    return acc


def window_spmv_gather_ref(plan: WindowPlan, Xpad: torch.Tensor, W: int, R: int,
                           precision: str) -> torch.Tensor:
    """Plain K2 in gather form, the arithmetic of ``csrc/window_spmv3f.cu``'s
    K2 variant: ``out[r] = x[r] − Σ_w Σ_a A(wn_a)·B(x[cs[w, blk]·W + idxl_a])``
    (`_windows_gather`)."""
    return _windows_gather(plan, Xpad, Xpad, W, R, precision)


def window_spmv3_gather_ref(plan: WindowPlan, Xpad: torch.Tensor, W: int, R: int, s_max: int,
                            precision: str) -> torch.Tensor:
    """Plain K3 in gather form: `window_spmv_gather_ref` minus each row's
    stragglers (`_stragglers_gather`), K4's arithmetic with g ≡ 1 and no
    partials."""
    out = window_spmv_gather_ref(plan, Xpad, W, R, precision)
    return _stragglers_gather(plan, Xpad, out, R, s_max, precision)


def window_spmv3f_gather_ref(plan: WindowPlan, Xpad: torch.Tensor, g: torch.Tensor, W: int,
                             R: int, s_max: int, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K4 in gather form, the arithmetic of ``csrc/window_spmv3f.cu``:

        out[r] = g[r]·x[r] − Σ_w Σ_a A(wn_a)·B(x[cs[w, blk]·W + idxl_a])
                 − Σ_{e in r's straggler run} C(strag_w[e]·x[strag_src[e]])

    (`_windows_gather`, `_stragglers_gather`).  Returns (out, Σ_blocks
    Σ_rows x ⊙ out) like `window_spmv3f_ref`."""
    n_pad, d = Xpad.shape
    acc = _windows_gather(plan, Xpad, g * Xpad, W, R, precision)
    acc = _stragglers_gather(plan, Xpad, acc, R, s_max, precision)
    pap = torch.sum((Xpad * acc).view(n_pad // R, R, d), dim=1)
    return acc, torch.sum(pap, dim=0)


# -- CUDA wrappers ---------------------------------------------------------

_I, _P = ctypes.c_int, ctypes.c_void_p
_LL = ctypes.c_longlong


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("window_spmv3f")
    plan = [_I, _P, _P, _I]  # n_win, idxl, wnl, K (after X and cs)
    strag = [_P, _P, _P, _P, _P, _I]  # strag_dst, strag_src, strag_w, strag_off, strag_cnt, s_max
    tail = [_LL, _I, _I, _I, _I, _P]  # n_pad, d, W, R, tier, stream
    lib.oscillink_window_spmv3f.argtypes = [_P, _P, _P] + plan + strag + [_P, _P] + tail
    lib.oscillink_window_spmv3.argtypes = [_P, _P] + plan + strag + [_P] + tail
    lib.oscillink_window_spmv.argtypes = [_P, _P] + plan + [_P] + tail
    for fn in (lib.oscillink_window_spmv3f, lib.oscillink_window_spmv3, lib.oscillink_window_spmv):
        fn.restype = ctypes.c_int
    lib.oscillink_window_spmv3f_error_string.argtypes = [_I]
    lib.oscillink_window_spmv3f_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, plan: WindowPlan, Xpad: torch.Tensor, W: int, R: int, precision: str,
           s_max: Optional[int] = None, g: Optional[torch.Tensor] = None) -> None:
    """Device, contiguity, dtype and shape checks of the K2–K4 wrappers: the
    plan's window arrays, and its straggler arrays where ``s_max`` is given
    (K3, K4)."""
    def fail(msg):
        raise ValueError(f"{name}: {msg}")

    keys = ["cs", "idxl", "wnl"]
    if s_max is not None:
        keys += ["strag_dst", "strag_src", "strag_w", "strag_off", "strag_cnt"]
    tensors = {"Xpad": Xpad, **{key: getattr(plan, key) for key in keys}}
    if g is not None:
        tensors["g"] = g
    for key, t in tensors.items():
        if t.device.type != "cuda":
            fail(f"{key} must be a CUDA tensor, got {t.device}")
        if t.device != Xpad.device:
            fail(f"{key} is on {t.device}, Xpad on {Xpad.device}")
        if not t.is_contiguous():
            fail(f"{key} must be contiguous")
    if precision not in PRECISION_TIERS:
        fail(f"unknown precision tier {precision!r}")
    if Xpad.dtype != torch.float32 or Xpad.dim() != 2:
        fail(f"Xpad must be a 2-D float32 tensor, got {Xpad.dtype} {tuple(Xpad.shape)}")
    n_pad = Xpad.shape[0]
    n_win, b = plan.cs.shape
    k = plan.idxl.shape[2]
    if plan.cs.dtype != torch.int32:
        fail("plan.cs must be int32")
    if W <= 0 or R <= 0 or n_pad != b * R or n_pad % W:
        fail(f"Xpad rows {n_pad} do not match the plan ({b} blocks of {R}, windows of {W})")
    for key, dtype in (("idxl", torch.int32), ("wnl", torch.float32)):
        t = getattr(plan, key)
        if t.dtype != dtype or tuple(t.shape) != (n_win, n_pad, k):
            fail(f"{key} must be [{n_win}, {n_pad}, K] {dtype}")
    if s_max is not None:
        if s_max < 0:
            fail(f"s_max must be >= 0, got {s_max}")
        s_len = plan.strag_w.shape[0]
        for key, dtype, shape in (("strag_dst", torch.int32, (s_len,)),
                                  ("strag_src", torch.int32, (s_len,)),
                                  ("strag_w", torch.float32, (s_len,)),
                                  ("strag_off", torch.int32, (b,)),
                                  ("strag_cnt", torch.int32, (b,))):
            t = getattr(plan, key)
            if t.dtype != dtype or tuple(t.shape) != shape:
                fail(f"{key} must be {list(shape)} {dtype}")
    if g is not None and (g.dtype != torch.float32 or tuple(g.shape) != (n_pad, 1)):
        fail(f"g must be [{n_pad}, 1] float32")


def _launch(name: str, Xpad: torch.Tensor, W: int, R: int, precision: str, *args) -> None:
    """Call the library's entry ``oscillink_<name>`` with ``args`` and the
    geometry, tier and current stream; raise on a refused launch."""
    lib = _library()
    with torch.cuda.device(Xpad.device):
        stream = torch.cuda.current_stream(Xpad.device).cuda_stream
        rc = getattr(lib, f"oscillink_{name}")(*args, Xpad.shape[0], Xpad.shape[1], W, R,
                                               PRECISION_TIERS.index(precision), stream)
    if rc != 0:
        msg = lib.oscillink_window_spmv3f_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _plan_args(plan: WindowPlan) -> list:
    return [plan.cs.data_ptr(), plan.n_windows, plan.idxl.data_ptr(), plan.wnl.data_ptr(),
            plan.idxl.shape[2]]


def _strag_args(plan: WindowPlan, s_max: int) -> list:
    return [plan.strag_dst.data_ptr(), plan.strag_src.data_ptr(), plan.strag_w.data_ptr(),
            plan.strag_off.data_ptr(), plan.strag_cnt.data_ptr(), s_max]


def window_spmv_cuda(plan: WindowPlan, Xpad: torch.Tensor, W: int, R: int,
                     precision: str) -> torch.Tensor:
    """Launch K2 (``csrc/window_spmv3f.cu``'s windows-only variant: the
    plan's in-window slots, no one-hot) on Xpad's device and current
    stream.  Raises on bad inputs and on a refused launch; never falls back
    to the plain version."""
    _check("window_spmv_cuda", plan, Xpad, W, R, precision)
    out = torch.empty_like(Xpad)
    if Xpad.numel() == 0:
        return out
    _launch("window_spmv", Xpad, W, R, precision, Xpad.data_ptr(), *_plan_args(plan),
            out.data_ptr())
    window_spmv_cuda.launches += 1
    return out


def window_spmv3_cuda(plan: WindowPlan, Xpad: torch.Tensor, W: int, R: int, s_max: int,
                      precision: str) -> torch.Tensor:
    """Launch K3 (K4's kernel with g ≡ 1 and no partials: windows and each
    row's stragglers, gathered from X in the kernel).  Raises on bad inputs
    and on a refused launch; never falls back to the plain version."""
    _check("window_spmv3_cuda", plan, Xpad, W, R, precision, s_max=s_max)
    out = torch.empty_like(Xpad)
    if Xpad.numel() == 0:
        return out
    _launch("window_spmv3", Xpad, W, R, precision, Xpad.data_ptr(), *_plan_args(plan),
            *_strag_args(plan, s_max), out.data_ptr())
    window_spmv3_cuda.launches += 1
    return out


def window_spmv3f_cuda(plan: WindowPlan, Xpad: torch.Tensor, g: torch.Tensor, W: int, R: int,
                       s_max: int, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 (the fused operator in gather form from the plan's
    in-window slots and straggler list, no one-hot) and sum its per-block
    ⟨x, out⟩ column partials over blocks with ``torch.sum``: no atomics, so
    the CG denominator is the same from run to run.  Raises on bad inputs
    and on a refused launch (a geometry whose staged windows do not fit a
    block's shared memory); never falls back to the plain version."""
    _check("window_spmv3f_cuda", plan, Xpad, W, R, precision, s_max=s_max, g=g)
    out = torch.empty_like(Xpad)
    partials = torch.empty((plan.n_blocks, Xpad.shape[1]), dtype=torch.float32,
                           device=Xpad.device)
    if Xpad.numel() == 0:
        return out, partials.sum(dim=0)
    _launch("window_spmv3f", Xpad, W, R, precision, Xpad.data_ptr(), g.data_ptr(),
            *_plan_args(plan), *_strag_args(plan, s_max), out.data_ptr(), partials.data_ptr())
    window_spmv3f_cuda.launches += 1
    return out, torch.sum(partials, dim=0)


window_spmv_cuda.launches = 0
window_spmv3_cuda.launches = 0
window_spmv3f_cuda.launches = 0


# -- operator entry points -------------------------------------------------


def _on_card(Xpad: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the
    one-hot plain versions); raises on any other device."""
    if Xpad.device.type in ("cuda", "cpu"):
        return Xpad.device.type == "cuda"
    raise ValueError(f"windowed matvec: unsupported device {Xpad.device}")


def _cpu_onehots(oh: Optional[OneHots]) -> OneHots:
    if oh is None:
        raise ValueError("windowed matvec on the CPU takes the one-hot plain versions: "
                         "pass the plan's OneHots (build_onehot)")
    return oh


def _geometry(plan: WindowPlan, R: Optional[int], precision: Optional[str]):
    if R is None:
        R = plan.n_pad // plan.n_blocks
    if precision is None:
        precision = _env_precision()
    return R, precision


def lap_matvec_windowed(plan: WindowPlan, oh: Optional[OneHots], Xpad: torch.Tensor, *, W: int,
                        s_max: int, R: Optional[int] = None,
                        precision: Optional[str] = None) -> torch.Tensor:
    """Normalized-Laplacian matvec on padded rows: ``X − Wn X``.

    ``Xpad`` has ``plan.n_pad`` rows (`pad_rows`); padded rows pass through
    as identity.  ``W`` and ``s_max`` are the plan's window rows and
    straggler window; R defaults to the plan's row block, the tier to
    ``OSCILLINK_WINDOW_PRECISION``.  D % 128 == 0 takes K3; any other D
    takes K2 and the straggler epilogue `_stragglers_gather`.  The 128 is
    the TPU's lane width (the Pallas kernel's straggler DMA needs
    128-aligned lanes), not a limit of this card's kernels, which take any
    D: the port keeps the split so that every kernel has a path and the
    routing follows the reference.  On the card the kernels read the plan
    and ``oh`` may be None; on the CPU the one-hot plain versions need it."""
    R, precision = _geometry(plan, R, precision)
    card = _on_card(Xpad)
    if Xpad.shape[1] % 128 == 0:
        if card:
            return window_spmv3_cuda(plan, Xpad, W, R, s_max, precision)
        oh = _cpu_onehots(oh)
        return window_spmv3_ref(plan, oh.main, oh.strag, Xpad, W, R, s_max, precision)
    if card:
        out = window_spmv_cuda(plan, Xpad, W, R, precision)
    else:
        out = window_spmv_ref(plan, _cpu_onehots(oh).main, Xpad, W, R, precision)
    return _stragglers_gather(plan, Xpad, out, R, s_max, precision)


def k_matvec_windowed(plan: WindowPlan, oh: Optional[OneHots], Xpad: torch.Tensor,
                      g: torch.Tensor, *, W: int, s_max: int, R: Optional[int] = None,
                      precision: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused operator apply: ``(g ⊙ X − Wn X, per-column Σ_rows X ⊙ K(X))``.

    The caller folds the operator's full diagonal, divided by the
    off-diagonal scale s, into ``g`` ([n_pad, 1] f32): M X = s·K(X).  Padded
    rows add 0 to both outputs while Xpad's padding is zero.  D % 128 == 0
    takes K4: on the card the gather-form kernel; on the CPU the one-hot
    plain version (the two agree to 2^-16 a product).  Any other D composes
    the same quantities from `lap_matvec_windowed`: K(X) = (g − 1) ⊙ X +
    L_win X."""
    R, precision = _geometry(plan, R, precision)
    if Xpad.shape[1] % 128 == 0:
        if _on_card(Xpad):
            return window_spmv3f_cuda(plan, Xpad, g, W, R, s_max, precision)
        oh = _cpu_onehots(oh)
        return window_spmv3f_ref(plan, oh.main, oh.strag, Xpad, g, W, R, s_max, precision)
    lap = lap_matvec_windowed(plan, oh, Xpad, W=W, s_max=s_max, R=R, precision=precision)
    out = (g - 1.0) * Xpad + lap
    return out, torch.sum(Xpad * out, dim=0)

