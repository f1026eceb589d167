"""Carry the JAX package's state across to the port.

The JAX package's graph, chain prior and energy coefficients, handed over as
numpy arrays, become the port's tensors on a chosen device.  With these both
packages can run on the *same* graph, so the operator, the solves and the
receipts can be compared apart from graph-build order.

Like every entry point of the port, these run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .models.coherence import EnergyParams
from .ops.graph import Graph
from .ops.kernels.window_spmv import OneHots, WindowPlan
from .ops.path import PathGraph
from .utils.device import DeviceLike, resolve_device

__all__ = [
    "graph_from_numpy",
    "path_from_numpy",
    "energy_from_numpy",
    "window_plan_from_numpy",
    "onehots_from_numpy",
    "halo_plan_from_numpy",
    "shard_window_plans_from_numpy",
]


def _tensor(a, dtype: np.dtype, device: torch.device) -> torch.Tensor:
    # np.array copies: JAX hands out read-only buffers, and the port owns its tensors
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def graph_from_numpy(idx, w, wn, sqrt_deg, *, device: DeviceLike = None) -> Graph:
    """A `Graph` from [N, K] idx/w/wn and [N] sqrt_deg arrays.  Neighbour ids
    are checked to lie in [0, N): kernel K1 does not bound-check them."""
    dev = resolve_device(device)
    idx = np.asarray(idx)
    n = idx.shape[0]
    if idx.ndim != 2 or np.shape(w) != idx.shape or np.shape(wn) != idx.shape:
        raise ValueError("idx, w and wn must all be [N, K]")
    if np.shape(sqrt_deg) != (n,):
        raise ValueError("sqrt_deg must be [N]")
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError("neighbour ids must lie in [0, N)")
    return Graph(
        idx=_tensor(idx, np.int32, dev),
        w=_tensor(w, np.float32, dev),
        wn=_tensor(wn, np.float32, dev),
        sqrt_deg=_tensor(sqrt_deg, np.float32, dev),
    )


def path_from_numpy(src, dst, w, wn, sqrt_deg, *, device: DeviceLike = None) -> PathGraph:
    """A `PathGraph` from the JAX package's [E] edge arrays and [N] sqrt_deg."""
    dev = resolve_device(device)
    return PathGraph(
        src=_tensor(src, np.int32, dev),
        dst=_tensor(dst, np.int32, dev),
        w=_tensor(w, np.float32, dev),
        wn=_tensor(wn, np.float32, dev),
        sqrt_deg=_tensor(sqrt_deg, np.float32, dev),
    )


def energy_from_numpy(lamG, lamC, lamQ, lamP=0.0, *, device: DeviceLike = None) -> EnergyParams:
    """`EnergyParams` (float32, as the JAX package stages them) from numbers
    or 0-d arrays."""
    dev = resolve_device(device)
    return EnergyParams.make(
        float(np.asarray(lamG)), float(np.asarray(lamC)), float(np.asarray(lamQ)),
        float(np.asarray(lamP)), device=dev,
    )


def window_plan_from_numpy(cs, idxl, wnl, strag_dst, strag_src, strag_w, strag_off, strag_cnt,
                           *, W: int, s_max: Optional[int] = None,
                           device: DeviceLike = None) -> WindowPlan:
    """A `WindowPlan` from the JAX package's plan arrays (in field order).

    Checked once here, never per apply, because kernels K2–K4 rely on it:
    in-window local ids lie in [0, W); a row has at most K live slots over
    all its windows (K4 lists them in K places); straggler sources lie in
    [0, Npad) and destinations are non-decreasing (K4 takes each row's run
    as one contiguous range); every straggler segment offset is 8-aligned;
    and the straggler
    arrays are long enough for the last block's read,
    ``strag_off[-1] + s_max <= len(strag_w)``.  ``s_max`` is
    the straggler window of the one-hots used with the plan; by default the
    plan's own (its largest padded segment, rounded up to 128)."""
    dev = resolve_device(device)
    cs, idxl, off, cnt = (np.asarray(a) for a in (cs, idxl, strag_off, strag_cnt))
    n_win, n_pad, _ = idxl.shape
    b = cs.shape[1]
    if cs.shape[0] != n_win or np.shape(wnl) != idxl.shape:
        raise ValueError("cs must be [n_win, B] and idxl, wnl [n_win, Npad, K]")
    if np.shape(off) != (b,) or np.shape(cnt) != (b,):
        raise ValueError("strag_off and strag_cnt must be [B]")
    s_len = np.shape(strag_w)[0]
    if np.shape(strag_dst) != (s_len,) or np.shape(strag_src) != (s_len,):
        raise ValueError("strag_dst, strag_src and strag_w must be [S]")
    if n_pad % b or n_pad % W or cs.min() < 0 or cs.max() >= n_pad // W:
        raise ValueError(f"plan geometry does not match W={W}: Npad {n_pad}, {b} blocks")
    if idxl.size and (idxl.min() < 0 or idxl.max() >= W):
        raise ValueError(f"in-window local ids must lie in [0, W={W})")
    k = idxl.shape[2]
    if idxl.size and int((np.asarray(wnl) != 0.0).sum(axis=(0, 2)).max()) > k:
        raise ValueError(f"a row has more than K={k} live slots over its windows")
    dst, src = np.asarray(strag_dst), np.asarray(strag_src)
    if s_len and (src.min() < 0 or src.max() >= n_pad):
        raise ValueError(f"straggler sources must lie in [0, Npad={n_pad})")
    if (np.diff(dst.astype(np.int64)) < 0).any():
        raise ValueError("straggler destinations must be non-decreasing")
    if (off % 8).any():
        raise ValueError("straggler segment offsets must be 8-aligned")
    if s_max is None:
        p_max = int(cnt.max()) if b else 0
        s_max = max(128, ((p_max + 127) // 128) * 128)
    if b and int(off[-1]) + s_max > s_len:
        raise ValueError(
            f"straggler arrays too short: strag_off[-1] + s_max = {int(off[-1]) + s_max} > {s_len}"
        )
    return WindowPlan(
        cs=_tensor(cs, np.int32, dev),
        idxl=_tensor(idxl, np.int32, dev),
        wnl=_tensor(wnl, np.float32, dev),
        strag_dst=_tensor(strag_dst, np.int32, dev),
        strag_src=_tensor(strag_src, np.int32, dev),
        strag_w=_tensor(strag_w, np.float32, dev),
        strag_off=_tensor(off, np.int32, dev),
        strag_cnt=_tensor(cnt, np.int32, dev),
    )


def onehots_from_numpy(main, strag, *, device: DeviceLike = None) -> OneHots:
    """`OneHots` from the JAX package's one-hot arrays.  ``main`` keeps a
    2-byte (bf16) storage type, as oh16/dma16 store it, and is float32
    otherwise; ``strag``, the exact 0/1 straggler one-hot, is stored in
    bf16."""
    dev = resolve_device(device)
    main = np.asarray(main)
    bf16_main = main.dtype != np.float32 and main.dtype.itemsize == 2
    main_t = _tensor(main, np.float32, dev)
    if bf16_main:
        main_t = main_t.to(torch.bfloat16)
    return OneHots(main=main_t, strag=_tensor(strag, np.float32, dev).to(torch.bfloat16))


def halo_plan_from_numpy(send_map, send_valid, remap, idx_local, w_local_mask, idx_halo,
                         w_halo_mask, r_max, rows_per):
    """The port's `parallel.halo_cg.HaloPlan` (host arrays) from the JAX
    package's plan fields (in field order), checked for the shapes and id
    ranges the two K1 launches of an apply rely on."""
    from .parallel.halo_cg import HaloPlan

    send_map, send_valid = np.array(send_map, np.int32), np.array(send_valid, bool)
    n_dev, _, r = send_map.shape
    r_max, rows_per = int(r_max), int(rows_per)
    idx_local, idx_halo = np.array(idx_local, np.int32), np.array(idx_halo, np.int32)
    if send_map.shape != (n_dev, n_dev, r_max) or send_valid.shape != send_map.shape:
        raise ValueError("send_map and send_valid must be [n_dev, n_dev, r_max]")
    if idx_local.shape[0] != n_dev * rows_per or idx_halo.shape != idx_local.shape:
        raise ValueError("idx_local and idx_halo must be [n_dev * rows_per, K]")
    if send_map.size and (send_map.min() < 0 or send_map.max() >= rows_per):
        raise ValueError("send_map rows must lie in [0, rows_per)")
    if idx_local.size and (idx_local.min() < 0 or idx_local.max() >= rows_per):
        raise ValueError("local ids must lie in [0, rows_per)")
    if idx_halo.size and (idx_halo.min() < 0 or idx_halo.max() >= n_dev * r_max):
        raise ValueError("halo ids must lie in [0, n_dev * r_max)")
    return HaloPlan(send_map, send_valid, np.array(remap, np.int32), idx_local,
                    np.array(w_local_mask, np.float32), idx_halo,
                    np.array(w_halo_mask, np.float32), r_max, rows_per)


def shard_window_plans_from_numpy(plan_fields, onehot_fields, *, W: int, s_max: int,
                                  devices) -> tuple[list, list]:
    """Per-shard `WindowPlan`s and `OneHots` from the JAX package's stacked
    ``build_shard_window_plans`` output (each field [n_dev, ...]): shard s's
    plan on ``devices[s]`` (each checked by `window_plan_from_numpy` with
    the shared ``s_max``), its one-hots on the CPU shards only (the card's
    kernels read the plan alone; None there)."""
    plans, ohs = [], []
    for s, dev in enumerate(devices):
        dev = resolve_device(dev)
        plans.append(window_plan_from_numpy(*(np.asarray(f)[s] for f in plan_fields), W=W,
                                            s_max=s_max, device=dev))
        ohs.append(onehots_from_numpy(*(np.asarray(f)[s] for f in onehot_fields), device=dev)
                   if dev.type == "cpu" else None)
    return plans, ohs
