"""Carry the JAX package's state across to the port.

The JAX package's graph, chain prior and energy coefficients, handed over as
numpy arrays, become the port's tensors on a chosen device.  With these both
packages can run on the *same* graph, so the operator, the solves and the
receipts can be compared apart from graph-build order.

Like every entry point of the port, these run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.coherence import EnergyParams
from .ops.graph import Graph
from .ops.path import PathGraph
from .utils.device import DeviceLike, resolve_device

__all__ = ["graph_from_numpy", "path_from_numpy", "energy_from_numpy"]


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
