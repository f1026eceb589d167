"""Edge distances: ``out[i, a] = ||s_i X_i - s_j X_j||^2`` along every graph
edge, ``j = idx[i, a]``, with an optional per-row scale ``s``.

The receipts' coherence drop, null points and edge flows and the bundle's
scores read them (`ops/receipts.py` `_edge_sq_dists`).  The CUDA source is
``oscillink_tpu_torch/csrc/edge_dists.cu`` (its header says what bounds the
kernel and how the design answers it: kernel K1's column-slab walk).
Beside it:

* ``edge_sq_dists_ref`` — the plain PyTorch version, the eager expression
  ``sum((Xn_i - Xn_j)^2)`` over all rows at once, or in row blocks of
  `BLOCK_ROWS` when the [N, K, D] temporaries would pass
  `TEMP_BUDGET_BYTES`.  The CPU path and the card-side checks use it.
* ``edge_sq_dists_cuda`` — the wrapper: checks its inputs, allocates the
  output and the slabs' partials, launches on the current stream with
  K1's slab plan (`spmv.slab_plan`) and raises if a launch failed.
  ``launches`` counts its calls, so a run can show that its main path went
  through the kernel.
* ``scratch_bytes`` — the most device memory a call allocates, for the
  lattice's working-set model of the card.

The kernel takes X's rows at any stride (a lane of a [N, Q, D] block is an
[N, D] view with row stride Q·D), so no caller copies a lane.  The wrapper
does not bound-check ``idx``: `build_graph` produces ids in ``[0, N)``, and
``interop.graph_from_numpy`` checks ids handed in from outside.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import load_library
from .spmv import SLAB_COLS, device_l2_bytes, slab_plan

__all__ = ["BLOCK_ROWS", "TEMP_BUDGET_BYTES", "edge_sq_dists_cuda", "edge_sq_dists_ref",
           "launches", "scratch_bytes"]

launches = 0
"""Calls of `edge_sq_dists_cuda` that launched since the count was last
reset (a call is the kernel and, with more than one slab, its sum over the
slabs)."""

# the plain version's budget for its [N, K, D] gathered-neighbour temporary;
# above it the distances are taken in row blocks (131072 x 8 x 768 f32 is
# 3.2 GB direct, 201 MB per 8192-row block)
TEMP_BUDGET_BYTES = 1 << 30
BLOCK_ROWS = 8192


def edge_sq_dists_ref(
    idx: torch.Tensor, X: torch.Tensor, inv_row_scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[N, K] squared distances ||s_i X_i - s_j X_j||^2 along the edges
    ``idx``, with optional per-row scaling s = ``inv_row_scale``.  Row-blocked
    above the temp budget; the scaling is applied inside each block, so both
    regimes compute the same f32 values."""
    n, d = X.shape
    k = idx.shape[1]
    idx = idx.long()
    if 4 * n * k * d <= TEMP_BUDGET_BYTES or n <= BLOCK_ROWS:
        Xn = X if inv_row_scale is None else X * inv_row_scale[:, None]
        diff = Xn[:, None, :] - Xn[idx]
        return torch.sum(diff * diff, dim=-1).to(torch.float32)

    out = torch.empty((n, k), dtype=torch.float32, device=X.device)
    for r0 in range(0, n, BLOCK_ROWS):
        r1 = min(r0 + BLOCK_ROWS, n)
        ib = idx[r0:r1]
        xb = X[r0:r1]
        xg = X[ib]
        if inv_row_scale is not None:
            xb = xb * inv_row_scale[r0:r1, None]
            xg = xg * inv_row_scale[ib][:, :, None]
        diff = xb[:, None, :] - xg
        out[r0:r1] = torch.sum(diff * diff, dim=-1)
    return out


def scratch_bytes(n: int, d: int, k: int) -> int:
    """The most bytes `edge_sq_dists_cuda` allocates on an [N, D] X with K
    slots a row: the [N, K] f32 output and, with more than one slab, the
    [slabs, N, K] f32 partials at `SLAB_COLS` columns a slab.  A plan of one
    slab (rows that fit half the L2) allocates the output alone, so this
    bounds every card."""
    slabs = -(-d // SLAB_COLS)
    return 4 * n * k * (1 + (slabs if slabs > 1 else 0))


def _check(idx: torch.Tensor, X: torch.Tensor, scale: Optional[torch.Tensor]) -> None:
    if X.dim() != 2 or idx.dim() != 2 or idx.shape[0] != X.shape[0]:
        raise ValueError(f"edge_sq_dists_cuda: idx {tuple(idx.shape)} and X {tuple(X.shape)} "
                         "must be [N, K] and [N, D]")
    if scale is not None and tuple(scale.shape) != (X.shape[0],):
        raise ValueError(f"edge_sq_dists_cuda: scale {tuple(scale.shape)} must be [N] for X "
                         f"{tuple(X.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"edge_sq_dists_cuda: idx must be int32, got {idx.dtype}")
    if X.dtype != torch.float32 or (scale is not None and scale.dtype != torch.float32):
        raise ValueError(f"edge_sq_dists_cuda: X and scale must be float32, got {X.dtype}"
                         + ("" if scale is None else f", {scale.dtype}"))
    for name, t in (("idx", idx), ("X", X), ("scale", scale)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"edge_sq_dists_cuda: {name} must be a CUDA tensor, got {t.device}")
        if t.device != X.device:
            raise ValueError(f"edge_sq_dists_cuda: {name} is on {t.device}, X on {X.device}")
    if not idx.is_contiguous() or (scale is not None and not scale.is_contiguous()):
        raise ValueError("edge_sq_dists_cuda: idx and scale must be contiguous")
    if (X.shape[1] > 1 and X.stride(1) != 1) or (X.shape[0] > 1 and X.stride(0) < X.shape[1]):
        raise ValueError(f"edge_sq_dists_cuda: X must have unit column stride and rows at least "
                         f"D apart, got strides {X.stride()} for shape {tuple(X.shape)}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("edge_dists")
    lib.oscillink_edge_sq_dists.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    lib.oscillink_edge_sq_dists.restype = ctypes.c_int
    lib.oscillink_edge_dists_error_string.argtypes = [ctypes.c_int]
    lib.oscillink_edge_dists_error_string.restype = ctypes.c_char_p
    return lib


def edge_sq_dists_cuda(
    idx: torch.Tensor, X: torch.Tensor, scale: Optional[torch.Tensor] = None,
    slab_cols: Optional[int] = None,
) -> torch.Tensor:
    """Launch the edge-distance kernel on X's device and current stream,
    ``slab_cols`` columns a slab (K1's `slab_plan` width for this card
    unless given; the result depends on it only through the order of the
    sum over D).  No program caller sets ``slab_cols``: it lets the checks
    force several slabs, or one, at small shapes, as `lap_matvec_cuda`'s
    does.  Raises on bad inputs or a refused launch; never falls back
    to the plain version.  The ids must lie in [0, N)."""
    global launches
    _check(idx, X, scale)
    n, k = idx.shape
    d = X.shape[1]
    out = torch.empty((n, k), dtype=torch.float32, device=X.device)
    if X.numel() == 0 or k == 0:
        return out.zero_()
    if slab_cols is None:
        slab_cols = slab_plan(n, d, k, device_l2_bytes(X.device.index))
    elif not 1 <= slab_cols <= d:
        raise ValueError(f"edge_sq_dists_cuda: slab_cols must lie in [1, {d}], got {slab_cols}")
    slabs = -(-d // slab_cols)
    part = torch.empty((slabs, n, k), dtype=torch.float32, device=X.device) if slabs > 1 else None
    lib = _library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.oscillink_edge_sq_dists(
            idx.data_ptr(), None if scale is None else scale.data_ptr(), X.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            n, k, d, X.stride(0) if n > 1 else d, slab_cols, stream,
        )
    if rc != 0:
        msg = lib.oscillink_edge_dists_error_string(rc).decode()
        raise RuntimeError(f"edge_sq_dists launch failed: CUDA error {rc} ({msg})")
    launches += 1
    return out
