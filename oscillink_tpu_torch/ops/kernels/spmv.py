"""Kernel K1: the gather-SpMV ``out[i] = X[i] - sum_k wn[i,k] X[idx[i,k]]``.

Hopper port of ``oscillink_tpu/ops/pallas/spmv.py:_spmv_kernel``; the CUDA
source is ``oscillink_tpu_torch/csrc/spmv.cu`` (its header says what bounds
the kernel and how the design answers it).  Beside it:

* ``lap_matvec_ref`` — the plain PyTorch version, the same K-ordered
  arithmetic.  The CPU path and the card-side checks use it.
* ``slab_plan`` — the kernel's column-slab width: all of D when X fits,
  with idx and wn, in half the card's L2, else `SLAB_COLS`.
* ``lap_matvec_cuda`` — the wrapper: checks its inputs, allocates the
  output, launches on the current stream with the plan's slab width and
  raises if the launch failed.  ``launches`` counts its kernel launches, so
  a run can show that its main path went through the kernel.

The wrapper does not bound-check ``idx`` (that would cost a reduction and a
host sync per call): `build_graph` produces ids in ``[0, N)``, and
``interop.graph_from_numpy`` checks ids handed in from outside.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

__all__ = ["SLAB_COLS", "device_l2_bytes", "l2_budget", "lap_matvec_cuda", "lap_matvec_ref",
           "launches", "slab_plan"]

launches = 0
"""Kernel launches made by `lap_matvec_cuda` since the count was last reset."""


def lap_matvec_ref(idx: torch.Tensor, wn: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gather-SpMV: start from X, subtract k = 0..K-1 in order."""
    acc = X
    for a in range(idx.shape[1]):
        acc = acc - wn[:, a, None] * X.index_select(0, idx[:, a])
    return acc


def l2_budget(l2_bytes: int) -> int:
    """The bytes a slab and its index data may hold: half the L2.  The H100's
    50 MB L2 is two partitions, and the output's stores pass through it too."""
    return l2_bytes // 2


SLAB_COLS = 32
"""K1's slab width when X does not fit `l2_budget`: the fastest width of the
sweeps on the H100 at every size measured, 131072, 262144, 524288 and
1,000,000 rows of 768 columns with k = 8, whether or not a slab and idx
and wn fit the L2 (PERF.md §6).  A row's 32 columns are one 128-byte line
for each of its K gathers."""


def slab_plan(n: int, d: int, k: int, l2_bytes: int) -> int:
    """Columns per slab for K1 on an [N, D] X with K slots a row, on a card
    with ``l2_bytes`` of L2: D, one slab, when X (N*D*4 bytes) and idx plus
    wn (N*K*8) fit `l2_budget`; else `SLAB_COLS`, or D when that is
    narrower."""
    if n * d * 4 + n * k * 8 <= l2_budget(l2_bytes):
        return d
    return min(d, SLAB_COLS)


@functools.cache
def device_l2_bytes(index: int) -> int:
    """The L2 size of CUDA device ``index``, as CUDA reports it."""
    return torch.cuda.get_device_properties(index).L2_cache_size


def _check(idx: torch.Tensor, wn: torch.Tensor, X: torch.Tensor) -> None:
    for name, t in (("idx", idx), ("wn", wn), ("X", X)):
        if t.device.type != "cuda":
            raise ValueError(f"lap_matvec_cuda: {name} must be a CUDA tensor, got {t.device}")
        if t.device != X.device:
            raise ValueError(f"lap_matvec_cuda: {name} is on {t.device}, X on {X.device}")
        if t.dim() != 2:
            raise ValueError(f"lap_matvec_cuda: {name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"lap_matvec_cuda: {name} must be contiguous")
    if idx.dtype != torch.int32:
        raise ValueError(f"lap_matvec_cuda: idx must be int32, got {idx.dtype}")
    if wn.dtype != torch.float32 or X.dtype != torch.float32:
        raise ValueError(f"lap_matvec_cuda: wn and X must be float32, got {wn.dtype}, {X.dtype}")
    if idx.shape != wn.shape or idx.shape[0] != X.shape[0]:
        raise ValueError(
            f"lap_matvec_cuda: shapes idx {tuple(idx.shape)}, wn {tuple(wn.shape)}, "
            f"X {tuple(X.shape)} do not agree ([N, K], [N, K], [N, D])"
        )
    if idx.shape[1] < 1:
        raise ValueError("lap_matvec_cuda: K must be >= 1")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("spmv")
    fn = lib.oscillink_spmv_gather
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.oscillink_cuda_error_string.argtypes = [ctypes.c_int]
    lib.oscillink_cuda_error_string.restype = ctypes.c_char_p
    return lib


def lap_matvec_cuda(
    idx: torch.Tensor, wn: torch.Tensor, X: torch.Tensor, slab_cols: int | None = None
) -> torch.Tensor:
    """Launch K1 on X's device and current stream, ``slab_cols`` columns a
    slab (`slab_plan`'s width for this card unless given; the result does
    not depend on it).  Raises on bad inputs or a refused launch; never
    falls back to the plain version."""
    global launches
    _check(idx, wn, X)
    n, k = idx.shape
    d = X.shape[1]
    if slab_cols is None:
        slab_cols = slab_plan(n, d, k, device_l2_bytes(X.device.index))
    elif not 1 <= slab_cols <= d:
        raise ValueError(f"lap_matvec_cuda: slab_cols must lie in [1, {d}], got {slab_cols}")
    out = torch.empty_like(X)
    if X.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.oscillink_spmv_gather(
            idx.data_ptr(), wn.data_ptr(), X.data_ptr(), out.data_ptr(),
            n, k, d, slab_cols, stream,
        )
    if rc != 0:
        msg = lib.oscillink_cuda_error_string(rc).decode()
        raise RuntimeError(f"spmv_gather launch failed: CUDA error {rc} ({msg})")
    launches += 1
    return out
