"""Kernel K1: the gather-SpMV ``out[i] = X[i] - sum_k wn[i,k] X[idx[i,k]]``.

Hopper port of ``oscillink_tpu/ops/pallas/spmv.py:_spmv_kernel``; the CUDA
source is ``oscillink_tpu_torch/csrc/spmv.cu`` (its header says what bounds
the kernel and how the design answers it).  Beside it:

* ``lap_matvec_ref`` — the plain PyTorch version, the same K-ordered
  arithmetic.  The CPU path and the card-side checks use it.
* ``lap_matvec_cuda`` — the wrapper: checks its inputs, allocates the
  output, launches on the current stream and raises if the launch failed.
  ``launches`` counts its kernel launches, so a run can show that its main
  path went through the kernel.

The wrapper does not bound-check ``idx`` (that would cost a reduction and a
host sync per call): `build_graph` produces ids in ``[0, N)``, and
``interop.graph_from_numpy`` checks ids handed in from outside.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

__all__ = ["lap_matvec_cuda", "lap_matvec_ref", "launches"]

launches = 0
"""Kernel launches made by `lap_matvec_cuda` since the count was last reset."""


def lap_matvec_ref(idx: torch.Tensor, wn: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gather-SpMV: start from X, subtract k = 0..K-1 in order."""
    acc = X
    for a in range(idx.shape[1]):
        acc = acc - wn[:, a, None] * X.index_select(0, idx[:, a])
    return acc


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
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.oscillink_cuda_error_string.argtypes = [ctypes.c_int]
    lib.oscillink_cuda_error_string.restype = ctypes.c_char_p
    return lib


def lap_matvec_cuda(idx: torch.Tensor, wn: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Launch K1 on X's device and current stream.  Raises on bad inputs or a
    refused launch; never falls back to the plain version."""
    global launches
    _check(idx, wn, X)
    out = torch.empty_like(X)
    if X.numel() == 0:
        return out
    lib = _library()
    n, k = idx.shape
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.oscillink_spmv_gather(
            idx.data_ptr(), wn.data_ptr(), X.data_ptr(), out.data_ptr(),
            n, k, X.shape[1], stream,
        )
    if rc != 0:
        msg = lib.oscillink_cuda_error_string(rc).decode()
        raise RuntimeError(f"spmv_gather launch failed: CUDA error {rc} ({msg})")
    launches += 1
    return out
