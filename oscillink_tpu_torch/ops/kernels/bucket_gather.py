"""Kernel K5: the bucket gather ``out[e] = w[e] * X[(e // e_pad) * S + local_idx[e]]``.

Stage 1 of the edge-centric "bucket-shuffle" matvec: source rows are
bucketed S at a time, and each bucket's edge contributions are gathered from
it and written out in edge order.  Hopper port of
``benchmarks/probe_bucket_gather.py:_bucket_gather_kernel``; the CUDA source
is ``oscillink_tpu_torch/csrc/bucket_gather.cu`` (its header says what
bounds the kernel and how the design answers it).  Beside it:

* ``bucket_gather_ref`` — the plain PyTorch version, the probe's global-index
  form: one gather, then one multiply per element.  The CPU path and the
  card-side checks use it; the kernel is bit-equal to it.
* ``bucket_gather_cuda`` — the wrapper: checks its inputs and the probe's
  contract, allocates the output, launches on the current stream and raises
  if the launch failed.  ``launches`` counts its kernel launches.
* ``bucket_gather`` — the entry point: a CUDA tensor launches the kernel, a
  CPU tensor takes the plain version.

The wrapper does not bound-check ``local_idx`` (that would cost a reduction
and a host sync per call): ids must lie in ``[0, S)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

__all__ = ["ETILE", "S", "bucket_gather", "bucket_gather_cuda", "bucket_gather_ref",
           "global_rows", "launches"]

# The probe's geometry: S source rows a bucket (the block the TPU kernel pins
# in VMEM) and ETILE edges a grid step.  The CUDA kernel needs no ETILE; the
# wrapper keeps the contract e_pad % ETILE == 0 that the reference's grid sets.
S = 4096
ETILE = 1024

launches = 0
"""Kernel launches made by `bucket_gather_cuda` since the count was last reset."""


def global_rows(local_idx: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """[E] int64 rows of X: ``(e // e_pad) * S + local_idx[e]``."""
    e = local_idx.shape[0]
    return local_idx[:, 0].long() + torch.arange(e, device=local_idx.device) // (e // n_buckets) * S


def bucket_gather_ref(X: torch.Tensor, local_idx: torch.Tensor, w: torch.Tensor,
                      n_buckets: int) -> torch.Tensor:
    """Plain PyTorch bucket gather: global row ids, one gather, one multiply."""
    return X.index_select(0, global_rows(local_idx, n_buckets)) * w


def _check(X: torch.Tensor, local_idx: torch.Tensor, w: torch.Tensor, n_buckets: int) -> None:
    def fail(msg):
        raise ValueError(f"bucket_gather_cuda: {msg}")

    if X.dim() != 2 or local_idx.dim() != 2 or local_idx.shape[1] != 1:
        fail(f"X must be [N, D] and local_idx [E, 1], got {tuple(X.shape)}, "
             f"{tuple(local_idx.shape)}")
    if w.shape != local_idx.shape:
        fail(f"w must be [E, 1] like local_idx, got {tuple(w.shape)}")
    n, e = X.shape[0], local_idx.shape[0]
    if n_buckets < 1 or n != n_buckets * S:
        fail(f"X has {n} rows, not n_buckets * S = {n_buckets} * {S}")
    if e % n_buckets:
        fail(f"E = {e} edges do not split into {n_buckets} equal buckets")
    if (e // n_buckets) % ETILE:
        fail(f"e_pad = {e // n_buckets} is not a multiple of ETILE = {ETILE}")
    if local_idx.dtype != torch.int32:
        fail(f"local_idx must be int32, got {local_idx.dtype}")
    if w.dtype != torch.float32 or X.dtype != torch.float32:
        fail(f"w and X must be float32, got {w.dtype}, {X.dtype}")
    for name, t in (("X", X), ("local_idx", local_idx), ("w", w)):
        if t.device.type != "cuda":
            fail(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != X.device:
            fail(f"{name} is on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            fail(f"{name} must be contiguous")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("bucket_gather")
    fn = lib.oscillink_bucket_gather
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.oscillink_cuda_error_string.argtypes = [ctypes.c_int]
    lib.oscillink_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bucket_gather_cuda(X: torch.Tensor, local_idx: torch.Tensor, w: torch.Tensor,
                       n_buckets: int) -> torch.Tensor:
    """Launch K5 on X's device and current stream.  Raises on bad inputs, a
    broken contract or a refused launch; never falls back to the plain
    version."""
    global launches
    _check(X, local_idx, w, n_buckets)
    e, d = local_idx.shape[0], X.shape[1]
    out = torch.empty((e, d), dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.oscillink_bucket_gather(
            local_idx.data_ptr(), w.data_ptr(), X.data_ptr(), out.data_ptr(),
            e, e // n_buckets, S, d, stream,
        )
    if rc != 0:
        msg = lib.oscillink_cuda_error_string(rc).decode()
        raise RuntimeError(f"bucket_gather launch failed: CUDA error {rc} ({msg})")
    launches += 1
    return out


def bucket_gather(X: torch.Tensor, local_idx: torch.Tensor, w: torch.Tensor,
                  n_buckets: int) -> torch.Tensor:
    """Stage-1 bucket gather: ``[E, D]`` rows ``w[e] * X[bucket(e) * S + local_idx[e]]``.

    A CUDA tensor goes through kernel K5 (it launches or raises); a CPU
    tensor through K5's plain version."""
    if X.device.type == "cuda":
        return bucket_gather_cuda(X, local_idx, w, n_buckets)
    if X.device.type == "cpu":
        return bucket_gather_ref(X, local_idx, w, n_buckets)
    raise ValueError(f"bucket_gather: unsupported device {X.device}")
