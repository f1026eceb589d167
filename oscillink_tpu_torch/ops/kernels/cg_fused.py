"""The gather route's CG iteration as three hand-written passes.

`ops/solver.py` `cg_solve_lanes` runs an iteration on an [N, C] float32
block with its rows on dim 0 (C = D, or L·D for L lanes side by side) as

* pass 1, `combine` — the coherence operator's λ-combination over kernel
  K1's output, ``Ap = ((λ_G p + λ_C L) + λ_Q (B ⊙ p))`` (settle form
  ``p + dt·that``) written into L's buffer, with the partials of ⟨p, Ap⟩;
  or `dot`, those partials alone, for an operator that returns a block;
* `alpha` — ``α = rz / (Σ partials + 1e-18)``;
* pass 2, `update` — ``x += p α``, ``r −= Ap α``, ``z = r ⊙ inv_M`` in
  registers, the partials of ⟨r, z⟩ and ⟨r, r⟩ (`residual`: its start form,
  ``r = b − A x0``, ``p = z``);
* `finish` — ``rz' = Σ partials``, ``β = rz' / (rz + 1e-18)``, and the
  residual: per lane, the max over its columns of ``sqrt(Σ r²)``;
* pass 3, `direction` — ``p = z + p β``.

The CUDA source is ``oscillink_tpu_torch/csrc/cg_fused.cu`` (its header
says what bounds the passes and how the design answers it).  Each entry
point takes a CUDA tensor through its kernel (it launches or raises, and
never falls back) and a CPU tensor through its plain PyTorch twin
(``*_ref``), which repeats the kernel's elementwise arithmetic bit for bit:
each product and sum rounded on its own, as the classic expressions
``x + p * alpha``, ... round.  ``launches`` counts the kernel launches.

A partials tensor is ``[rows, C]`` float64 whose column sums are the
reduction: ⟨a, b⟩ by column, or for ⟨r, r⟩ the squared column norms.  The
kernels write one row per stripe of the block's rows (`plan`), each summed
in float64, and `alpha` and `finish` add the rows in a fixed order and
round once to float32.  The twins write one row, the column sums as
``torch.sum`` and ``torch.linalg.vector_norm`` give them, so that on the
CPU the fused route is the classic body bit for bit; on the card only the
order and precision of the column sums differ from it.

Blocks are taken as they come (any shape with rows on dim 0, contiguous),
``inv_M`` as an [N] vector, the per-column scalars (α, β, rz) as [C]
vectors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import load_library

__all__ = ["THREADS", "TARGET_CTAS", "alpha", "alpha_ref", "combine", "combine_ref",
           "direction", "direction_ref", "dot", "dot_ref", "finish", "finish_ref",
           "launches", "plan", "residual", "residual_ref", "update", "update_ref"]

launches = 0
"""Kernel launches made by this module's CUDA wrappers since the count was
last reset (a `finish` with the residual is two)."""

THREADS = 256
"""Threads a CTA of the streaming passes (csrc/cg_fused.cu ``kThreads``)."""

TARGET_CTAS = 1056
"""CTAs a streaming pass aims for: eight of 256 threads on each of the
H100's 132 SMs."""


def plan(n: int, c: int, v: int) -> tuple[int, int, int]:
    """(tx, rows, stripes) of a streaming pass over an [n, c] block read
    ``v`` floats at a time: tx threads across a tile of vector columns (the
    power of two at or above c / v, at most 32), the rows of a stripe, and
    the stripes, which set the partials' rows.  A stripe holds at least one
    row for each of the CTA's 256 / tx thread rows."""
    cols = c // v
    tx = min(32, 1 << max(0, (cols - 1).bit_length()))
    tiles = -(-cols // tx)
    stripes = max(1, min(n // (THREADS // tx), TARGET_CTAS // tiles))
    rows = -(-n // stripes)
    return tx, rows, -(-n // rows)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """The [N, C] view of a block with its rows on dim 0."""
    return t.view(t.shape[0], -1)


def _width(c: int, tensors) -> int:
    """4 (float4) when C is a multiple of 4 and every block is 16-byte
    aligned, else 1."""
    if c % 4 or any(t.data_ptr() % 16 for t in tensors if t is not None):
        return 1
    return 4


def _dot_parts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The twins' partials of ⟨a, b⟩: one row, ``torch.sum``'s column sums."""
    return torch.sum(a * b, dim=0, keepdim=True).double()


def _norm_parts(r: torch.Tensor) -> torch.Tensor:
    """The twins' partials of ⟨r, r⟩: one row, the squared column norms
    (exact in float64, so `finish_ref`'s square root gives the norms back)."""
    return torch.linalg.vector_norm(r, dim=0, keepdim=True).double() ** 2


# -- plain PyTorch twins -------------------------------------------------------


def combine_ref(X: torch.Tensor, L: torch.Tensor, lam, B: torch.Tensor,
                dt: Optional[float] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: the classic operator's expression over ``L = lap_matvec(X)``,
    ``lamG·X + lamC·L + lamQ·(B·X)`` (``X + dt·that`` with ``dt``), written
    into L's buffer; returns (L, ⟨X, Ap⟩ partials)."""
    X2, L2 = _rows(X), _rows(L)
    Ap = lam.lamG * X2 + lam.lamC * L2 + lam.lamQ * (B[:, None] * X2)
    if dt is not None:
        Ap = X2 + dt * Ap
    L2.copy_(Ap)
    return L, _dot_parts(X2, L2)


def dot_ref(p: torch.Tensor, Ap: torch.Tensor) -> torch.Tensor:
    """Pass 1's dot form: the ⟨p, Ap⟩ partials."""
    return _dot_parts(_rows(p), _rows(Ap))


def residual_ref(b: torch.Tensor, Ax: torch.Tensor, inv_M: Optional[torch.Tensor]):
    """Pass 2's start form: r = b − Ax and p = z = r·inv_M (r without
    inv_M), two new blocks of b's shape; returns (r, p, ⟨r, z⟩ partials)."""
    r2 = _rows(b) - _rows(Ax)
    z2 = r2.clone() if inv_M is None else r2 * inv_M[:, None]
    return r2.view(b.shape), z2.view(b.shape), _dot_parts(r2, z2)


def update_ref(x: torch.Tensor, x_out: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
               Ap: torch.Tensor, alpha: torch.Tensor, inv_M: Optional[torch.Tensor]):
    """Pass 2: x_out = x + p·α (x_out may be x), r −= Ap·α in place, z =
    r·inv_M; returns the ⟨r, z⟩ and ⟨r, r⟩ partials."""
    r2 = _rows(r)
    _rows(x_out).copy_(_rows(x) + _rows(p) * alpha)
    r2.copy_(r2 - _rows(Ap) * alpha)
    z2 = r2 if inv_M is None else r2 * inv_M[:, None]
    return _dot_parts(r2, z2), _norm_parts(r2)


def direction_ref(p: torch.Tensor, r: torch.Tensor, beta: torch.Tensor,
                  inv_M: Optional[torch.Tensor]) -> None:
    """Pass 3: p = z + p·β in place, z = r·inv_M (r without inv_M)."""
    r2, p2 = _rows(r), _rows(p)
    z2 = r2 if inv_M is None else r2 * inv_M[:, None]
    p2.copy_(z2 + p2 * beta)


def alpha_ref(pap: torch.Tensor, rz: torch.Tensor) -> torch.Tensor:
    """α = rz / (Σ ⟨p, Ap⟩ partials + 1e-18), [C] float32."""
    return rz / (pap.sum(0).float() + 1e-18)


def finish_ref(prz: torch.Tensor, rz_old: Optional[torch.Tensor] = None,
               prr: Optional[torch.Tensor] = None, lanes: int = 1):
    """(rz', β, res): rz' = Σ ⟨r, z⟩ partials; β = rz' / (rz_old + 1e-18)
    when rz_old is given; res [lanes], the max over each lane's columns of
    sqrt(Σ ⟨r, r⟩ partials), when those are given (NaN-propagating, as
    ``torch.amax``)."""
    rz_new = prz.sum(0).float()
    beta = None if rz_old is None else rz_new / (rz_old + 1e-18)
    res = None if prr is None else prr.sum(0).sqrt().float().view(lanes, -1).amax(1)
    return rz_new, beta, res


# -- the kernels ---------------------------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("cg_fused")
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sigs = {
        "oscillink_cg_combine": [ptr] * 6 + [ctypes.c_float, i32, ll, ll, ll, i32, i32, ptr, ptr],
        "oscillink_cg_update": [ptr] * 8 + [i32, ll, ll, ll, i32, i32, ptr, ptr],
        "oscillink_cg_direction": [ptr] * 4 + [ll, ll, ll, i32, i32, ptr],
        "oscillink_cg_alpha": [ptr, ll, ll, ptr, ptr, ptr],
        "oscillink_cg_finish": [ptr, ptr, ll, ll] + [ptr] * 5 + [ll, ptr],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.oscillink_cuda_error_string.argtypes = [ctypes.c_int]
    lib.oscillink_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn: str, like: torch.Tensor, blocks=(), vectors=(), scalars=()) -> None:
    """Every tensor on ``like``'s CUDA device, float32 and contiguous; the
    blocks of like's shape, the [N] and [C] vectors and 0-d scalars of theirs."""
    n, c = like.shape[0], like.numel() // max(1, like.shape[0])
    if like.device.type != "cuda":
        raise ValueError(f"{fn}: blocks must be CUDA tensors, got {like.device}")
    named = ([(name, t, like.shape) for name, t in blocks]
             + [(name, t, (size,)) for name, t, size in vectors]
             + [(name, t, ()) for name, t in scalars])
    for name, t, shape in named:
        if t is None:
            continue
        if t.device != like.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, the block on {like.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous of shape {tuple(shape)}, got "
                             f"{tuple(t.shape)} (contiguous: {t.is_contiguous()})")
    if n < 1 or c < 1:
        raise ValueError(f"{fn}: empty block {tuple(like.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(fn: str, like: torch.Tensor, *args, count: int = 1) -> None:
    global launches
    lib = _library()
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.oscillink_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} ({msg})")
    launches += count


def _parts(like: torch.Tensor, k: int, stripes: int, c: int) -> torch.Tensor:
    return torch.empty((k, stripes, c), dtype=torch.float64, device=like.device)


def _combine_cuda(X, L, lam, B, dt, mode):
    blocks = [("X", X), ("Ap" if mode == 0 else "L", L)]
    _check("cg_fused.combine", X, blocks,
           vectors=[] if mode == 0 else [("B", B, X.shape[0])],
           scalars=[] if mode == 0 else [("lamG", lam.lamG), ("lamC", lam.lamC),
                                         ("lamQ", lam.lamQ)])
    n, c = _rows(X).shape
    v = _width(c, (X, L))
    tx, rows, stripes = plan(n, c, v)
    parts = _parts(X, 1, stripes, c)
    lams = (None, None, None) if mode == 0 else (lam.lamG, lam.lamC, lam.lamQ)
    _launch("oscillink_cg_combine", X, X.data_ptr(), L.data_ptr(), _ptr(B),
            *map(_ptr, lams), float(dt or 0.0), mode, n, c, rows, tx, v, parts.data_ptr())
    return parts[0]


def _update_cuda(x, x_out, r_in, r_out, p, Ap, alpha, inv_M, init):
    n, c = _rows(r_in).shape
    _check("cg_fused.update", r_in,
           [("x", x), ("x_out", x_out), ("r", r_in), ("r_out", r_out), ("p", p), ("Ap", Ap)],
           vectors=[("alpha", alpha, c), ("inv_M", inv_M, n)])
    v = _width(c, (x, x_out, r_in, r_out, p, Ap, alpha))
    tx, rows, stripes = plan(n, c, v)
    parts = _parts(r_in, 1 if init else 2, stripes, c)
    _launch("oscillink_cg_update", r_in, _ptr(x), _ptr(x_out), r_in.data_ptr(),
            r_out.data_ptr(), p.data_ptr(), Ap.data_ptr(), _ptr(alpha), _ptr(inv_M), int(init),
            n, c, rows, tx, v, parts.data_ptr())
    return parts


# -- entry points: a CUDA tensor through its kernel, a CPU one through its twin --


def _on_cpu(t: torch.Tensor, fn: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"cg_fused.{fn}: unsupported device {t.device}")


def combine(X: torch.Tensor, L: torch.Tensor, lam, B: torch.Tensor,
            dt: Optional[float] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 over K1's output ``L`` (overwritten with Ap): returns (Ap, the
    ⟨X, Ap⟩ partials).  ``lam``'s λ_G, λ_C, λ_Q are 0-d tensors on X's
    device, read by the kernel where they lie; ``B`` is [N]; ``dt``, a
    Python number, gives the settle form."""
    if _on_cpu(X, "combine"):
        return combine_ref(X, L, lam, B, dt)
    return L, _combine_cuda(X, L, lam, B, dt, 1 if dt is None else 2)


def dot(p: torch.Tensor, Ap: torch.Tensor) -> torch.Tensor:
    """The ⟨p, Ap⟩ partials of an operator's block."""
    if _on_cpu(p, "dot"):
        return dot_ref(p, Ap)
    return _combine_cuda(p, Ap, None, None, None, 0)


def residual(b: torch.Tensor, Ax: torch.Tensor, inv_M: Optional[torch.Tensor]):
    """The start: (r = b − Ax, p = z, ⟨r, z⟩ partials), r and p new blocks."""
    if _on_cpu(b, "residual"):
        return residual_ref(b, Ax, inv_M)
    r, p = torch.empty_like(b), torch.empty_like(b)
    parts = _update_cuda(None, None, b, r, p, Ax, None, inv_M, True)
    return r, p, parts[0]


def update(x: torch.Tensor, x_out: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
           Ap: torch.Tensor, alpha: torch.Tensor, inv_M: Optional[torch.Tensor]):
    """Pass 2 (x_out may be x; r in place): returns the ⟨r, z⟩ and ⟨r, r⟩
    partials."""
    if _on_cpu(r, "update"):
        return update_ref(x, x_out, r, p, Ap, alpha, inv_M)
    parts = _update_cuda(x, x_out, r, r, p, Ap, alpha, inv_M, False)
    return parts[0], parts[1]


def direction(p: torch.Tensor, r: torch.Tensor, beta: torch.Tensor,
              inv_M: Optional[torch.Tensor]) -> None:
    """Pass 3, p in place."""
    if _on_cpu(p, "direction"):
        return direction_ref(p, r, beta, inv_M)
    n, c = _rows(p).shape
    _check("cg_fused.direction", p, [("p", p), ("r", r)],
           vectors=[("beta", beta, c), ("inv_M", inv_M, n)])
    v = _width(c, (p, r, beta))
    tx, rows, _ = plan(n, c, v)
    _launch("oscillink_cg_direction", p, p.data_ptr(), r.data_ptr(), beta.data_ptr(),
            _ptr(inv_M), n, c, rows, tx, v)
    return None


def _check_parts(fn: str, parts: torch.Tensor, c: int) -> None:
    if (parts.dtype != torch.float64 or parts.dim() != 2 or parts.shape[1] != c
            or not parts.is_contiguous() or parts.shape[0] < 1):
        raise ValueError(f"{fn}: partials must be contiguous float64 [stripes, {c}], got "
                         f"{parts.dtype} {tuple(parts.shape)}")


def alpha(pap: torch.Tensor, rz: torch.Tensor) -> torch.Tensor:
    """α [C] from the ⟨p, Ap⟩ partials and rz [C]."""
    if _on_cpu(rz, "alpha"):
        return alpha_ref(pap, rz)
    c = rz.numel()
    _check("cg_fused.alpha", rz, vectors=[("rz", rz, c)])
    _check_parts("cg_fused.alpha", pap, c)
    out = torch.empty_like(rz)
    _launch("oscillink_cg_alpha", rz, pap.data_ptr(), pap.shape[0], c, rz.data_ptr(),
            out.data_ptr())
    return out


def finish(prz: torch.Tensor, rz_old: Optional[torch.Tensor] = None,
           prr: Optional[torch.Tensor] = None, lanes: int = 1):
    """(rz' [C], β [C] or None, res [lanes] or None), as `finish_ref`."""
    if _on_cpu(prz, "finish"):
        return finish_ref(prz, rz_old, prr, lanes)
    c = prz.shape[-1]
    if prr is not None and (lanes < 1 or c % lanes):
        raise ValueError(f"cg_fused.finish: {c} columns do not split into {lanes} lanes")
    _check_parts("cg_fused.finish", prz, c)
    if prr is not None:
        _check_parts("cg_fused.finish", prr, c)
    rz_new = prz.new_empty((c,), dtype=torch.float32)
    _check("cg_fused.finish", rz_new, vectors=[("rz_old", rz_old, c)])
    beta = None if rz_old is None else torch.empty_like(rz_new)
    norm = None if prr is None else torch.empty_like(rz_new)
    res = None if prr is None else rz_new.new_empty((lanes,))
    _launch("oscillink_cg_finish", rz_new, prz.data_ptr(), _ptr(prr), prz.shape[0], c,
            _ptr(rz_old), rz_new.data_ptr(), _ptr(beta), _ptr(norm), _ptr(res), lanes,
            count=1 if prr is None else 2)
    return rz_new, beta, res
