"""The card's published peaks, and the least time a kernel could take.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its full
700 W): 3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor
cores.  The port's kernels compute in float32 without tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def k1_bound(n: int, d: int, k: int) -> dict:
    """The least time of one apply of kernel K1 (the gather SpMV
    ``out[i] = X[i] - sum_a wn[i, a] X[idx[i, a]]``) at N rows, D columns
    and k slots a row: each input byte read once and each output byte
    written once, (2 N D + 2 N k) * 4 bytes (X and out; idx and wn), against
    2 N k D operations.  Copied from ``chip_smoke.py:time_kernel``."""
    nbytes = (2 * n * d + 2 * n * k) * 4
    flops = 2 * n * k * d
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return {"bytes": nbytes, "flops": flops, "seconds": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
