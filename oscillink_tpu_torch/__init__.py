"""oscillink_tpu_torch — the PyTorch / CUDA port of oscillink_tpu for NVIDIA Hopper.

Given anchor embeddings Y (N x D) and a query psi, build a mutual-kNN graph,
settle the strictly convex coherence energy

    H(U) = lamG ||U - Y||_F^2 + lamC tr(U^T L_sym U)
         + lamQ tr((U - 1 psi^T)^T B (U - 1 psi^T)) + lamP tr(U^T L_path U)

with Jacobi-preconditioned multi-RHS conjugate gradient, and emit
deterministic (optionally HMAC-signed) receipts, wire-compatible with the
JAX package.

Runs on ``cuda`` by default; ``device="cpu"`` runs the plain PyTorch
versions of the kernels.  The port imports torch and numpy only — never JAX
and never ``oscillink_tpu``.  Module paths mirror the JAX package.
"""

from __future__ import annotations

__version__ = "0.4.3"

from .core.lattice import OscillinkLattice, json_line_logger  # noqa: E402,F401
from .core.perf import compare_perf  # noqa: E402,F401
from .core.provenance import compare_provenance  # noqa: E402,F401
from .core.receipts import verify_receipt, verify_receipt_mode  # noqa: E402,F401
from .preprocess.diffusion import compute_diffusion_gates  # noqa: E402,F401

Oscillink = OscillinkLattice

__all__ = [
    "Oscillink",
    "OscillinkLattice",
    "verify_receipt",
    "verify_receipt_mode",
    "compare_perf",
    "compare_provenance",
    "compute_diffusion_gates",
    "json_line_logger",
    "__version__",
]
