"""Query-time preprocessors: diffusion gates."""

from .diffusion import compute_diffusion_gates  # noqa: F401
