"""Query-time preprocessors: diffusion gates and typo autocorrect."""

from .diffusion import compute_diffusion_gates  # noqa: F401
