"""Energy model: the coherence lattice and its operator algebra."""

from .coherence import (  # noqa: F401
    EnergyParams,
    settle_step,
    solve_stationary,
    stationary_matvec,
)
