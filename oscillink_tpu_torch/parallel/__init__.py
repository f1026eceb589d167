"""Multi-device scale-out: device meshes, row-sharded lattices, sharded CG
(port of ``oscillink_tpu/parallel``).  One process drives a list of
devices; a device may repeat (`mesh.lattice_mesh`)."""

from .halo_cg import build_halo_plan, halo_solve, solve_auto  # noqa: F401
from .hierarchical import hierarchical_settle  # noqa: F401
from .mesh import lattice_mesh  # noqa: F401
from .reorder import apply_order, halo_stats, pca_bisection_order  # noqa: F401
from .sharded import sharded_build_and_settle, sharded_settle_fn  # noqa: F401
from .streaming import StreamingLattice  # noqa: F401
