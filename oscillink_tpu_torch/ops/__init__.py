"""Compute ops: graph build, sparse Laplacian matvec, CG, receipts."""

from .graph import Graph, build_graph, lap_matvec, normalize_rows  # noqa: F401
from .path import PathGraph, build_path_graph, path_lap_matvec  # noqa: F401
from .solver import cg_solve  # noqa: F401
