"""Sharded mutual-kNN graph build: each shard top-k's its own rows (port of
``oscillink_tpu/parallel/sharded_build.py``).

The O(N² D) similarity scan is the graph build's dominant cost.  Every
shard normalises its row block, all-gathers the normalised anchors once
(`mesh.all_gather`) and scans only its own rows against them, with its row
offset for self-exclusion — the port's `_topk_blocked` (exact) or
`_topk_blocked_fast` (fast, fastest).  The O(N K²) mutual-mask, cap and
normalise stage then runs once on the gathered [N, K] top-k arrays
(`ops.graph.graph_from_topk`, on the first shard's device), the same ops in
the same order as the single-device `build_graph`'s blocked path.
"""

from __future__ import annotations

import torch

from ..ops.graph import (
    DEFAULT_BLOCK_ROWS,
    Graph,
    _topk_blocked,
    _topk_blocked_fast,
    graph_from_topk,
    normalize_rows,
    resolve_similarity,
)
from .mesh import Mesh, all_gather, split_rows

__all__ = ["build_graph_sharded"]


def build_graph_sharded(
    mesh: Mesh,
    Y,
    k: int,
    *,
    row_cap: float = 1.0,
    similarity: str = "exact",
    axis_name: str = "rows",
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> Graph:
    """Mutual-kNN graph over a row-sharded mesh; the contract of
    `ops.graph.build_graph` (exact top-k unless ``similarity`` is fast or
    fastest; ``"auto"`` resolves by N).  N must divide the mesh size.  Y
    is a tensor on any device or a numpy array; the graph lands on the
    first shard's device."""
    n = Y.shape[0]
    similarity = resolve_similarity(n, similarity)
    if similarity == "cluster":
        raise ValueError(
            "similarity='cluster' (IVF) is single-device only; callers must "
            "realize it as 'fast' before the sharded build (service/sharded_path.py)"
        )
    if similarity not in ("exact", "fast", "fastest"):
        raise ValueError(f"unknown similarity mode {similarity!r}")
    if n % mesh.size != 0:
        raise ValueError(f"N={n} must divide mesh size {mesh.size}")
    rows_per = n // mesh.size
    br = min(block_rows, rows_per)
    Yn_l = [normalize_rows(y) for y in split_rows(mesh, Y, torch.float32)]
    Yn_full = all_gather(mesh, Yn_l)
    topk = _topk_blocked if similarity == "exact" else _topk_blocked_fast
    vals, idx = zip(*(topk(Yn_l[s], k, br, Yn_all=Yn_full[s], row_offset=s * rows_per)
                      for s in range(mesh.size)))
    del Yn_full
    return graph_from_topk(all_gather(mesh, vals)[0], all_gather(mesh, idx)[0], row_cap=row_cap)
