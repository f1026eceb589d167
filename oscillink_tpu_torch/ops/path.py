"""Chain-prior path Laplacian as an edge-list op (port of ``oscillink_tpu/ops/path.py``).

Behavioral contract (reference: oscillink/core/graph.py:96-111): a path
adjacency over an ordered chain, weights max-combined on duplicate edges,
then its normalized Laplacian.  Nodes outside the chain have degree 0, so
their Laplacian row is the identity row: ``L_path X = X - W_path X`` acts on
ALL nodes.  The matvec is two gathers and two scatter-adds.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = ["PathGraph", "build_path_graph", "path_lap_matvec"]


class PathGraph(NamedTuple):
    """Undirected weighted edge list with normalized-Laplacian factors.

    src, dst: [E] int32 (src < dst for regular edges, sorted)
    w:        [E] float32 adjacency weights
    wn:       [E] float32 degree-normalized weights (self-loops pre-halved)
    sqrt_deg: [N] float32 sqrt(max(deg, 1e-12)) over path adjacency
    """

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    wn: torch.Tensor
    sqrt_deg: torch.Tensor

    @property
    def n_edges(self) -> int:
        return self.src.shape[0]


def build_path_graph(
    n: int,
    chain: Sequence[int],
    weights: Optional[Sequence[float]] = None,
    *,
    device: torch.device,
) -> PathGraph:
    """Build the path graph from an ordered chain on the host (chains are
    tiny) and place it on ``device``: consecutive chain nodes are linked,
    out-of-range indices dropped, duplicate edges keep the max weight."""
    if weights is None:
        weights = [1.0] * max(0, len(chain) - 1)
    edge_w: dict[tuple[int, int], float] = {}
    for a in range(len(chain) - 1):
        i, j = int(chain[a]), int(chain[a + 1])
        if not (0 <= i < n and 0 <= j < n):
            continue
        key = (min(i, j), max(i, j))
        edge_w[key] = max(edge_w.get(key, 0.0), float(weights[a]))

    keys = sorted(edge_w)
    src = np.array([k[0] for k in keys], dtype=np.int32)
    dst = np.array([k[1] for k in keys], dtype=np.int32)
    w = np.array([edge_w[k] for k in keys], dtype=np.float32)

    deg = np.zeros(n, dtype=np.float32)
    for s, d, ww in zip(src, dst, w):
        deg[s] += ww
        if d != s:
            deg[d] += ww
    sqrt_deg = np.sqrt(np.maximum(deg, 1e-12)).astype(np.float32)
    wn = (w / (sqrt_deg[src] * sqrt_deg[dst])).astype(np.float32)
    # self-loops would be scattered from both endpoints; pre-halve
    wn = np.where(src == dst, 0.5 * wn, wn).astype(np.float32)
    return PathGraph(*(torch.from_numpy(a).to(device) for a in (src, dst, w, wn, sqrt_deg)))


def path_lap_matvec(pg: PathGraph, X: torch.Tensor) -> torch.Tensor:
    """(L_path X) = X - D^-1/2 A_path D^-1/2 X via edge-parallel scatter-add."""
    if pg.n_edges == 0:
        return X
    Xs = X.index_select(0, pg.src)
    Xd = X.index_select(0, pg.dst)
    acc = torch.zeros_like(X)
    acc.index_add_(0, pg.src, pg.wn[:, None] * Xd)
    acc.index_add_(0, pg.dst, pg.wn[:, None] * Xs)
    return X - acc
