"""Plain reference for a lattice whose graph is approximate (the cluster
tier's IVF build), in PyTorch, float32 with TF32 off, for the benchmark's
correctness check.  It imports nothing of the program.

* `exact_graph`: (a) the exact mutual-kNN graph, `reference.knn` in
  "exact" mode and `reference.mutual_graph`: what the approximate graph is
  judged against.
* `graph_on_edges`: (b) a `RefGraph` on a given edge set, the program's
  slots of positive weight: each weight is the float32 cosine of its pair,
  recomputed from Y with the reference's normalisation, then the mutual
  max and the row cap over that edge set, as `reference.mutual_graph`
  takes them.

Departure from `reference.py`, which takes nothing the program made: the
IVF build is approximate by design, so the check judges the program's
graph against (a), and then does the algebra (U*, the bundle) on (b), the
program's own edge set with the reference's own weights.
"""

from __future__ import annotations

import torch

from . import reference as ref


def exact_graph(Y: torch.Tensor, k: int) -> ref.RefGraph:
    k = min(k, max(1, Y.shape[0] - 1))
    return ref.mutual_graph(*ref.knn(Y, k, "exact"))


def pair_cosines(Y: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[N, k] float32 cosine of row i with row ids[i, s], one product sum a
    pair, in blocks of rows."""
    Yn = ref.normalize(Y.float())
    out = torch.empty(ids.shape, dtype=torch.float32, device=Y.device)
    for r0 in range(0, ids.shape[0], ref.EDGE_BLOCK):
        sl = slice(r0, r0 + ref.EDGE_BLOCK)
        out[sl] = (Yn[sl, None, :] * Yn[ids[sl]]).sum(dim=-1)
    return out


def graph_on_edges(Y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                   row_cap: float = 1.0) -> ref.RefGraph:
    """(b): the reference's graph on the edge set {(i, idx[i, s]): w[i, s] > 0}.
    A slot of no edge points at its own row with weight 0, so it matches no
    other row's slot in the mutual test."""
    n = idx.shape[0]
    idx, w = idx.to(Y.device).long(), w.to(Y.device)
    edge = w > 0
    ids = torch.where(edge, idx, torch.arange(n, device=Y.device)[:, None])
    vals = torch.where(edge, pair_cosines(Y, ids), 0.0)
    return ref.mutual_graph(vals, ids, row_cap)
