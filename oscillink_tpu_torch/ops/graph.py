"""Mutual-kNN graph construction in PyTorch (port of ``oscillink_tpu/ops/graph.py``).

Behavioral contract (reference: oscillink/core/graph.py:8-93):
  * cosine similarity S = Yn @ Yn^T with row normalization Y/(||Y||+1e-12);
  * per-row top-k neighbors, ties broken by (similarity desc, index asc);
  * keep only strictly positive similarities;
  * mutual mask: an edge (i, j) survives iff j is in top-k(i) AND i is in
    top-k(j); surviving weight is max(w_ij, w_ji);
  * row-sum cap with geometric-mean scaling sqrt(scale_i * scale_j);
  * normalized-Laplacian degrees sqrt(max(rowsum, 1e-12)).

The adjacency is k-sparse from birth (padded [N, K] neighbor idx/weight
tensors); `lap_matvec` is a gather-SpMV over those rows.  On a CUDA tensor it
launches kernel K1 (`ops/kernels/spmv.py`), on a CPU tensor it runs K1's plain
version.  Similarity is f32 at full precision: `utils.device.resolve_device`
turns TF32 off on the card.

Only the exact similarity scan is ported so far; the approximate modes
("fast", "fastest", "cluster") raise NotImplementedError.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .kernels import spmv

__all__ = [
    "Graph",
    "build_graph",
    "graph_from_topk",
    "lap_matvec",
    "normalize_rows",
    "mmr_select",
    "mmr_select_np",
    "resolve_similarity",
    "stable_topk",
    "SIMILARITY_RECALL",
]

DEFAULT_BLOCK_ROWS = 1024
DENSE_TOPK_LIMIT = 4096
FAST_SIMILARITY_N = 65536
CLUSTER_SIMILARITY_N = 500_000
SIMILARITY_RECALL = {"exact": 1.0, "fast": 0.99, "fastest": 0.95, "cluster": 0.9}

# candidates fetched past k by `stable_topk`; a row whose last candidate
# still ties the k-th value is re-ranked by a full stable sort
_TOPK_SLACK = 8

_NOT_PORTED = (
    "similarity={mode!r} is not ported to oscillink_tpu_torch yet (ROADMAP.md "
    "queue A item 8: large-N and approximate builds); use similarity='exact'"
)


def resolve_similarity(n: int, mode: str, *, allow_cluster: bool = False) -> str:
    """Map ``"auto"`` to a concrete mode exactly as the JAX package does
    (``OSCILLINK_CLUSTER_SIM_N`` / ``OSCILLINK_FAST_SIM_N`` thresholds);
    concrete modes pass through unchanged."""
    if mode != "auto":
        return mode
    if allow_cluster:
        try:
            cthr = int(os.getenv("OSCILLINK_CLUSTER_SIM_N", str(CLUSTER_SIMILARITY_N)))
        except ValueError:
            cthr = CLUSTER_SIMILARITY_N
        if cthr > 0 and n >= cthr:
            return "cluster"
    try:
        thr = int(os.getenv("OSCILLINK_FAST_SIM_N", str(FAST_SIMILARITY_N)))
    except ValueError:
        thr = FAST_SIMILARITY_N
    return "fast" if n > thr else "exact"


class Graph(NamedTuple):
    """Padded k-sparse symmetric adjacency + normalized-Laplacian factors.

      idx:      [N, K] int32 — neighbor ids; arbitrary where ``w == 0``.
      w:        [N, K] float32 — capped adjacency weights; 0 on padding.
      wn:       [N, K] float32 — w_ij / (sqrt_deg_i * sqrt_deg_j); 0 on padding.
      sqrt_deg: [N] float32 — sqrt(max(row_sum(w), 1e-12)).
    """

    idx: torch.Tensor
    w: torch.Tensor
    wn: torch.Tensor
    sqrt_deg: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.idx.shape[0]

    @property
    def k_max(self) -> int:
        return self.idx.shape[1]


def normalize_rows(Y: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalize to unit length with the reference's epsilon guard."""
    return Y / (torch.linalg.vector_norm(Y, dim=1, keepdim=True) + eps)


def stable_topk(S: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis of a 2-D tensor, ordered by (value desc,
    index asc) — the order of ``jax.lax.top_k``, which ``torch.topk`` does
    not promise.

    ``torch.topk`` picks k + slack candidates; they are re-sorted stably
    by index and then by value.  The result is exact wherever the last
    candidate is strictly below the k-th value (then every entry that ties
    the k-th value is a candidate).  Rows where it is not (long runs of
    equal similarities, e.g. duplicate anchors) take a full stable sort.
    Returns (values, int64 indices)."""
    n = S.shape[1]
    kc = min(n, k + _TOPK_SLACK)
    cv, ci = torch.topk(S, kc, dim=1)
    ci, perm = torch.sort(ci, dim=1)
    cv = torch.gather(cv, 1, perm)
    cv, perm = torch.sort(cv, dim=1, descending=True, stable=True)
    ci = torch.gather(ci, 1, perm)
    vals, idx = cv[:, :k].contiguous(), ci[:, :k].contiguous()
    if kc < n:
        tied = cv[:, kc - 1] >= cv[:, k - 1]
        if bool(tied.any()):
            rows = tied.nonzero()[:, 0]
            v_full, i_full = torch.sort(S[rows], dim=1, descending=True, stable=True)
            vals[rows] = v_full[:, :k]
            idx[rows] = i_full[:, :k]
    return vals, idx


def _topk_dense(Yn: torch.Tensor, k: int, jitter: Optional[torch.Tensor] = None):
    """Dense [N, N] similarity + top-k. Used for moderate N."""
    n = Yn.shape[0]
    S = Yn @ Yn.T
    if jitter is not None:
        S = S + jitter
    diag = torch.arange(n, device=Yn.device)
    S[diag, diag] = -torch.inf
    vals, idx = stable_topk(S, k)
    return vals, idx.to(torch.int32)


def _topk_blocked(Yn: torch.Tensor, k: int, block_rows: int):
    """Blocked similarity top-k of every row of ``Yn`` against all rows,
    self excluded.  O(block * N) memory; the ragged last block needs no
    padding."""
    n = Yn.shape[0]
    vals = torch.empty((n, k), dtype=torch.float32, device=Yn.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=Yn.device)
    for r0 in range(0, n, block_rows):
        r1 = min(r0 + block_rows, n)
        S = Yn[r0:r1] @ Yn.T  # [B, N]
        rows = torch.arange(r1 - r0, device=Yn.device)
        S[rows, rows + r0] = -torch.inf
        v, i = stable_topk(S, k)
        vals[r0:r1] = v
        idx[r0:r1] = i.to(torch.int32)
    return vals, idx


def build_graph(
    Y: torch.Tensor,
    k: int,
    *,
    row_cap: float = 1.0,
    jitter: Optional[torch.Tensor] = None,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    dense_limit: int = DENSE_TOPK_LIMIT,
    similarity: str = "exact",
) -> Graph:
    """Build the mutual-kNN graph on Y's device. ``k`` must be pre-clamped
    to [1, N-1].  ``jitter`` is an optional [N, N] tie-break perturbation
    added to the similarities (the reference's seed mode); it takes the
    dense path whatever N.  Only ``similarity="exact"`` (or an ``"auto"``
    that resolves to it) is ported."""
    n = Y.shape[0]
    similarity = resolve_similarity(n, similarity)
    if similarity in ("fast", "fastest", "cluster"):
        raise NotImplementedError(_NOT_PORTED.format(mode=similarity))
    if similarity != "exact":
        raise ValueError(f"unknown similarity mode {similarity!r}")
    Yn = normalize_rows(Y.to(torch.float32))
    if jitter is not None or n <= dense_limit:
        vals, idx = _topk_dense(Yn, k, jitter)
    else:
        vals, idx = _topk_blocked(Yn, k, block_rows)
    return graph_from_topk(vals, idx, row_cap=row_cap)


def graph_from_topk(vals: torch.Tensor, idx: torch.Tensor, *, row_cap: float = 1.0) -> Graph:
    """Mutual mask + row cap + Laplacian factors from full [N, K] top-k
    tensors (``idx`` int32).  O(N K^2): the [N, K, K] neighbour-of-neighbour
    gather is 2 MB at 131072 x 8."""
    n = idx.shape[0]
    il = idx.long()
    w_ij = torch.clamp_min(vals, 0.0)
    self_ids = torch.arange(n, dtype=torch.int32, device=idx.device)[:, None, None]
    back_edge = idx[il] == self_ids  # [N, K, K]: does neighbor j list me?
    mutual = back_edge.any(dim=-1)
    vals_nbr = torch.clamp_min(vals[il], 0.0)
    w_ji = torch.where(back_edge, vals_nbr, 0.0).sum(dim=-1)
    keep = (w_ij > 0) & mutual & (w_ji > 0)
    w = torch.where(keep, torch.maximum(w_ij, w_ji), 0.0)

    sums = w.sum(dim=1) + 1e-12
    scale = torch.clamp_max(row_cap / sums, 1.0)
    w = w * torch.sqrt(scale[:, None] * scale[il])

    deg = w.sum(dim=1)
    sqrt_deg = torch.sqrt(torch.clamp_min(deg, 1e-12))
    inv_sd = 1.0 / sqrt_deg
    wn = w * inv_sd[:, None] * inv_sd[il]
    wn = torch.where(w > 0, wn, 0.0)
    return Graph(idx=idx.contiguous(), w=w, wn=wn.contiguous(), sqrt_deg=sqrt_deg)


def lap_matvec(g: Graph, X: torch.Tensor) -> torch.Tensor:
    """(L_sym X)[i] = X[i] - sum_a wn[i,a] X[idx[i,a]].

    A CUDA tensor goes through kernel K1 (it launches or raises); a CPU
    tensor through K1's plain version."""
    if X.device.type == "cuda":
        return spmv.lap_matvec_cuda(g.idx, g.wn, X)
    if X.device.type == "cpu":
        return spmv.lap_matvec_ref(g.idx, g.wn, X)
    raise ValueError(f"lap_matvec: unsupported device {X.device}")


def mmr_select(
    Yn: torch.Tensor, scores: torch.Tensor, k: int, lambda_div: float = 0.5
) -> torch.Tensor:
    """Greedy maximal-marginal-relevance selection on device:
    val_i = (1 - lambda) * score_i - lambda * max_{j chosen} cos(i, j), the
    first pick by pure score; argmax takes the lowest index on ties.
    Returns [k] int64 picks in selection order (no host sync per pick)."""
    n = Yn.shape[0]
    k = min(k, n)
    chosen = torch.zeros(n, dtype=torch.bool, device=Yn.device)
    simmax = torch.full((n,), -torch.inf, dtype=torch.float32, device=Yn.device)
    picks = []
    for t in range(k):
        div = torch.zeros_like(simmax) if t == 0 else simmax
        val = (1.0 - lambda_div) * scores - lambda_div * div
        val = torch.where(chosen, -torch.inf, val)
        pick = torch.argmax(val)
        chosen[pick] = True
        simmax = torch.maximum(simmax, Yn @ Yn[pick])
        picks.append(pick)
    if not picks:
        return torch.zeros(0, dtype=torch.int64, device=Yn.device)
    return torch.stack(picks)


def mmr_select_np(
    Yn: np.ndarray, scores: np.ndarray, k: int, lambda_div: float = 0.5
) -> list[int]:
    """Host-NumPy twin of `mmr_select` — same rule, same tie-break."""
    n = Yn.shape[0]
    k = min(k, n)
    chosen: list[int] = []
    mask = np.zeros(n, dtype=bool)
    simmax = np.full(n, -np.inf, dtype=np.float32)
    for t in range(k):
        div = np.zeros(n, dtype=np.float32) if t == 0 else simmax
        val = np.where(mask, -np.inf, (1.0 - lambda_div) * scores - lambda_div * div)
        pick = int(np.argmax(val))
        chosen.append(pick)
        mask[pick] = True
        simmax = np.maximum(simmax, Yn @ Yn[pick])
    return chosen
