"""Row reordering and halo analysis for sharded lattices (port of
``oscillink_tpu/parallel/reorder.py``).

A mesh tier's cross-shard traffic is the neighbour halo: the unique remote
rows each shard's gathers touch.  For unordered rows the halo approaches the
full row set, which is why the all-gather tier (`shardmap_cg`) gathers
everything.  Reordering rows so that embedding-space neighbours get nearby
indices shrinks it:

* `pca_bisection_order(Y, levels)` — recursive principal-direction
  bisection: per segment a centred power iteration on the caller's device in
  float32, then the median split and a stable argsort on the host;
* `halo_stats(idx, w, n_shards)` — per-shard unique-remote-row counts, the
  all-gather-versus-halo-exchange decision metric (``w`` filters padding);
* `apply_order` — reorder row-indexed arrays and return the inverse.

`halo_stats` and `apply_order` are numpy only, copies of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

__all__ = ["pca_bisection_order", "halo_stats", "apply_order"]


def _leading_direction(Yc: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Principal direction by power iteration on the centred Gram matrix.
    ``Yc`` must be mean-subtracted: on uncentred data the leading
    eigenvector of Y^T Y is about the corpus mean and the median split
    orders rows by noise."""
    d = Yc.shape[1]
    v = torch.ones(d, dtype=torch.float32, device=Yc.device) / torch.sqrt(
        torch.tensor(float(d), dtype=torch.float32, device=Yc.device))
    for _ in range(iters):
        w = Yc.T @ (Yc @ v)
        v = w / (torch.linalg.vector_norm(w) + 1e-12)
    return v


def _segment_projection(Ys: torch.Tensor) -> torch.Tensor:
    """Projection of a segment onto its own centred principal direction."""
    Yc = Ys - torch.mean(Ys, dim=0, keepdim=True)
    return Yc @ _leading_direction(Yc)


def pca_bisection_order(Y: np.ndarray, levels: int = 3, *,
                        device: DeviceLike = None) -> np.ndarray:
    """A permutation ordering rows by recursive PCA bisection.

    Each level splits a segment at the median of its projection onto the
    segment's own principal direction; leaves stay projection-sorted.  The
    projections are computed on ``device`` (``cuda`` unless given) from Y
    copied there once; the sort and the split run on the host."""
    dev = resolve_device(device)
    Y = np.asarray(Y, dtype=np.float32)
    Yd = torch.from_numpy(np.ascontiguousarray(Y)).to(dev)
    return _bisect(Yd, np.arange(Y.shape[0]), 1, levels)


def _bisect(Yd: torch.Tensor, ids: np.ndarray, depth: int, levels: int) -> np.ndarray:
    """`pca_bisection_order`'s recursion on the rows ``ids`` of the device
    copy ``Yd``.  A module function, not a closure: a closure that calls
    itself is a reference cycle, which would hold ``Yd`` on the device
    until the garbage collector ran."""
    if len(ids) <= 2:
        return ids
    sel = torch.from_numpy(ids).to(Yd.device)
    proj = _segment_projection(Yd.index_select(0, sel)).cpu().numpy()
    sorted_ids = ids[np.argsort(proj, kind="stable")]
    if depth >= levels:
        return sorted_ids
    mid = len(sorted_ids) // 2
    return np.concatenate([_bisect(Yd, sorted_ids[:mid], depth + 1, levels),
                           _bisect(Yd, sorted_ids[mid:], depth + 1, levels)])


def apply_order(order: np.ndarray, *arrays: np.ndarray):
    """Reorder row-indexed arrays; returns (reordered..., inverse_order)."""
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return tuple(np.asarray(a)[order] for a in arrays) + (inv,)


def halo_stats(idx: np.ndarray, w: np.ndarray, n_shards: int) -> dict:
    """Per-shard halo sizes for a padded [N, K] neighbour structure.

    halo(s) = unique neighbour rows outside shard s that shard s's valid
    edges reference.  Returns totals plus the halo fraction (halo / shard
    rows) — the all-gather-versus-halo-exchange decision metric."""
    n = idx.shape[0]
    if n % n_shards != 0:
        raise ValueError(f"N={n} is not divisible by n_shards={n_shards}")
    rows_per = n // n_shards
    halos = []
    for s in range(n_shards):
        lo, hi = s * rows_per, (s + 1) * rows_per
        nbrs = np.unique(idx[lo:hi][w[lo:hi] > 0])
        halos.append(len(nbrs[(nbrs < lo) | (nbrs >= hi)]))
    halos = np.asarray(halos)
    return {
        "n_shards": n_shards,
        "rows_per_shard": rows_per,
        "halo_min": int(halos.min()),
        "halo_max": int(halos.max()),
        "halo_mean": float(halos.mean()),
        "halo_fraction_mean": float(halos.mean() / rows_per),
        "allgather_rows": n - rows_per,  # what the all-gather tier moves
    }
