"""IVF (inverted-file) clustered mutual-kNN build in PyTorch (port of
``oscillink_tpu/ops/ivf.py``): sub-quadratic candidates for the
``similarity="cluster"`` tier (N >= 500000 under ``"auto"``).

  1. k-means over the unit-normalized rows (Lloyd iterations; assignments
     by an [N, C] bf16 scan with f32 sums, `graph.scan_bf16`),
  2. capacity-bounded spillover rounds, then the rows bucketed by cluster
     into a padded [C, P] table (P = bucket_factor * N / C, rounded up to
     128; overflow counted),
  3. per-cluster scan: each cluster's rows against the buckets of its
     m_probe nearest clusters, an exact f32 [P, m*P] product; ``G``
     clusters go through one ``bmm`` (`_scan_group_size`),
  4. the per-cluster top-k scattered back into row order, and an exact
     patch scan for rows that overflowed their bucket and (``spill_patch``)
     for the rows the rounds moved, each then offered to its neighbours'
     lists,
  5. `graph_from_topk` (mutual mask, row cap, Laplacian factors).

`build_graph_ivf` falls back to the dense fast scan when N is small, when
the sampled clusterability pre-gate or the sampled quality gate rejects
the corpus, or when any row overflowed; its ``info`` dict names the mode
that ran, key for key as the JAX package's.

The port's defaults are not the JAX package's: 10 balance rounds over 16
candidate centroids (the JAX package's 3 over 4) and the spill patch on (it
has none).  On an NVIDIA H100 at 522,931 x 768 over 1024 clusters (the
``beir_quora`` cell's loose corpus, PERF.md) 3 rounds over 4 left 1-14 rows
over their bucket on 10 of 15 seeds, each a fallback to the dense scan, and
10 over 16 none on 20; the rows the rounds moved (3000-4700) sit in buckets
of clusters they are not near, and without the spill patch 0.3-1.0 % of the
exact mutual graph's edges were missing, with it at most 0.002 %.  The tests
that hold the port to the JAX package pass the JAX package's values.

Spans (`utils.profiling`, recorded only inside ``recording()``): ``ivf.pregate``
(`_clusterability`), ``ivf.kmeans`` (the Lloyd loop, the balance rounds,
bucketing and the probe sets), ``ivf.scan`` (the per-cluster ``bmm`` groups
and the patch scan) and ``ivf.quality`` (`_sample_quality`).  Each ends at a
host read the build makes anyway.  Without ``spill_patch`` the patch chunks
(none when no row overflowed) come after ``ivf.scan``'s last host read and
finish under ``ivf.quality``; with it (the default) the offer's reads
wait for them.  A ``stats`` dict given to `build_graph_ivf` counts the
build's outcome.

Semantics kept from the JAX package: its ``lax.approx_max_k`` lowers to an
exact top-k off the TPU, and an exact top-k of ``overscan * k`` followed by
a top-k of k over those positions is the stable top-k of k, which is what
this module takes (`graph.stable_topk`); ``jnp.argsort`` is stable, as is
``torch.argsort(..., stable=True)`` here; scatters that JAX drops with
``mode="drop"`` write to a pad row that is sliced away.  Two differences:
the k-means sums are added in another order (centroids differ by ulps, so a
row near-tied between two centroids can change cluster), and the
clusterability null shuffles the sample's columns by a permutation drawn
from a ``torch.Generator`` seeded with 0 on the CPU, not JAX's threefry
stream (ROADMAP.md queue C).  The sums add in row order on both devices
(`_lloyd_update`), so a build gives the same bits every time.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.profiling import span
from .graph import (
    Graph,
    build_graph,
    graph_from_topk,
    normalize_rows,
    resolve_similarity,
    scan_bf16,
    stable_topk,
)

__all__ = ["build_graph_ivf", "ivf_topk"]

# bytes of one group's [G, P, m*P] f32 similarity block in the per-cluster
# scan; 512 MiB gives G = 16 at the cluster tier's C = 1024, P = 1024,
# m = 8 (64 bmm launches of 206 GFLOP each instead of 1024 small ones)
_SCAN_GROUP_BYTES = 1 << 29
# rows a patch-scan chunk scores against all N rows
_PATCH_CHUNK = 512


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _lloyd_update(A: torch.Tensor, Ys: torch.Tensor, cent: torch.Tensor, C: int, d: int):
    """One Lloyd step given the [M, C] similarity matrix: argmax-assign
    (first maximum on ties), mean, keep empty clusters' previous
    centroids, renormalize.  Shared by the full build (bf16 similarity) and
    the clusterability probe (f32).  Each cluster's sum adds its rows in
    row order (a stable sort, then one segment sum a cluster): the same
    bits on the card and the CPU, and from run to run, where a scatter-add
    on the card adds in arrival order."""
    assign = torch.argmax(A, dim=1)
    counts = torch.bincount(assign, minlength=C)
    order = torch.argsort(assign, stable=True)
    sums = torch.segment_reduce(Ys[order], "sum", lengths=counts)
    cnts = counts.to(torch.float32)
    new = sums / (cnts[:, None] + 1e-6)
    new = torch.where(cnts[:, None] > 0, new, cent)
    return normalize_rows(new)


def _rank_in_cluster(cur: torch.Tensor, sim: torch.Tensor, C: int, n: int):
    """Rank rows within their assigned cluster by DESCENDING centroid
    similarity: returns (order, a_sorted, pos) where ``order`` permutes rows
    into cluster-grouped blocks, ``a_sorted = cur[order]``, and ``pos`` is
    the 0-based rank within the cluster.  Two stable argsorts implement the
    (cluster asc, sim desc) lexsort."""
    o1 = torch.argsort(-sim, stable=True)
    o2 = torch.argsort(cur[o1], stable=True)
    order = o1[o2]
    a_sorted = cur[order]
    start = torch.searchsorted(a_sorted, torch.arange(C, dtype=a_sorted.dtype, device=cur.device))
    pos = torch.arange(n, dtype=torch.int64, device=cur.device) - start[a_sorted]
    return order, a_sorted, pos


def _scan_group_size(C: int, P: int, mP: int) -> int:
    return max(1, min(C, _SCAN_GROUP_BYTES // (P * mP * 4)))


def ivf_topk(
    Y: torch.Tensor,
    k: int,
    *,
    n_clusters: int,
    bucket_cap: int,
    m_probe: int,
    kmeans_iters: int = 6,
    patch_cap: int = 2048,
    balance_rounds: int = 10,
    balance_cands: int = 16,
    spill_patch: bool = True,
    stats: Optional[dict] = None,
):
    """Per-row approximate top-k via clustered probing.

    Returns (vals [N, k] exact-f32 sims, idx [N, k] int32, overflow int,
    filled [N] bool — False for rows that never entered a bucket and were
    not patched).  Up to ``patch_cap`` bucket-overflow rows are patched
    with an exact scan against all rows.  ``balance_rounds`` > 0 enables the
    capacity-constrained spillover: each row keeps its ``balance_cands``
    nearest centroids, and rows past a cluster's capacity (the least
    central first) move to their next candidate for the following round.
    ``spill_patch`` also patches every row the balance rounds moved off
    its nearest centroid (past ``patch_cap``), and offers each patched row
    to the lists of the rows it lists (`_offer`), so that the mutual test
    keeps its edges: a moved row sits among rows it is not near, whose
    probes do not reach its own neighbours.  The JAX package has no such
    step.  ``stats``, when given, gains the patched rows in
    ``ivf_patched_rows``.  The JAX package's ``overscan`` sizes a candidate
    pool whose stable top-k is the exact top-k this function takes directly
    (see the module docstring), so it has none."""
    n, d = Y.shape
    dev = Y.device
    C, P = n_clusters, bucket_cap
    m = min(m_probe, n_clusters)
    if m * P < k:
        raise ValueError(
            f"m_probe*bucket_cap = {m * P} must be >= k = {k} "
            "(candidate pool smaller than the requested neighbor count)"
        )
    with span("ivf.kmeans"):
        # Yn with a zero pad row n below it: an empty bucket slot's id -1 maps
        # to the pad row, as the JAX package's Yn_pad[-1] wraps to it
        Yn_pad = torch.zeros((n + 1, d), dtype=torch.float32, device=dev)
        Yn_pad[:n] = normalize_rows(Y.to(torch.float32))
        Yn = Yn_pad[:n]
        Yb = Yn.to(torch.bfloat16)

        # ---- k-means (Lloyd) on the unit sphere --------------------------------
        stride = max(n // C, 1)
        cent = normalize_rows(Yn[::stride][:C])
        for _ in range(kmeans_iters):
            A = scan_bf16(Yb, cent.to(torch.bfloat16))  # [N, C]
            cent = _lloyd_update(A, Yn, cent, C, d)
        A = scan_bf16(Yb, cent.to(torch.bfloat16))
        if balance_rounds > 0 and C >= 2:
            R = max(2, min(balance_cands, C))
            cvals, cidx = stable_topk(A, R)  # [N, R]
            del A
            ptr = torch.zeros((n, 1), dtype=torch.int64, device=dev)
            for _ in range(balance_rounds):
                cur = torch.gather(cidx, 1, ptr)[:, 0]
                sim = torch.gather(cvals, 1, ptr)[:, 0]
                order_r, _, pos_r = _rank_in_cluster(cur, sim, C, n)
                over = torch.zeros(n, dtype=torch.bool, device=dev)
                over[order_r] = pos_r >= P
                ptr = torch.where(over[:, None] & (ptr < R - 1), ptr + 1, ptr)
            assign = torch.gather(cidx, 1, ptr)[:, 0]
            a_sim = torch.gather(cvals, 1, ptr)[:, 0]
            moved = ptr[:, 0] > 0
            del cvals, cidx
        else:
            a_sim, assign = torch.max(A, dim=1)  # first maximum on ties
            moved = torch.zeros(n, dtype=torch.bool, device=dev)
            del A

        # ---- bucketize: padded [C, P] membership table -------------------------
        order, a_sorted, pos = _rank_in_cluster(assign, a_sim, C, n)
        in_cap = pos < P
        # row C is the pad row that overflow rows write to; it is sliced away
        bucket = torch.full((C + 1, P), -1, dtype=torch.int64, device=dev)
        row_t = torch.where(in_cap, a_sorted, C)
        bucket[row_t, torch.clamp_max(pos, P - 1)] = order
        bucket = bucket[:C]
        filled = torch.zeros(n, dtype=torch.bool, device=dev)
        filled[order] = in_cap

        # ---- probe sets: each cluster scans its m nearest clusters -------------
        probe = stable_topk(cent @ cent.T, m)[1]  # [C, m], self is its own argmax
        overflow = int((~in_cap).sum())  # a host read: the span ends with the work above

    with span("ivf.scan"):
        # ---- per-cluster scan, G clusters a bmm ---------------------------------
        # exact f32 (TF32 is off on the card)
        vals = torch.zeros((n, k), dtype=torch.float32, device=dev)
        idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
        G = _scan_group_size(C, P, m * P)
        for c0 in range(0, C, G):
            c1 = min(c0 + G, C)
            q_ids = bucket[c0:c1]  # [g, P]
            cand_ids = bucket[probe[c0:c1]].reshape(c1 - c0, m * P)  # [g, mP]
            q = Yn_pad[torch.where(q_ids < 0, n, q_ids)]
            cand = Yn_pad[torch.where(cand_ids < 0, n, cand_ids)]
            S = torch.bmm(q, cand.transpose(1, 2))  # [g, P, mP]
            del q, cand
            invalid = (cand_ids[:, None, :] < 0) | (cand_ids[:, None, :] == q_ids[:, :, None])
            S.masked_fill_(invalid, -torch.inf)
            del invalid
            # only occupied slots' rows are kept (the JAX package scatters the
            # empty slots' rows to its dropped row n)
            live = (q_ids >= 0).reshape(-1).nonzero()[:, 0]
            v, slot = stable_topk(S.reshape(-1, m * P)[live], k)
            del S
            grp = live // P
            sel = cand_ids[grp[:, None], slot]
            rows = q_ids.reshape(-1)[live]
            vals[rows] = v
            idx[rows] = torch.clamp_min(sel, 0)
        vals = torch.where(torch.isfinite(vals), vals, 0.0)

        # ---- exact patch scan for bucket-overflow rows --------------------------
        # the first `patch_cap` unfilled row ids, as the JAX package's index-stable
        # top_k over the unfilled mask picks them; rows past the cap stay unfilled
        miss = (~filled).nonzero()[:, 0][: min(patch_cap, n)]
        patch = torch.cat([miss, (moved & filled).nonzero()[:, 0]]) if spill_patch else miss
        cols = torch.arange(n, device=dev)
        for p0 in range(0, patch.numel(), _PATCH_CHUNK):
            rows = patch[p0:p0 + _PATCH_CHUNK]
            S = Yn[rows] @ Yn.T
            S[cols[: rows.numel()], rows] = -torch.inf
            v, j = stable_topk(S, k)
            del S
            vals[rows] = torch.where(torch.isfinite(v), v, 0.0)
            idx[rows] = j
        if spill_patch and patch.numel():
            _offer(vals, idx, patch, k)
    if stats is not None:
        stats["ivf_patched_rows"] = stats.get("ivf_patched_rows", 0) + patch.numel()
    filled[miss] = True
    return vals, idx.to(torch.int32), overflow, filled


def _offer(vals: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, k: int) -> None:
    """Offer each of ``rows`` to the lists of the rows it lists, in place:
    row j's list becomes the top k, by (similarity desc, id asc), of its own
    entries and of the offered rows that list j, each id once."""
    n = vals.shape[0]
    tgt = idx[rows].reshape(-1)
    J = torch.unique(tgt)  # sorted
    r = torch.cat([J.repeat_interleave(k), tgt])
    c = torch.cat([idx[J].reshape(-1), rows.repeat_interleave(k)])
    v = torch.cat([vals[J].reshape(-1), vals[rows].reshape(-1)])
    o = torch.argsort(r * n + c, stable=True)  # a row's own entry first among repeats
    r, c, v = r[o], c[o], v[o]
    once = torch.ones_like(r, dtype=torch.bool)
    once[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    r, c, v = r[once], c[once], v[once]
    o = torch.argsort(-v, stable=True)  # ids ascending within ties, then rows
    o = o[torch.argsort(r[o], stable=True)]
    r, c, v = r[o], c[o], v[o]
    rank = torch.arange(r.numel(), device=r.device) - torch.searchsorted(r, J)[
        torch.searchsorted(J, r)]
    keep = rank < k
    vals[r[keep], rank[keep]] = v[keep]
    idx[r[keep], rank[keep]] = c[keep]


def _kmeans_maxsim(Ys: torch.Tensor, C: int, iters: int, d: int) -> torch.Tensor:
    """Mean max centroid similarity after a small f32 sub-k-means."""
    m = Ys.shape[0]
    cent = normalize_rows(Ys[:: max(m // C, 1)][:C])
    for _ in range(iters):
        cent = _lloyd_update(Ys @ cent.T, Ys, cent, C, d)
    return torch.mean(torch.max(Ys @ cent.T, dim=1).values)


def _clusterability(Y: torch.Tensor, n_clusters: int = 256, iters: int = 4, sample: int = 16384):
    """(observed, null) mean max centroid similarity of a sampled
    sub-k-means: a cheap predictor of whether the IVF scan will pass its
    quality gate.  The null is the same statistic on a per-column shuffle
    of the sample: it keeps every marginal but destroys cross-dimension
    structure, so observed/null ~ 1 on isotropic corpora and >> 1 on
    clustered ones.  The shuffle is a stable argsort of uniforms drawn on
    the CPU from a generator seeded with 0 and moved to Y's device, so the
    card and the CPU shuffle alike (the JAX package draws them from
    ``PRNGKey(0)``)."""
    n, d = Y.shape
    stride = max(n // sample, 1)
    Ys = normalize_rows(Y[::stride][:sample].to(torch.float32))
    C = max(2, min(n_clusters, Ys.shape[0] // 8))
    obs = _kmeans_maxsim(Ys, C, iters, d)
    gen = torch.Generator(device="cpu").manual_seed(0)
    u = torch.rand(Ys.shape, generator=gen, dtype=torch.float32)
    perm = torch.argsort(u.to(Y.device), dim=0, stable=True)
    Ynull = normalize_rows(torch.gather(Ys, 0, perm))
    null = _kmeans_maxsim(Ynull, C, iters, d)
    return obs, null


def _sample_quality(
    Y: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor, k: int, sample: int = 256
):
    """(id_recall, sim_gap_p99) on ``sample`` strided rows against an exact
    f32 scan.  In tight-cluster corpora the exact top-k is buried among
    near-ties, where id recall misleads; the per-slot gap
    exact_topk_sims - chosen_sims does not."""
    n, d = Y.shape
    Yn = normalize_rows(Y.to(torch.float32))
    stride = max(n // sample, 1)
    rows = (torch.arange(sample, device=Y.device) * stride) % n
    S = Yn[rows] @ Yn.T  # exact f32: TF32 is off on the card
    S[torch.arange(sample, device=Y.device), rows] = -torch.inf
    ex_vals, exact = stable_topk(S, k)
    got = idx[rows].long()
    hit = (exact[:, :, None] == got[:, None, :]).any(-1)
    recall = torch.mean(hit.to(torch.float32))
    got_sorted = torch.sort(vals[rows], dim=1, descending=True).values
    gap = (ex_vals - got_sorted).reshape(-1)
    p99 = torch.quantile(gap, 0.99)
    return recall, p99


def build_graph_ivf(
    Y: torch.Tensor,
    k: int,
    *,
    row_cap: float = 1.0,
    n_clusters: int = 1024,
    m_probe: int = 8,
    bucket_factor: float = 2.0,
    kmeans_iters: int = 6,
    overscan: int = 4,
    min_n: int = 65536,
    min_recall: float = 0.9,
    max_sim_gap: float = 0.01,
    patch_cap: int = 2048,
    balance_rounds: int = 10,
    balance_cands: int = 16,
    min_clusterability: float = 1.25,
    fallback_builder: Optional[Callable[[str], Graph]] = None,
    spill_patch: bool = True,
    stats: Optional[dict] = None,
) -> tuple[Graph, dict]:
    """Clustered approximate graph build with dense-fast-scan fallback.

    Returns (Graph, info).  info["mode"] is "ivf" or "fallback-<mode>";
    the fallback runs when N < min_n or C*4 >= N, when the clusterability
    ratio is below ``min_clusterability`` (0 disables the pre-gate), when
    any row overflowed its bucket (a patched row is in no bucket, so the
    mutual test would isolate it), or when the sampled quality gate fails
    both bars (id recall < ``min_recall`` and sim-gap p99 >
    ``max_sim_gap``).  The fallback re-resolves ``"auto"`` without the
    cluster tier, and ``fallback_builder(mode)`` builds it when given.
    ``overscan`` is recorded in ``info`` as the JAX package records it; the
    port's exact top-k needs no candidate pool.  ``spill_patch`` is
    `ivf_topk`'s.  ``stats``, when given,
    gains this build's outcome: ``ivf_builds`` or ``ivf_fallbacks`` one,
    ``ivf_overflow_rows`` the rows that overflowed their bucket and
    ``ivf_patched_rows`` those the patch scan filled (`ivf_topk`)."""
    n, d = Y.shape
    fb_mode = resolve_similarity(n, "auto")

    def _count(outcome: str, ovf: int = 0) -> None:
        if stats is not None:
            for key, val in ((outcome, 1), ("ivf_overflow_rows", ovf)):
                stats[key] = stats.get(key, 0) + val

    def _fallback(reason, ovf=0, **extra):
        _count("ivf_fallbacks", ovf)
        if fallback_builder is not None:
            g = fallback_builder(fb_mode)
        else:
            g = build_graph(Y, k, row_cap=row_cap, similarity=fb_mode)
        return g, {"mode": f"fallback-{fb_mode}", "reason": reason, **extra}

    if n < min_n or n_clusters * 4 >= n:
        return _fallback("N below IVF threshold")

    obs = null = clus = None
    if min_clusterability > 0:
        with span("ivf.pregate"):
            obs, null = (float(v) for v in torch.stack(_clusterability(Y)).tolist())
        clus = obs / max(null, 1e-6)
        if clus < min_clusterability:
            return _fallback(
                f"clusterability ratio {clus:.2f} < {min_clusterability} "
                f"(sampled mean max centroid sim {obs:.3f} vs shuffled-null "
                f"{null:.3f})",
                clusterability=round(obs, 4),
                clusterability_null=round(null, 4),
                clusterability_ratio=round(clus, 3),
            )

    P = _round_up(int(bucket_factor * n / n_clusters), 128)
    vals, idx, ovf, _ = ivf_topk(
        Y, k, n_clusters=n_clusters, bucket_cap=P, m_probe=m_probe,
        kmeans_iters=kmeans_iters, patch_cap=patch_cap,
        balance_rounds=balance_rounds, balance_cands=balance_cands,
        spill_patch=spill_patch, stats=stats,
    )
    with span("ivf.quality"):
        rec, gap = (float(v) for v in torch.stack(_sample_quality(Y, vals, idx, k)).tolist())
    if ovf > 0 or (rec < min_recall and gap > max_sim_gap):
        reason = (
            f"{ovf} bucket-overflow rows would be isolated by the mutual "
            "test (patched rows are in no bucket)"
            if ovf > 0
            else f"sampled recall {rec:.3f} < {min_recall} and sim-gap p99 "
            f"{gap:.4f} > {max_sim_gap}"
        )
        return _fallback(reason, ovf, recall_estimate=rec, sim_gap_p99=gap)
    _count("ivf_builds")
    g = graph_from_topk(vals, idx, row_cap=row_cap)
    return g, {
        "mode": "ivf",
        "n_clusters": n_clusters,
        "bucket_cap": P,
        "m_probe": m_probe,
        "overscan": overscan,
        "balance_rounds": balance_rounds,
        "clusterability": round(obs, 4) if obs is not None else None,
        "clusterability_null": round(null, 4) if null is not None else None,
        "clusterability_ratio": round(clus, 3) if clus is not None else None,
        "overflow_patched": ovf,
        "recall_estimate": rec,
        "sim_gap_p99": gap,
    }
