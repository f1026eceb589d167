"""The comparison that decides ``correct`` in the service cell of the
largest requests (``systems/service_spans.py``): each request's graph, as
the program built it, against the exact mutual-kNN graph up to ties that
float32 cannot resolve, and its bundle against the plain reference solved
on that graph's edges.

Why not `compare.service_checks`, which rebuilds the graph itself: at
1000-5000 rows some row's k-th and (k+1)-th similarities lie closer than
float32 resolves (1.7e-8 apart in one 2473-row set), and the reference's
2048-row product blocks and the program's [N, N] product round them
apart.  The two graphs then differ by one edge, which moves the bundle's
scores near it by up to 0.13: as far as TF32 matmul inputs move them.  So
the graph is judged by itself, and the algebra on the program's own edges
(as `compare_ivf.py` does for the approximate IVF graph).

A request's graph is its slots of positive weight (``idx``, ``w``).  With
s the float64 cosine of a pair, t_i row i's k-th largest s over the other
rows and u_i its (k+1)-th, and ``TIE`` the band of float32 error
(`TIE_BAND`):

* an edge (i, j) is surely wrong when s <= t_i - TIE, s <= t_j - TIE or
  s <= -TIE (j is not among i's k nearest, i not among j's, or the cosine
  is not positive, whatever float32 rounding did);
* an edge is surely due when s >= u_i + TIE, s >= u_j + TIE and s >= TIE.

The numbers:

* ``graph_edges_wrong`` — (the program's surely wrong edges + the surely
  due edges it lacks) over the program's edges;
* ``graph_not_mutual`` — share of the program's edges (i, j) without the
  edge (j, i);
* ``graph_w_err`` — largest |w - w_ref| over the program's edges, w_ref
  the reference's float32 weights on the same edges
  (`reference_ivf.graph_on_edges`);
* ``bundle_gap``, ``bundle_score_err`` — as `compare.py` defines them,
  against the reference solved on those weights.

The plain reference standing in for the program (`control.py`) hands
over the graph it built as the port does (`service_spans._graph_catch`).
Each number is the worst over the requests checked.
"""

from __future__ import annotations

import torch

from . import compare, compare_ivf
from . import reference as ref
from . import reference_ivf

# Twice, with room to spare, how far float32 cosines of unit rows of 768
# columns may stray from their float64 values: a sum of 768 products rounds
# by ~1e-7 (PERF.md section 2 gives the card's reading).  TF32 inputs move
# them by ~1e-5 to 4e-5, so a TF32 graph still misplaces edges outside it.
TIE_BAND = 1e-5


def tie_band_numbers(Y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, k: int,
                     tie: float = TIE_BAND) -> dict:
    """``graph_edges_wrong`` of the graph (idx, w) on the rows Y."""
    n = Y.shape[0]
    k = min(k, max(1, n - 1))
    dev = Y.device
    Yn = ref.normalize(Y.double())
    S = Yn @ Yn.T
    S.fill_diagonal_(-torch.inf)
    top_v, top_i = torch.topk(S, min(k + 1, n - 1), dim=1)
    t = top_v[:, k - 1]
    u = top_v[:, k] if k < n - 1 else torch.full_like(t, -torch.inf)
    keys, _ = compare_ivf.edge_keys(idx.to(dev), w.to(dev))
    i, j = keys // n, keys % n
    s = S[i, j]
    wrong = (s <= t[i] - tie) | (s <= t[j] - tie) | (s <= -tie)
    rows = torch.arange(n, device=dev)[:, None].expand(n, k)
    di, dj = rows.reshape(-1), top_i[:, :k].reshape(-1)
    ds = S[di, dj]
    due = (ds >= u[di] + tie) & (ds >= u[dj] + tie) & (ds >= tie)
    lacking = due & ~torch.isin(di * n + dj, keys)
    bad = int(wrong.sum()) + int(lacking.sum())
    return {"graph_edges_wrong": bad / max(1, keys.numel())}


def service_checks(Y: torch.Tensor, cfg: dict, requests: list) -> dict:
    """The numbers of the cell: per request, its candidate rows of the
    corpus Y (``rows``), ``psi``, the response's ``bundle`` and the
    program's ``graph`` (idx, w)."""
    lam = ref.Lam(*cfg["lam"])
    k = cfg["request"]["bundle_k"]
    out: dict = {}
    for q in requests:
        Yc = Y[q["rows"].to(Y.device)]
        psi = torch.as_tensor(q["psi"], device=Y.device)
        idx, w = (t.to(Y.device) for t in q["graph"])
        g = reference_ivf.graph_on_edges(Yc, idx, w)
        mine = compare_ivf.graph_numbers(idx, w, None, g, g)
        compare.worst(out, {key: mine[key] for key in ("graph_not_mutual", "graph_w_err")})
        compare.worst(out, tie_band_numbers(Yc, idx, w, cfg["kneighbors"]))
        Us = ref.ustar(g, Yc, psi, lam)
        score, _ = ref.bundle_scores(g, Yc, Us, psi, lam)
        compare.worst(out, compare.bundle_numbers(q["bundle"], k, ref.normalize(Yc), score))
    return out
