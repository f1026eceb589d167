"""The comparison that decides ``correct`` in a cell whose graph is
approximate (the cluster tier's IVF build): what the timed path produced,
against the plain reference of `reference_ivf.py`, (a) the exact mutual
graph and (b) the reference's graph on the program's edge set.

Each function returns {number name: value}; the cell's
``checks/<workload>.json`` gives each number its limit.  An edge is a slot
(i, j) of positive weight.  The numbers:

* ``graph_fallback`` — 1 unless the build's ``similarity_info["mode"]``
  is "ivf": the cell measures the IVF build, not its fallback;
* ``graph_not_mutual`` — share of the program's edges (i, j) without the
  edge (j, i);
* ``graph_w_err`` — largest |w - w_ref| over the program's edges, w_ref of
  (b);
* ``graph_edges_missed`` — share of (a)'s edges absent from the program's
  graph;
* ``graph_edges_extra`` — share of the program's edges absent from (a);
* ``ustar_rel_err``, ``bundle_gap``, ``bundle_score_err`` — as `compare.py`
  defines them, against the reference solved on (b).

Each per-query number is the worst over the queries checked.
"""

from __future__ import annotations

import torch

from . import compare
from . import reference as ref
from . import reference_ivf

CHECKED_STEPS = {"set_query", "bundle"}


def edge_keys(idx: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(i * N + j, j * N + i) of every edge (i, j)."""
    n = idx.shape[0]
    rows = torch.arange(n, device=idx.device)[:, None].expand_as(idx)
    edge = w > 0
    i, j = rows[edge], idx.long()[edge]
    return i * n + j, j * n + i


def _share(absent: torch.Tensor) -> float:
    return float(absent.double().mean()) if absent.numel() else 0.0


def graph_numbers(idx: torch.Tensor, w: torch.Tensor, info, exact: ref.RefGraph,
                  on_edges: ref.RefGraph) -> dict:
    """The graph numbers of the program's graph (idx, w), from a build that
    reported ``info``, against (a) ``exact`` and (b) ``on_edges``."""
    dev = exact.idx.device
    idx, w = idx.to(dev).long(), w.to(dev).float()
    keys, back = edge_keys(idx, w)
    exact_keys, _ = edge_keys(exact.idx, exact.w)
    edge = w > 0
    err = (w - on_edges.w)[edge].abs()
    return {
        "graph_fallback": 0.0 if (info or {}).get("mode") == "ivf" else 1.0,
        "graph_not_mutual": _share(~torch.isin(back, keys)),
        "graph_w_err": float(err.max()) if err.numel() else 0.0,
        "graph_edges_missed": _share(~torch.isin(exact_keys, keys)),
        "graph_edges_extra": _share(~torch.isin(keys, exact_keys)),
    }


def query_numbers(Y: torch.Tensor, g: ref.RefGraph, cfg: dict, traffic: dict,
                  queries: list) -> dict:
    """U* and the bundle of each query checked (its ``psi``, ``bundle`` and
    ``ustar``) against the reference solved on ``g``, (b)."""
    steps = dict(traffic["steps"])
    if set(steps) - CHECKED_STEPS:
        raise ValueError(f"compare_ivf checks {sorted(CHECKED_STEPS)}, not {sorted(steps)}")
    lam = ref.Lam(*cfg["lam"])
    Yn = ref.normalize(Y)
    out: dict = {}
    for q in queries:
        psi = torch.as_tensor(q["psi"], device=Y.device)
        Us = ref.ustar(g, Y, psi, lam)
        compare.worst(out, {"ustar_rel_err": compare.rel_err(q["ustar"], Us)})
        score, _ = ref.bundle_scores(g, Y, Us, psi, lam, steps["bundle"].get("alpha", 0.5))
        compare.worst(out, compare.bundle_numbers(q["bundle"], steps["bundle"]["k"], Yn, score))
    return out


def lattice_ivf_checks(Y: torch.Tensor, cfg: dict, traffic: dict, outputs: dict) -> dict:
    """The numbers of a lattice cell with an approximate graph.  ``outputs``:
    the program's graph (idx, w), its build's ``info`` (``similarity_info``)
    and, per query checked, its ``psi``, ``bundle`` and ``ustar``."""
    idx, w = outputs["graph"]
    exact = reference_ivf.exact_graph(Y, cfg["kneighbors"])
    g = reference_ivf.graph_on_edges(Y, idx, w, cfg["row_cap"])
    out = graph_numbers(idx, w, outputs["info"], exact, g)
    del exact
    return {**out, **query_numbers(Y, g, cfg, traffic, outputs["queries"])}
