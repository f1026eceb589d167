"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (`reference.py`) worked out again from the
same inputs.

Each function returns {number name: value}; the cell's
``checks/<workload>.json`` gives each number its limit.  The numbers:

* ``graph_rows_differ`` — share of rows whose set of neighbours (slots of
  positive weight) differs from the reference's graph;
* ``graph_w_err`` — largest |w - w_ref| on the rows whose sets agree;
* ``settle_rel_err`` — |U - U_ref|_F / |U_ref|_F of the settled U, the
  reference carrying its own U through every query the run called, in
  order, from U = Y;
* ``ustar_rel_err`` — the same for U*;
* ``dh_rel_err`` — |dH - dH_ref| / |dH_ref| of the receipt's deltaH_total;
* ``nulls_differ`` — share of rows whose null point (flagged, and the
  neighbour of the flagged edge) differs;
* ``bundle_gap`` — largest amount by which a served pick's MMR value lies
  below the best value the reference finds at that step, given the
  served picks before it (infinite for a missing, repeated or unknown id);
* ``bundle_score_err`` — largest |score - score_ref| at a served id.

Each is the worst over the queries checked.
"""

from __future__ import annotations

import math

import torch

from . import reference as ref


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.to(b.device).double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def graph_numbers(idx: torch.Tensor, w: torch.Tensor, g: ref.RefGraph) -> dict:
    n = g.idx.shape[0]
    idx, w = idx.to(g.idx.device).long(), w.to(g.idx.device).float()

    def canon(i, wt):
        i = torch.where(wt > 0, i, n)
        i, p = torch.sort(i, dim=1)
        return i, torch.gather(wt, 1, p)

    pi, pw = canon(idx, w)
    ri, rw = canon(g.idx, g.w)
    same = (pi == ri).all(dim=1)
    err = (pw - rw).abs()[same]
    return {"graph_rows_differ": float(1.0 - same.double().mean()),
            "graph_w_err": float(err.max()) if err.numel() else 0.0}


def bundle_numbers(bundle: list, k: int, Yn: torch.Tensor, score: torch.Tensor,
                   precision: str = "f32") -> dict:
    picks = [int(b["id"]) for b in bundle]
    gaps = ref.mmr_gaps(Yn, score, picks, precision)
    gap = max(gaps) if len(picks) == min(k, score.numel()) else math.inf
    if math.isinf(gap):
        return {"bundle_gap": math.inf, "bundle_score_err": math.inf}
    served = torch.tensor([float(b["score"]) for b in bundle], device=score.device)
    at = score[torch.tensor(picks, device=score.device)]
    return {"bundle_gap": gap, "bundle_score_err": float((served - at).abs().max())}


def null_numbers(null_points: list, flag: torch.Tensor, j: torch.Tensor) -> dict:
    n = flag.numel()
    pf = torch.zeros(n, dtype=torch.bool)
    pj = torch.full((n,), -1, dtype=torch.int64)
    if null_points:
        e = torch.tensor([p["edge"] for p in null_points], dtype=torch.int64)
        pf[e[:, 0]] = True
        pj[e[:, 0]] = e[:, 1]
    flag, j = flag.cpu(), j.cpu()
    differ = (pf != flag) | (pf & flag & (pj != j))
    return {"nulls_differ": float(differ.double().mean())}


def worst(acc: dict, new: dict) -> None:
    for key, val in new.items():
        acc[key] = max(acc.get(key, -math.inf), val)


def lattice_checks(Y: torch.Tensor, cfg: dict, traffic: dict, outputs: dict) -> dict:
    """The numbers of a lattice cell.  ``outputs``: the program's graph
    (idx, w); where the queries settle, ``chain``, every query's psi in the
    order the run called them; and, per query checked, its ``psi``,
    ``bundle``, ``ustar`` and, where it settles, ``at`` (its place in the
    chain), ``u_settled`` and ``receipt``."""
    lam = ref.Lam(*cfg["lam"])
    g = ref.build_graph(Y, cfg["kneighbors"], cfg["similarity"])
    out = graph_numbers(*outputs["graph"], g)
    Yn = ref.normalize(Y)
    steps = dict(traffic["steps"])
    settled = {}
    if "settle" in steps:  # the reference's own U, carried through the whole run
        wanted = {q["at"] for q in outputs["queries"]}
        U = Y
        for at, psi in enumerate(outputs["chain"][: max(wanted, default=-1) + 1]):
            U = ref.settle(g, U, Y, torch.as_tensor(psi, device=Y.device), lam, **steps["settle"])
            if at in wanted:
                settled[at] = U
    for q in outputs["queries"]:
        psi = torch.as_tensor(q["psi"], device=Y.device)
        Us = ref.ustar(g, Y, psi, lam)
        worst(out, {"ustar_rel_err": rel_err(q["ustar"], Us)})
        U = settled[q["at"]] if "settle" in steps else Y  # unsettled, U stays Y
        if "settle" in steps:
            worst(out, {"settle_rel_err": rel_err(q["u_settled"], U)})
        if "receipt" in steps:
            dh = ref.delta_h(g, U, Us, lam)
            worst(out, {"dh_rel_err": abs(q["receipt"]["deltaH_total"] - dh) / abs(dh)})
            worst(out, null_numbers(q["receipt"]["null_points"], *ref.null_points(g, Us, lam)))
        score, _ = ref.bundle_scores(g, Y, Us, psi, lam, steps["bundle"].get("alpha", 0.5))
        worst(out, bundle_numbers(q["bundle"], steps["bundle"]["k"], Yn, score))
    return out


def service_checks(Y: torch.Tensor, cfg: dict, requests: list) -> dict:
    """The numbers of a service cell: per request, its candidate rows of the
    corpus Y (``rows``), ``psi`` and the response's ``bundle``."""
    lam = ref.Lam(*cfg["lam"])
    k = cfg["request"]["bundle_k"]
    out: dict = {}
    for q in requests:
        Yc = Y[q["rows"].to(Y.device)]
        psi = torch.as_tensor(q["psi"], device=Y.device)
        g = ref.build_graph(Yc, cfg["kneighbors"], cfg["similarity"])
        Us = ref.ustar(g, Yc, psi, lam)
        score, _ = ref.bundle_scores(g, Yc, Us, psi, lam)
        worst(out, bundle_numbers(q["bundle"], k, ref.normalize(Yc), score))
    return out
