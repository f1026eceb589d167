"""Plain reference of the coherence lattice, in PyTorch, for the benchmark's
correctness check.  It imports nothing of the program and takes nothing the
program made: it builds the graph again from the anchors and solves again.

Semantics (the lattice of the configurations, as the original oscillink
package defines it):

* Graph: rows normalised as Y / (|Y| + 1e-12); each row's k most similar
  other rows (ties to the lower index); only positive similarities; an
  edge survives when each end lists the other, with weight max(w_ij, w_ji);
  rows capped to sum ``row_cap`` by sqrt(scale_i scale_j) with scale =
  min(1, row_cap / (row sum + 1e-12)); sqrt_deg = sqrt(max(row sum,
  1e-12)); wn = w / (sqrt_deg_i sqrt_deg_j).
  ``similarity`` "exact" scans in float32; "fast" picks 4k candidates a row
  by a scan of bfloat16-rounded rows (exact products, float32 sums) and
  ranks them by their float32 similarity.  "auto" is "fast" above 65536
  rows and "exact" up to it.
* Energy: M = lamG I + lamC L + lamQ diag(B), L = I - Wn; U* solves
  M U* = lamG Y + lamQ B psi^T from U = Y; a settle step solves
  (I + dt M) U+ = U + dt (lamG Y + lamQ B psi^T) from U.  Both by
  Jacobi-preconditioned CG on the [N, D] block (diagonal lamG + lamQ B,
  and 1 + dt times it for the step), per-column step sizes, residual the
  largest column norm, at least one iteration, stop when it is at most
  ``tol`` (in float32) or after ``max_iters``.
* Receipt: dH = sum (U - U*) * M (U - U*).  Null points: on each edge
  R_ij = lamC w_ij |Un_i - Un_j|^2 with Un = U* / (sqrt_deg + 1e-12); a
  row's mean and deviation over all N columns (zeros off the edges); the
  row's largest R (first slot on ties) is flagged when R > 0 and its z
  exceeds 3.
* Bundle: score = alpha z(coh) + (1 - alpha) cos(U*, psi), coh_i =
  sum_j 0.5 lamC w_ij (|Yn_i - Yn_j|^2 - |Un_i - Un_j|^2) with Yn, Un
  divided by sqrt_deg + 1e-12, z over all rows with the population
  deviation + 1e-12; MMR picks argmax of (1 - lam) score - lam max cos(Y_i,
  Y_chosen) with lam 0.5, the first by score alone, ties to the lower index.

``precision`` "f32" is the configurations' float32 with TF32 off; "tf32"
rounds every matmul's inputs to TF32 (10 mantissa bits, to nearest) first:
the control, the next precision down.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

FAST_N = 65536
ROW_BLOCK = 2048
EDGE_BLOCK = 8192


class RefGraph(NamedTuple):
    idx: torch.Tensor  # [N, k] int64; arbitrary where w == 0
    w: torch.Tensor  # [N, k] float32
    wn: torch.Tensor
    sqrt_deg: torch.Tensor  # [N]


class Lam(NamedTuple):
    G: float = 1.0
    C: float = 0.5
    Q: float = 4.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    if precision == "tf32":
        a, b = _tf32(a), _tf32(b)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b


def normalize(Y: torch.Tensor) -> torch.Tensor:
    return Y / (torch.linalg.vector_norm(Y, dim=1, keepdim=True) + 1e-12)


def resolve_similarity(n: int, similarity: str) -> str:
    if similarity == "auto":
        return "fast" if n > FAST_N else "exact"
    if similarity not in ("exact", "fast"):
        raise ValueError(f"the reference has no similarity {similarity!r}")
    return similarity


def _top(S: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k of each row by (value desc, column asc)."""
    kc = min(S.shape[1], k + 8)
    v, i = torch.topk(S, kc, dim=1)
    i, p = torch.sort(i, dim=1)
    v = torch.gather(v, 1, p)
    v, p = torch.sort(v, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(i, 1, p)[:, :k]


def knn(Y: torch.Tensor, k: int, similarity: str, precision: str = "f32"):
    """(similarities [N, k], ids [N, k]) of each row's k nearest other rows."""
    n = Y.shape[0]
    mode = resolve_similarity(n, similarity)
    Yn = normalize(Y.float())
    Yb = Yn.to(torch.bfloat16).float() if mode == "fast" else None
    kc = min(4 * k, n - 1)
    vals = torch.empty(n, k, device=Y.device)
    ids = torch.empty(n, k, dtype=torch.int64, device=Y.device)
    for r0 in range(0, n, ROW_BLOCK):
        r1 = min(r0 + ROW_BLOCK, n)
        rows = torch.arange(r0, r1, device=Y.device)
        if mode == "exact":
            S = matmul(Yn[r0:r1], Yn.T, precision)
            S[rows - r0, rows] = -torch.inf
            vals[r0:r1], ids[r0:r1] = _top(S, k)
            continue
        S = Yb[r0:r1] @ Yb.T  # bf16 values: exact products, float32 sums
        S[rows - r0, rows] = -torch.inf
        cand = _top(S, kc)[1]
        del S
        exact = matmul(Yn[cand], Yn[r0:r1, :, None], precision)[:, :, 0]
        exact = torch.where(cand == rows[:, None], -torch.inf, exact)
        v, sel = _top(exact, k)
        vals[r0:r1], ids[r0:r1] = v, torch.gather(cand, 1, sel)
    return vals, ids


def mutual_graph(vals: torch.Tensor, ids: torch.Tensor, row_cap: float = 1.0) -> RefGraph:
    n, k = ids.shape
    w = torch.clamp_min(vals, 0.0)
    src = torch.arange(n, device=ids.device)[:, None].expand(n, k)
    keys = (src * n + ids).reshape(-1)
    order = torch.argsort(keys)
    sorted_keys = keys[order]
    back = (ids * n + src).reshape(-1)
    pos = torch.searchsorted(sorted_keys, back).clamp_max(keys.numel() - 1)
    found = sorted_keys[pos] == back
    w_back = torch.where(found, w.reshape(-1)[order[pos]], 0.0).reshape(n, k)
    w = torch.where((w > 0) & (w_back > 0), torch.maximum(w, w_back), 0.0)
    scale = torch.clamp_max(row_cap / (w.sum(dim=1) + 1e-12), 1.0)
    w = w * torch.sqrt(scale[:, None] * scale[ids])
    sqrt_deg = torch.sqrt(torch.clamp_min(w.sum(dim=1), 1e-12))
    wn = torch.where(w > 0, w / (sqrt_deg[:, None] * sqrt_deg[ids]), 0.0)
    return RefGraph(ids, w, wn, sqrt_deg)


def build_graph(Y: torch.Tensor, k: int, similarity: str, precision: str = "f32") -> RefGraph:
    k = min(k, max(1, Y.shape[0] - 1))
    return mutual_graph(*knn(Y, k, similarity, precision))


def lap(g: RefGraph, X: torch.Tensor) -> torch.Tensor:
    out = X.clone()
    for a in range(g.idx.shape[1]):
        out -= g.wn[:, a, None] * X[g.idx[:, a]]
    return out


def m_apply(g: RefGraph, lam: Lam, X: torch.Tensor, dt: float | None = None) -> torch.Tensor:
    MX = lam.G * X + lam.C * lap(g, X) + lam.Q * X  # B = 1
    return MX if dt is None else X + dt * MX


def cg(apply, b: torch.Tensor, x0: torch.Tensor, diag: float, tol: float, max_iters: int):
    """Jacobi CG with a constant diagonal; returns (x, iterations)."""
    tol32 = float(torch.tensor(tol, dtype=torch.float32))
    x = x0.clone()
    r = b - apply(x)
    z = r / (diag + 1e-12)
    p = z
    rz = (r * z).sum(dim=0)
    it = 0
    while True:
        Ap = apply(p)
        alpha = rz / ((p * Ap).sum(dim=0) + 1e-18)
        x = x + p * alpha
        r = r - Ap * alpha
        res = float(torch.linalg.vector_norm(r, dim=0).max())
        z = r / (diag + 1e-12)
        rz_new = (r * z).sum(dim=0)
        p = z + p * (rz_new / (rz + 1e-18))
        rz = rz_new
        it += 1
        if it >= max_iters or res <= tol32:
            return x, it


def rhs(Y: torch.Tensor, psi: torch.Tensor, lam: Lam) -> torch.Tensor:
    return lam.G * Y + lam.Q * psi[None, :]


def ustar(g: RefGraph, Y, psi, lam: Lam, tol: float = 1e-4, max_iters: int = 64):
    return cg(lambda X: m_apply(g, lam, X), rhs(Y, psi, lam), Y, lam.G + lam.Q, tol, max_iters)[0]


def settle(g: RefGraph, U, Y, psi, lam: Lam, dt: float = 1.0, tol: float = 1e-3,
           max_iters: int = 12):
    return cg(lambda X: m_apply(g, lam, X, dt), U + dt * rhs(Y, psi, lam), U,
              1.0 + dt * (lam.G + lam.Q), tol, max_iters)[0]


def delta_h(g: RefGraph, U, Us, lam: Lam) -> float:
    diff = U - Us
    return float((diff.double() * m_apply(g, lam, diff).double()).sum())


def _edge_sq(g: RefGraph, X: torch.Tensor) -> torch.Tensor:
    """[N, k] |X_i / s_i - X_j / s_j|^2 along the edges, s = sqrt_deg + 1e-12."""
    inv = 1.0 / (g.sqrt_deg + 1e-12)
    out = torch.empty_like(g.w)
    for r0 in range(0, X.shape[0], EDGE_BLOCK):
        sl = slice(r0, r0 + EDGE_BLOCK)
        xi = X[sl] * inv[sl, None]
        xj = X[g.idx[sl]] * inv[g.idx[sl]][:, :, None]
        out[sl] = ((xi[:, None, :] - xj) ** 2).sum(dim=-1)
    return out


def null_points(g: RefGraph, Us, lam: Lam, z_th: float = 3.0):
    """(flagged [N] bool, neighbour of the flagged edge [N])."""
    R = lam.C * g.w * _edge_sq(g, Us)
    n = R.shape[0]
    mu = R.sum(dim=1) / n
    sigma = torch.sqrt(torch.clamp_min((R * R).sum(dim=1) / n - mu * mu, 0.0)) + 1e-12
    slot = torch.argmax(R, dim=1, keepdim=True)
    r = torch.gather(R, 1, slot)[:, 0]
    flag = (r > 0) & ((r - mu) / sigma > z_th)
    return flag, torch.gather(g.idx, 1, slot)[:, 0]


def bundle_scores(g: RefGraph, Y, Us, psi, lam: Lam, alpha: float = 0.5,
                  precision: str = "f32"):
    """(score [N], align [N])."""
    psi_n = psi / (torch.linalg.vector_norm(psi) + 1e-12)
    align = matmul(normalize(Us), psi_n[:, None], precision)[:, 0]
    coh = (0.5 * lam.C * g.w * (_edge_sq(g, Y) - _edge_sq(g, Us))).sum(dim=1)
    z = (coh - coh.mean()) / (coh.std(correction=0) + 1e-12)
    return alpha * z + (1.0 - alpha) * align, align


def mmr(Yn: torch.Tensor, score: torch.Tensor, k: int, precision: str = "f32",
        lam_div: float = 0.5) -> list[int]:
    chosen: list[int] = []
    simmax = torch.full_like(score, -torch.inf)
    for t in range(min(k, score.numel())):
        val = mmr_values(score, simmax if t else torch.zeros_like(score), chosen, lam_div)
        pick = int(torch.argmax(val))
        chosen.append(pick)
        simmax = torch.maximum(simmax, matmul(Yn, Yn[pick, :, None], precision)[:, 0])
    return chosen


def mmr_values(score, div, chosen: list[int], lam_div: float = 0.5) -> torch.Tensor:
    val = (1.0 - lam_div) * score - lam_div * div
    if chosen:
        val[torch.tensor(chosen, device=score.device)] = -torch.inf
    return val


def mmr_gaps(Yn: torch.Tensor, score: torch.Tensor, picks: list[int], precision: str = "f32",
             lam_div: float = 0.5) -> list[float]:
    """For each served pick, how far its MMR value lies below the best
    value the reference finds at that step, given the picks before it;
    infinite for an id out of range or picked twice."""
    n = score.numel()
    gaps, chosen = [], []
    simmax = torch.full_like(score, -torch.inf)
    for t, pick in enumerate(picks):
        if not 0 <= pick < n or pick in chosen:
            gaps.append(float("inf"))
            break
        val = mmr_values(score, simmax if t else torch.zeros_like(score), chosen, lam_div)
        gaps.append(float(val.max() - val[pick]))
        chosen.append(pick)
        simmax = torch.maximum(simmax, matmul(Yn, Yn[pick, :, None], precision)[:, 0])
    return gaps
