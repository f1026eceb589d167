"""Calibration sweep for the windowed tier's routing constants, on the card.

The JAX package routes ``OSCILLINK_WINDOWED_MATVEC=auto`` by three constants
set on a TPU: ``OSCILLINK_WINDOWED_MIN_N``, ``OSCILLINK_WINDOWED_MIN_COVERAGE``
and ``OSCILLINK_WINDOWED_LOWCOV_SMAX``.  This sweep reads the port's own
values from whole flows on the card.  Each case runs a user's flow on one
corpus, the windowed route (``OSCILLINK_WINDOWED_MATVEC=1``: kernel K4 in
settle and U*) and the gather route (``=0``: kernel K1) in turns in one
process:

    Oscillink(Y, kneighbors=8)          graph; under windowed the locality
                                        order and plan (``window_ctx_ms``)
    set_query(psi)
    settle(dt=1.0, max_iters=12, tol=1e-3)
    U* (the receipt's solve, timed alone), then receipt()

each phase timed on the host clock to a ``torch.cuda.synchronize()``.  A
route's flow time is the median of ``--passes`` warm passes (one untimed
pass first), its spread max − min.  A route **wins** a case when its median
is lower by more than the larger of the two spreads; otherwise the case is a
tie, and a tie goes to the gather route (it builds no context).

Sweeps (``--sweep``, all by default), at 768 × k8:

* ``min_n``: the locality corpus (coverage about 1.0) at N = 8192 … 262144.
  MIN_N is the smallest N from which the windowed flow wins at every larger
  N measured.
* ``ladder``: 131072 rows, coverage from 1.0 down: the locality corpus with
  a share p of its rows redrawn isotropic (``mixed_corpus``), the
  64-centre clustered corpus and the Gaussian corpus.  Each corpus takes the
  plan that ``=1`` gives with ``OSCILLINK_WINDOWED_LOWCOV_SMAX`` at the
  straggler window the plan needs (`needed_s_max`).  MIN_COVERAGE is the
  lowest coverage at which windowed still wins at s_max 384; LOWCOV_SMAX the
  largest straggler window at which it still wins (0 where it never does).
* ``halo``: the same ladder on 4 shards of one card through the halo tier:
  `halo_solve_windowed` (the shard window plans' build included) against
  `halo_solve`, after the tier choice `solve_auto` makes (a corpus whose halo
  sends it to the all-gather tier has no windowed decision).
* ``auto`` (not in the default set): `solve_auto` on the same ladder on 4
  shards under the environment in force, the whole call a user makes, timed
  with the tier it took.  Run from two checkouts, it compares their default
  paths; ``--summarize`` prints each file's medians and halo-tier sums.

Each bar is read as MIN_N is: it holds only where windowed wins every rung
past it (`derive`), so one win among ties and losses sets nothing.

    python3 -m oscillink_tpu_torch.benchmarks.window_routing [--sweep min_n,ladder,halo]
        [--passes 3] [--out window_routing.jsonl]
    python3 -m oscillink_tpu_torch.benchmarks.window_routing \
        --derive oscillink_tpu_torch/benchmarks/window_routing_h100.jsonl

prints one JSON line a case and a last line with the constants the rule
gives, and appends every line to ``--out``; ``--derive`` prints the
constants an earlier run's file gives (``window_routing_h100.jsonl`` holds
the readings the port's defaults rest on).  It runs on ``cuda`` and raises
without it; ``--device cpu --small`` rehearses the control flow at toy sizes
(its times say nothing of the card).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from ..core.lattice import OscillinkLattice as Oscillink, _locality_order
from ..ops.kernels import window_spmv as tw

MIN_N_SIZES = (8192, 16384, 32768, 65536, 131072, 262144)
LADDER_N = 131072
MIXED_SHARES = (0.0, 0.02, 0.05, 0.1, 0.2, 0.5)
D, K = 768, 8
SHARDS = 4
SMALL = dict(min_n=(1536, 3072), ladder_n=3072, d=64, shares=(0.0, 0.2))


# -- corpora -------------------------------------------------------------------


def locality_corpus(n: int, d: int, clusters: int = 2048, seed: int = 0):
    """A locality-ordered corpus: ``clusters`` clusters of n/clusters rows, each
    at 10 s along e0 (s evenly spaced in [-1, 1]) plus a random offset of norm
    about 1 orthogonal to e0, with 0.05/sqrt(D) noise per dimension; rows
    shuffled.  psi is the normalized mean of the first 32 rows."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((clusters, d), dtype=np.float32) / np.float32(np.sqrt(d))
    centres[:, 0] = 10.0 * np.linspace(-1.0, 1.0, clusters, dtype=np.float32)
    Y = np.repeat(centres, n // clusters, axis=0)
    Y += np.float32(0.05 / np.sqrt(d)) * rng.standard_normal(Y.shape, dtype=np.float32)
    Y = Y[np.random.default_rng(seed).permutation(n)]
    return Y, _psi(Y, 32)


def mixed_corpus(n: int, d: int, share: float, seed: int = 0):
    """`locality_corpus` with ``round(share·n)`` of its rows, drawn at random,
    redrawn isotropic (standard normal): the redrawn rows' neighbours scatter
    across the locality order, so coverage falls and straggler windows grow
    with ``share``.  psi as the locality corpus's, from the new rows."""
    Y, _ = locality_corpus(n, d, clusters=min(2048, n // 8), seed=seed)
    rng = np.random.default_rng(seed + 1)
    rows = rng.choice(n, size=int(round(share * n)), replace=False)
    Y[rows] = rng.standard_normal((rows.size, d), dtype=np.float32)
    return Y, _psi(Y, 32)


def clustered_corpus(n: int, d: int, seed: int = 0):
    """The JAX package's "real clustered" corpus
    (benchmarks/probe_e2e_settle_dma16.py): 64 Gaussian centres, noise 0.35.
    psi is the normalized mean of the first 64 rows."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32)
    assign = rng.integers(0, 64, size=n)
    Y = (centers[assign] + 0.35 * rng.standard_normal((n, d))).astype(np.float32)
    return Y, _psi(Y, 64)


def gaussian_corpus(n: int, d: int, seed: int = 0):
    """bench.py's inputs: Gaussian anchors, psi = normalized mean of 32 rows."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d), dtype=np.float32)
    return Y, _psi(Y, 32)


def _psi(Y: np.ndarray, rows: int) -> np.ndarray:
    m = Y[:rows].mean(axis=0)
    return (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


# -- one flow, one route ------------------------------------------------------------


@contextlib.contextmanager
def env(**values):
    """Set environment variables for the block (None unsets one), then
    restore them."""
    saved = {key: os.environ.get(key) for key in values}
    for key, val in values.items():
        if val is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = val
    try:
        yield
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def flow(Y, psi, device: torch.device) -> dict:
    """One pass of the flow under the environment in force: phase ms, the
    window context's build ms inside the lattice's, iterations, ΔH, bundle
    ids, the context's decision and peak memory."""
    ctx_ms = []
    build_ctx = Oscillink._maybe_build_window_ctx

    def timed_ctx(lat):
        t0 = time.perf_counter()
        build_ctx(lat)
        _sync(device)
        ctx_ms.append(1000.0 * (time.perf_counter() - t0))

    t = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    Oscillink._maybe_build_window_ctx = timed_ctx
    try:
        t0 = time.perf_counter()
        lat = Oscillink(Y, kneighbors=K, device=device)
        lat.set_query(psi)
        _sync(device)
        t["build_ms"] = 1000.0 * (time.perf_counter() - t0)
    finally:
        Oscillink._maybe_build_window_ctx = build_ctx
    t0 = time.perf_counter()
    st = lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    _sync(device)
    t["settle_ms"] = 1000.0 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    lat._solve_ustar_device()  # receipt() then takes U* from the cache
    _sync(device)
    t["ustar_ms"] = 1000.0 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    rec = lat.receipt()
    _sync(device)
    t["receipt_ms"] = 1000.0 * (time.perf_counter() - t0)
    t["flow_ms"] = t["build_ms"] + t["settle_ms"] + t["ustar_ms"] + t["receipt_ms"]
    t["window_ctx_ms"] = ctx_ms[0] if ctx_ms else 0.0
    ctx = lat._window_ctx
    return {
        **t,
        "settle_iters": int(st["iters"]),
        "ustar_iters": int(rec["meta"]["ustar_iters"]),
        "deltaH": float(rec["deltaH_total"]),
        "bundle": [b["id"] for b in lat.bundle(k=8)],
        "windowed": ctx is not None,
        "coverage": lat._window_coverage,
        "s_max": None if ctx is None else ctx.s_max,
        "stragglers": None if ctx is None else int(torch.count_nonzero(ctx.plan.strag_w)),
        "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
    }


def needed_s_max(Y: np.ndarray, device: torch.device) -> tuple[int, float]:
    """The straggler window the lattice's plan needs on this corpus (the
    largest per-block straggler segment, rounded up to 128) and its coverage:
    the plan built with a straggler cap and window that cannot overflow."""
    lat = Oscillink(Y, kneighbors=K, device=device)
    g = lat.graph
    order, _ = _locality_order(lat._Y_dev)
    n = Y.shape[0]
    cap = ((n * K + 8 * (-(-n // 384)) + 4096 + 127) // 128) * 128
    plan, cov, _, fits = tw.build_window_plan_device(g.idx, g.wn, order, 384, 384, cap,
                                                     384 * K + 8, 3)
    assert bool(fits)
    return tw.plan_s_max(plan), float(cov)


def verdict(win: dict, gat: dict) -> str:
    """The rule: a route wins when its median flow is lower by more than the
    larger spread; else a tie (which routes gather)."""
    margin = max(win["flow_spread_ms"], gat["flow_spread_ms"])
    if win["flow_ms"] < gat["flow_ms"] - margin:
        return "windowed"
    if gat["flow_ms"] < win["flow_ms"] - margin:
        return "gather"
    return "tie"


def summarize(passes: list[dict]) -> dict:
    keys = ("flow_ms", "build_ms", "window_ctx_ms", "settle_ms", "ustar_ms", "receipt_ms")
    out = {key: statistics.median(p[key] for p in passes) for key in keys}
    out["flow_spread_ms"] = max(p["flow_ms"] for p in passes) - min(p["flow_ms"] for p in passes)
    out["flow_passes_ms"] = [p["flow_ms"] for p in passes]
    last = passes[-1]
    out.update({key: last[key] for key in ("settle_iters", "ustar_iters", "deltaH", "windowed",
                                           "coverage", "s_max", "stragglers", "peak_bytes")})
    return out


def compare(tag: str, Y, psi, device: torch.device, passes: int, **fields) -> dict:
    """Both routes on one corpus in turns (windowed, gather; one untimed pass
    each first) and the rule's verdict."""
    s_max, cov = needed_s_max(Y, device)
    # the retry's window is the bound rounded up to 128, taken only above 384
    bound = str(max(s_max, 512))
    runs = {"windowed": [], "gather": []}
    modes = {"windowed": dict(OSCILLINK_WINDOWED_MATVEC="1",
                              OSCILLINK_WINDOWED_LOWCOV_SMAX=bound),
             "gather": dict(OSCILLINK_WINDOWED_MATVEC="0")}
    for i in range(passes + 1):
        for route, values in modes.items():
            with env(**values):
                run = flow(Y, psi, device)
            if i:
                runs[route].append(run)
    win, gat = summarize(runs["windowed"]), summarize(runs["gather"])
    assert win["windowed"] and not gat["windowed"], "a route did not take its tier"
    rel = abs(win["deltaH"] - gat["deltaH"]) / max(abs(gat["deltaH"]), 1e-30)
    bundle_equal = runs["windowed"][-1]["bundle"] == runs["gather"][-1]["bundle"]
    return {"case": tag, "n": Y.shape[0], "d": Y.shape[1], "k": K, **fields,
            "needed_s_max": s_max, "plan_coverage": cov, "windowed": win, "gather": gat,
            "deltaH_rel": rel, "bundle_equal": bundle_equal,
            "verdict": verdict(win, gat)}


# -- the halo tier -----------------------------------------------------------------


def halo_compare(tag: str, Y, psi, device: torch.device, passes: int, shards: int) -> dict:
    """The halo tier on ``shards`` shards of one device: the tier `solve_auto`
    picks from the halo, then (halo tier only) `halo_solve_windowed`, with
    the shard window plans' build, against `halo_solve`, in turns."""
    from ..models.coherence import EnergyParams
    from ..parallel import halo_cg, reorder, sharded_build
    from ..parallel.mesh import lattice_mesh

    mesh = lattice_mesh(devices=[device] * shards)
    n = Y.shape[0]
    order = reorder.pca_bisection_order(Y, levels=4, device=device)
    (Ys,) = reorder.apply_order(order, Y)[:1]
    g = sharded_build.build_graph_sharded(mesh, Ys, K)
    idx_h, w_h = g.idx.cpu().numpy(), g.w.cpu().numpy()
    stats = reorder.halo_stats(idx_h, w_h, shards)
    out = {"case": tag, "n": n, "d": Y.shape[1], "k": K, "shards": shards,
           "halo_mean": stats["halo_mean"], "allgather_rows": stats["allgather_rows"]}
    if not stats["halo_mean"] < 0.5 * stats["allgather_rows"]:
        return {**out, "tier": "all-gather", "verdict": None}
    plan = halo_cg.build_halo_plan(idx_h, w_h, shards)
    wn_h = g.wn.cpu().numpy()
    lam = EnergyParams.make(1.0, 0.5, 4.0, 0.0, device=device)
    B = np.ones(n, np.float32)

    def windowed():
        t0 = time.perf_counter()
        wplan, woh, cov, s_max = halo_cg.build_shard_window_plans(plan, wn_h, shards, mesh=mesh)
        _sync(device)
        plan_ms = 1000.0 * (time.perf_counter() - t0)
        _, it, _ = halo_cg.halo_solve_windowed(mesh, g, plan, wplan, woh, Ys, psi, B, lam,
                                               tol=1e-4, max_iters=64, s_max=s_max)
        _sync(device)
        return {"flow_ms": 1000.0 * (time.perf_counter() - t0), "plan_ms": plan_ms,
                "iters": int(it), "coverage": cov, "s_max": s_max}

    def gather():
        t0 = time.perf_counter()
        _, it, _ = halo_cg.halo_solve(mesh, g, plan, Ys, psi, B, lam, tol=1e-4, max_iters=64)
        _sync(device)
        return {"flow_ms": 1000.0 * (time.perf_counter() - t0), "iters": int(it)}

    runs = {"windowed": [], "gather": []}
    for i in range(passes + 1):
        for route, fn in (("windowed", windowed), ("gather", gather)):
            with env(OSCILLINK_WINDOWED_MATVEC="1" if route == "windowed" else "0"):
                run = fn()
            if i:
                runs[route].append(run)
    res = {}
    for route, rs in runs.items():
        ms = [r["flow_ms"] for r in rs]
        res[route] = {**rs[-1], "flow_ms": statistics.median(ms),
                      "flow_spread_ms": max(ms) - min(ms), "flow_passes_ms": ms}
    return {**out, "tier": "halo-exchange", "r_max": plan.r_max,
            "rows_per": plan.rows_per, "windowed": res["windowed"], "gather": res["gather"],
            "verdict": verdict(res["windowed"], res["gather"])}


def auto_time(tag: str, Y, psi, device: torch.device, passes: int, shards: int) -> dict:
    """`solve_auto` as a user calls it, under the environment in force (the
    package's defaults unless set), on ``shards`` shards of one device: the
    whole call (reorder, sharded build, halo and shard plans, solve) timed
    to a sync, median of ``passes`` after one untimed call, its spread, the
    stage medians, and the tier it took and why."""
    from ..parallel import halo_cg
    from ..parallel.mesh import lattice_mesh

    mesh = lattice_mesh(devices=[device] * shards)
    runs = []
    for i in range(passes + 1):
        _sync(device)
        t0 = time.perf_counter()
        _, info = halo_cg.solve_auto(mesh, Y, psi, k=K)
        _sync(device)
        if i:
            runs.append((1000.0 * (time.perf_counter() - t0), info))
    ms = [r[0] for r in runs]
    info = runs[-1][1]
    stages = {key: statistics.median(r[1]["stage_ms"][key] for r in runs)
              for key in info["stage_ms"]}
    return {"sweep": "auto", "case": tag, "n": Y.shape[0], "d": Y.shape[1], "k": K,
            "shards": shards, "tier": info["tier"],
            "window_skipped": info.get("window_skipped"),
            "window_coverage": info.get("window_coverage"), "iters": info["iters"],
            "ms": statistics.median(ms), "spread_ms": max(ms) - min(ms), "passes_ms": ms,
            "stage_ms": stages}


# -- the constants the rule gives ------------------------------------------------------


def derive(min_n_rows: list, ladder_rows: list) -> dict:
    """The constants the readings give, each read as MIN_N is: from a bar
    on, windowed must win every rung, so a single win between ties and
    losses sets nothing.  MIN_N: the smallest swept N from which windowed
    wins at every larger N (None where it does not win at the largest).
    MIN_COVERAGE: the lowest coverage at s_max 384 from which windowed wins
    at every rung of that coverage or higher (None where it does not win at
    the highest).  LOWCOV_SMAX: the largest straggler window s such that
    windowed wins at every rung below that bar (every rung where there is
    none) whose straggler window is at most s: the plans the
    bounded-straggler rule would accept (0 where it loses or ties at the
    smallest)."""

    def bar(rows: list, key, descending: bool):
        # the last value v, walking from the most favourable end, such that
        # windowed wins every row from that end up to v
        out = None
        for v in sorted({key(r) for r in rows}, reverse=descending):
            past = [r for r in rows if (key(r) >= v if descending else key(r) <= v)]
            if any(r["verdict"] != "windowed" for r in past):
                break
            out = v
        return out

    min_n = bar(min_n_rows, lambda r: r["n"], True)
    min_cov = bar([r for r in ladder_rows if r["windowed"]["s_max"] == 384],
                  lambda r: r["windowed"]["coverage"], True)
    below = [r for r in ladder_rows if min_cov is None or r["windowed"]["coverage"] < min_cov]
    lowcov = bar(below, lambda r: r["windowed"]["s_max"], False)
    return {
        "min_n": min_n,
        "min_coverage": min_cov,
        "lowcov_smax": lowcov or 0,
        "rule": "a route wins when its median flow is lower by more than the larger spread; "
                "a tie routes gather; a bar holds only where windowed wins every rung past it",
    }


def read_rows(path: str) -> tuple[list, list]:
    """The ``min_n`` and ``ladder`` rows of an earlier run's ``--out`` file."""
    min_n_rows, ladder_rows = [], []
    with open(path) as fh:
        for line in fh:
            row = json.loads(line)
            if row.get("sweep") == "min_n":
                min_n_rows.append(row)
            elif row.get("sweep") == "ladder":
                ladder_rows.append(row)
    return min_n_rows, ladder_rows


def summarize_auto(paths: list) -> list:
    """For each ``--sweep auto`` file: each case's call and plan-stage
    medians, and their sums over the cases that took a halo tier (the
    tiers where the windowed decision is made)."""
    out = []
    for path in paths:
        with open(path) as fh:
            rows = [r for r in map(json.loads, fh) if r.get("sweep") == "auto"]
        halo = [r for r in rows if r["tier"].startswith("halo")]
        out.append({"file": path,
                    "cases": {r["case"]: {"ms": r["ms"], "spread_ms": r["spread_ms"],
                                          "plan_ms": r["stage_ms"].get("plan"),
                                          "tier": r["tier"],
                                          "window_skipped": r["window_skipped"]}
                              for r in rows},
                    "halo_ms_sum": sum(r["ms"] for r in halo),
                    "halo_plan_ms_sum": sum(r["stage_ms"]["plan"] for r in halo)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", default="min_n,ladder,halo")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="toy sizes, to rehearse the flow")
    ap.add_argument("--out", default="")
    ap.add_argument("--derive", default="", metavar="JSONL",
                    help="print the constants an earlier run's --out file gives, and exit "
                         "(no device needed)")
    ap.add_argument("--summarize", nargs="+", default=[], metavar="JSONL",
                    help="print each --sweep auto file's medians and halo-tier sums, and exit")
    args = ap.parse_args(argv)
    if args.derive:
        print(json.dumps({"derived": derive(*read_rows(args.derive)), "from": args.derive}))
        return 0
    if args.summarize:
        for row in summarize_auto(args.summarize):
            print(json.dumps(row))
        return 0
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("window_routing: CUDA was requested but is not available")
    sweeps = set(args.sweep.split(","))
    d = SMALL["d"] if args.small else D
    sizes = SMALL["min_n"] if args.small else MIN_N_SIZES
    n_ladder = SMALL["ladder_n"] if args.small else LADDER_N
    shares = SMALL["shares"] if args.small else MIXED_SHARES

    def emit(row: dict) -> None:
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    head = {"sweep": sorted(sweeps), "passes": args.passes, "device": str(device),
            "torch": torch.__version__}
    if device.type == "cuda":
        head["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit(head)
    ladder = [(f"mixed_p{p}", lambda p=p: mixed_corpus(n_ladder, d, p)) for p in shares]
    ladder += [("clustered", lambda: clustered_corpus(n_ladder, d)),
               ("gaussian", lambda: gaussian_corpus(n_ladder, d))]
    min_n_rows, ladder_rows = [], []
    if "min_n" in sweeps:
        for n in sizes:
            Y, psi = locality_corpus(n, d, clusters=min(2048, n // 8))
            row = compare("locality", Y, psi, device, args.passes, sweep="min_n")
            emit(row)
            min_n_rows.append(row)
    if "ladder" in sweeps:
        for tag, make in ladder:
            Y, psi = make()
            row = compare(tag, Y, psi, device, args.passes, sweep="ladder")
            emit(row)
            ladder_rows.append(row)
    if "halo" in sweeps:
        for tag, make in ladder:
            Y, psi = make()
            emit({"sweep": "halo", **halo_compare(tag, Y, psi, device, args.passes, SHARDS)})
    if "auto" in sweeps:
        for tag, make in ladder:
            Y, psi = make()
            emit(auto_time(tag, Y, psi, device, args.passes, SHARDS))
    if min_n_rows or ladder_rows:
        emit({"derived": derive(min_n_rows, ladder_rows)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
