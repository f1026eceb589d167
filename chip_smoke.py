"""Smoke run of the PyTorch port on one CUDA card (an H100 for this port).

    python3 chip_smoke.py

Builds kernels K1 (``oscillink_tpu_torch/csrc/spmv.cu``), K2, K3 and K4
(``csrc/window_spmv3f.cu``, three variants of one gather kernel) and K5
(``csrc/bucket_gather.cu``) from the checkout, one ``nvcc`` per source, all
started together, and holds each against its plain PyTorch version (K2-K4
against the one-hot form and their own gather forms, and bit-equal from
launch to launch; on a NaN and an infinity in window rows no row
references, to the gather forms' semantics).  Then it drives the paths
through the public entry points:

* the gather path (K1): quickstart and headline against the port's CPU path,
  and the 131072 x 768 x k8 corpus;
* the windowed tier (``OSCILLINK_WINDOWED_MATVEC=1``): a locality-ordered
  131072 x 768 x k8 corpus through K4, held to the gather path on the same
  corpus; a clustered corpus with stragglers through K4 (fused) and K3
  (``OSCILLINK_WINDOWED_FUSED=0``); and a D = 97 lattice through K2 and its
  straggler epilogue, each held to the port's CPU path; the card's window
  contexts must hold no one-hot;
* the bucket-shuffle probe (K5, ``oscillink_tpu_torch.benchmarks.
  probe_bucket_gather``) at its full size, 126976 x 768 with 1015808 edges.

Each path runs with every launch count set to 0 just before it and read just
after.  Every check that fails raises, so the script exits non-zero; it
never falls back to the CPU.  Without CUDA it exits 1 before printing any
result.

Output: the card's name and power limit (as nvidia-smi reports them), one
JSON line per phase, the ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from oscillink_tpu_torch import Oscillink
from oscillink_tpu_torch.benchmarks import probe_bucket_gather as probe
from oscillink_tpu_torch.core.lattice import _locality_order
from oscillink_tpu_torch.ops.graph import build_graph, lap_matvec
from oscillink_tpu_torch.ops.kernels import bucket_gather as bg
from oscillink_tpu_torch.ops.kernels import build as kbuild
from oscillink_tpu_torch.ops.kernels import spmv
from oscillink_tpu_torch.ops.kernels import window_spmv as tw
from oscillink_tpu_torch.ops import receipts as treceipts
from oscillink_tpu_torch.ops.path import build_path_graph
from oscillink_tpu_torch.ops.receipts import deltaH_tree_np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TOL = 1e-5  # kernel vs plain: same K order, the gap is FMA contraction only
# K2-K4 vs the one-hot plain versions, relative to max|plain|: the kernels'
# gather-form products differ from the one-hot form's bf16 passes by about
# 2^-16 each (csrc/window_spmv3f.cu)
WIN_TOL = 1e-5
PAP_TOL = 1e-4  # K4's column partials: sums over 384 rows, then over blocks
# K2-K4 vs their gather-form plain versions: the same products in the same
# order, relative to max|plain|; only FMA contraction differs.  K4's
# partials sum 384 rows per block in the kernel's lane-and-warp order, the
# plain version in torch.sum's.
GATHER_TOL = 1e-6
GATHER_PAP_TOL = 1e-5
LATTICE_TOL = 1e-5  # deltaH, card vs the port's CPU path
WINDOWED_VS_GATHER_TOL = 2e-3  # deltaH, windowed vs gather (tests/test_fused_windowed.py)
WIN, WIN_R, N_WIN = 384, 384, 3  # the lattice's window geometry
# key, name, wrapper, the TPU kernel it replaces; all three in WINDOW_SOURCE
WINDOW_KERNELS = (
    ("K2", "window_spmv", tw.window_spmv_cuda, "oscillink_tpu/ops/pallas/window_spmv.py:409"),
    ("K3", "window_spmv3", tw.window_spmv3_cuda, "oscillink_tpu/ops/pallas/window_spmv.py:457"),
    ("K4", "window_spmv3f", tw.window_spmv3f_cuda, "oscillink_tpu/ops/pallas/window_spmv.py:594"),
)
WINDOW_SOURCE = "oscillink_tpu_torch/csrc/window_spmv3f.cu"

QUICK = dict(n=120, d=128, k=6, chain=[2, 5, 7, 9], lamP=0.2)
HEADLINE = dict(n=5000, d=128, k=6)  # bench.py's workload
CORPUS = dict(n=131072, d=768, k=8)  # the 100k-131k x 768 x k8 corpus tier
RAGGED = dict(n=4099, d=97, k=5)
K_ONE = dict(n=333, d=130, k=1)
K_WIDE = dict(n=1000, d=64, k=40)  # more neighbours than one warp's 32 lanes
WIN_RAGGED = dict(n=4099, d=97, k=8)  # N not a multiple of 384, D not of 4
# K4's other geometries: the JAX package's W = 512 / R = 256 / 2 windows, and
# 40 slots a row (more than a warp's lanes; the lists take two row passes)
WIN_512 = dict(n=4099, d=128, k=8, W=512, R=256, n_win=2)
WIN_K40 = dict(n=4099, d=97, k=40)
STRAGGLERS = dict(n=16384, d=768, k=8)
NARROW = dict(n=8192, d=97, k=8)
# K5: the probe's check shape, and D = 97 (the scalar path) with e_pad = ETILE
K5_SHAPES = (("check", 2, 128, 2 * bg.ETILE), ("ragged", 3, 97, bg.ETILE))
PROBE_D = 768  # the probe's full width; its 31 buckets are probe_tensors' default


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def sync_ms(t0: float) -> float:
    torch.cuda.synchronize()
    return 1000.0 * (time.perf_counter() - t0)


def cuda_ms(fn, reps: int, groups: int = 3) -> float:
    """Median over ``groups`` of the CUDA-event mean of ``reps`` launches."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def data(n: int, d: int, seed: int = 0):
    """bench.py's inputs: Gaussian anchors, psi = normalized mean of 32 rows."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d), dtype=np.float32)
    m = Y[:32].mean(axis=0)
    return Y, (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def quickstart(device: str) -> dict:
    """The verify-skill quickstart flow on ``device``."""
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((QUICK["n"], QUICK["d"])).astype(np.float32)
    m = Y[:20].mean(0)
    psi = (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)
    lat = Oscillink(Y, kneighbors=QUICK["k"], device=device)
    lat.set_query(psi)
    lat.add_chain(QUICK["chain"], lamP=QUICK["lamP"])
    st = lat.settle(max_iters=12, tol=1e-3)
    rec = lat.receipt()
    # the fixed-order f64 deltaH must equal the NumPy specification bit for bit
    os.environ["OSCILLINK_DETERMINISTIC_RECEIPTS"] = "1"
    try:
        det = lat.receipt()["deltaH_total"]
    finally:
        del os.environ["OSCILLINK_DETERMINISTIC_RECEIPTS"]
    g = lat.graph
    pg = build_path_graph(QUICK["n"], QUICK["chain"], device=torch.device("cpu"))
    spec = float(deltaH_tree_np(
        g.idx.cpu().numpy(), g.wn.cpu().numpy(), lat.U, lat.solve_Ustar(),
        lat.lamG, lat.lamC, lat.lamQ, lat.B_diag,
        path_src=pg.src.numpy(), path_dst=pg.dst.numpy(), path_wn=pg.wn.numpy(), lamP=lat.lamP,
    ))
    return {
        "deltaH": rec["deltaH_total"],
        "nulls": len(rec["null_points"]),
        "verdict": lat.chain_receipt(QUICK["chain"])["verdict"],
        "bundle": [b["id"] for b in lat.bundle(k=6)],
        "state_sig": rec["meta"]["state_sig"],
        "settle_iters": st["iters"],
        "ustar_iters": rec["meta"]["ustar_iters"],
        "deltaH_f64_tree": det.hex(),
        "deltaH_f64_tree_bits_equal_numpy_spec": det.hex() == spec.hex(),
    }


def flow_pass(Y, psi, k: int) -> tuple[dict, Oscillink, int]:
    """One pass of bench.py's flow, each phase timed to a device sync.
    Also returns the K1 launches counted across its settle."""
    t = {}
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k)
    lat.set_query(psi)
    lat.set_receipt_detail("light")
    t["build_ms"] = sync_ms(t0)
    before = spmv.launches
    t0 = time.perf_counter()
    lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    t["settle_ms"] = sync_ms(t0)
    settle_launches = spmv.launches - before
    t0 = time.perf_counter()
    lat._solve_ustar_device()  # the device solve alone; receipt() then hits the cache
    t["ustar_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    rec = lat.receipt()
    t["receipt_light_ms"] = sync_ms(t0)
    check(np.isfinite(rec["deltaH_total"]), "deltaH is not finite")
    return t, lat, settle_launches


def headline_flow(Y, psi, k: int, device: str) -> dict:
    """bench.py's flow with a full receipt on ``device``; what the card and
    the port's CPU path must agree on."""
    lat = Oscillink(Y, kneighbors=k, device=device)
    lat.set_query(psi)
    st = lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    rec = lat.receipt()
    return {
        "idx": lat.graph.idx.cpu(),
        "deltaH": rec["deltaH_total"],
        "null_edges": [p["edge"] for p in rec["null_points"]],
        "bundle": [b["id"] for b in lat.bundle(k=k)],
        "state_sig": rec["meta"]["state_sig"],
        "settle_iters": st["iters"],
        "ustar_iters": rec["meta"]["ustar_iters"],
    }


def headline_parity(Y, psi, k: int) -> dict:
    """The headline cell on the card against the port on the CPU.  N = 5000
    takes the blocked graph build, so the card's top-k tie order (stable_topk
    on CUDA torch.topk / torch.sort) is held to the CPU's; the card's full
    receipt runs the row-blocked edge distances (budget lowered for this
    pass), the CPU's the direct ones."""
    saved = treceipts._EDGE_TEMP_BUDGET_BYTES, treceipts._EDGE_BLOCK_ROWS
    treceipts._EDGE_TEMP_BUDGET_BYTES, treceipts._EDGE_BLOCK_ROWS = 0, 1024
    try:
        gpu = headline_flow(Y, psi, k, "cuda")
    finally:
        treceipts._EDGE_TEMP_BUDGET_BYTES, treceipts._EDGE_BLOCK_ROWS = saved
    cpu = headline_flow(Y, psi, k, "cpu")
    rel = abs(gpu["deltaH"] - cpu["deltaH"]) / max(abs(cpu["deltaH"]), 1e-30)
    check(torch.equal(gpu["idx"], cpu["idx"]), "headline graph idx: cuda != cpu")
    check(rel <= 1e-5, f"headline deltaH differs: {rel}")
    for key in ("null_edges", "bundle", "state_sig", "settle_iters", "ustar_iters"):
        check(gpu[key] == cpu[key], f"headline {key}: cuda != cpu")
    return {
        "idx_equal": True, "deltaH_rel": rel, "null_points": len(cpu["null_edges"]),
        "bundle": cpu["bundle"], "state_sig": cpu["state_sig"],
        "settle_iters": cpu["settle_iters"], "ustar_iters": cpu["ustar_iters"],
    }


def medians(passes: list[dict]) -> dict:
    return {key: statistics.median(p[key] for p in passes) for key in passes[0]}


def kernel_vs_plain(shape: dict, gen: torch.Generator) -> dict:
    """Build a real graph with the port at ``shape``, run K1 and its plain
    version on the same inputs, and hold them together."""
    dev = torch.device("cuda")
    n, d, k = shape["n"], shape["d"], shape["k"]
    Y = torch.randn(n, d, generator=gen, device=dev)
    g = build_graph(Y, k)
    X = torch.randn(n, d, generator=gen, device=dev)
    out = lap_matvec(g, X)
    ref = spmv.lap_matvec_ref(g.idx, g.wn, X)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()), f"K1 output not finite at {shape}")
    check(torch.allclose(out, ref, rtol=TOL, atol=TOL), f"K1 != plain at {shape}: {err}")
    emit("kernel_vs_plain", **shape, max_abs_err=err, tol=TOL)
    return {"g": g, "X": X, "err": err}


def csr_of(idx: torch.Tensor, wn: torch.Tensor) -> torch.Tensor:
    """(I - Wn) as a CSR matrix: the library yardstick computes the
    operator of K1 (and of K2-K4) with one torch.sparse.mm call."""
    dev = idx.device
    n, k = idx.shape
    cols = torch.cat([torch.arange(n, device=dev)[:, None], idx.long()], dim=1)
    vals = torch.cat([torch.ones(n, 1, device=dev), -wn], dim=1)
    cols, perm = torch.sort(cols, dim=1)
    vals = torch.gather(vals, 1, perm)
    crow = torch.arange(0, n * (k + 1) + 1, k + 1, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # CSR support is marked beta
        return torch.sparse_csr_tensor(
            crow, cols.reshape(-1), vals.reshape(-1), size=(n, n), check_invariants=False
        )


def time_kernel(shape: dict, case: dict) -> dict:
    g, X = case["g"], case["X"]
    n, d, k = shape["n"], shape["d"], shape["k"]
    reps = 200 if n * d < 10_000_000 else 20
    kernel_ms = cuda_ms(lambda: spmv.lap_matvec_cuda(g.idx, g.wn, X), reps)
    plain_ms = cuda_ms(lambda: spmv.lap_matvec_ref(g.idx, g.wn, X), max(2, reps // 10))
    A = csr_of(g.idx, g.wn)
    lib_out = torch.sparse.mm(A, X)
    lib_err = float((lib_out - lap_matvec(g, X)).abs().max())
    check(lib_err < 1e-4, f"library yardstick disagrees with K1 at {shape}: {lib_err}")
    library_ms = cuda_ms(lambda: torch.sparse.mm(A, X), reps)
    unique_bytes = (2 * n * d + 2 * n * k) * 4
    flops = 2 * n * k * d
    bound_ms = 1e3 * max(unique_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    gather_ms = 1e3 * (n * k * d * 4 + unique_bytes) / HBM_BYTES_PER_S
    row = {
        **shape,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if unique_bytes / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations",
        "gather_ceiling_ms": gather_ms,
        "achieved_GBps": unique_bytes / (kernel_ms * 1e-3) / 1e9,
        "max_abs_err": case["err"],
        "library_max_abs_err": lib_err,
    }
    emit("kernel_timing", **row)
    return row


# -- the windowed tier (kernels K2-K4) ----------------------------------------


@contextlib.contextmanager
def env(**values: str):
    """Set environment variables for the block, then restore them."""
    saved = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def reset_counts() -> None:
    spmv.launches = 0
    bg.launches = 0
    for _, _, fn, _ in WINDOW_KERNELS:
        fn.launches = 0


def read_counts() -> dict:
    return {"K1": spmv.launches, **{name: fn.launches for name, _, fn, _ in WINDOW_KERNELS},
            "K5": bg.launches}


def bench_graph(n: int, k: int, seed: int = 0):
    """The JAX package's kernel-bench graph (bench.py): neighbours i +- 400
    (mod n), weights U[0, 0.1)."""
    rng = np.random.default_rng(seed)
    idx = ((np.arange(n)[:, None] + rng.integers(-400, 400, size=(n, k))) % n).astype(np.int32)
    wn = (rng.random((n, k)) * 0.1).astype(np.float32)
    return idx, wn


def window_case(shape: dict, seed: int) -> dict:
    """The bench graph at ``shape`` with its window geometry (the lattice's
    unless ``shape`` names W, R and n_win): its plan (the device builder,
    rows in their own order, a straggler cap that cannot truncate) and
    one-hots on the card (for the one-hot plain versions only), X (padding
    rows zero) and a diagonal g."""
    n, d, k = shape["n"], shape["d"], shape["k"]
    W, R, n_win = shape.get("W", WIN), shape.get("R", WIN_R), shape.get("n_win", N_WIN)
    idx, wn = bench_graph(n, k, seed)
    idx_t, wn_t = torch.from_numpy(idx).cuda(), torch.from_numpy(wn).cuda()
    # a block's padded straggler segment is at most R * k entries
    seg_bound = -(-R * k // 128) * 128
    cap = -(-(n * k + 8 * -(-n // R) + seg_bound) // 128) * 128
    plan, cov_t, n_strag_t, fits_t = tw.build_window_plan_device(
        idx_t, wn_t, torch.arange(n, device="cuda"), W, R, cap, seg_bound, n_win)
    check(bool(fits_t) and int(n_strag_t) <= cap, f"bench-graph plan refused at {shape}")
    s_max = tw.plan_s_max(plan)
    plan = tw.right_size_stragglers(plan, int(plan.strag_off[-1]), s_max)
    oh = tw.build_onehot(plan, W, s_max)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(n, d, generator=gen, device="cuda")
    cnt = plan.strag_cnt.cpu().numpy()
    return {
        "idx": idx_t, "wn": wn_t, "plan": plan, "oh": oh, "s_max": s_max, "geo": (W, R),
        "X": X, "Xpad": tw.pad_rows(X, plan.n_pad),
        "g": 1.5 + torch.rand(plan.n_pad, 1, generator=gen, device="cuda"),
        "nnz": {"strag_w": int(torch.count_nonzero(plan.strag_w)),
                "wnl": int(torch.count_nonzero(plan.wnl)),
                "strag_seg": int(np.minimum(cnt, s_max).sum())},
        "info": {"W": W, "R": R, "n_win": n_win, **shape, "coverage": float(cov_t),
                 "s_max": s_max, "n_pad": plan.n_pad,
                 "blocks": len(cnt), "blocks_with_stragglers": int((cnt > 0).sum())},
    }


def window_calls(case: dict, tier: str) -> dict:
    """(kernel, one-hot plain, gather plain) callables of K2, K3 and K4 at
    ``tier``, each returning a tuple (K4: out and partials).  The kernels
    read the plan and no one-hot; the one-hot is stored in bf16 under
    oh16/dma16, as the CPU lattice stores it."""
    plan, oh, X, g, s_max = case["plan"], case["oh"], case["Xpad"], case["g"], case["s_max"]
    main = oh.main.to(torch.bfloat16) if tier in ("oh16", "dma16") else oh.main
    W, R = case["geo"]
    return {
        "K2": (lambda: (tw.window_spmv_cuda(plan, X, W, R, tier),),
               lambda: (tw.window_spmv_ref(plan, main, X, W, R, tier),),
               lambda: (tw.window_spmv_gather_ref(plan, X, W, R, tier),)),
        "K3": (lambda: (tw.window_spmv3_cuda(plan, X, W, R, s_max, tier),),
               lambda: (tw.window_spmv3_ref(plan, main, oh.strag, X, W, R, s_max, tier),),
               lambda: (tw.window_spmv3_gather_ref(plan, X, W, R, s_max, tier),)),
        "K4": (lambda: tw.window_spmv3f_cuda(plan, X, g, W, R, s_max, tier),
               lambda: tw.window_spmv3f_ref(plan, main, oh.strag, X, g, W, R, s_max, tier),
               lambda: tw.window_spmv3f_gather_ref(plan, X, g, W, R, s_max, tier)),
    }


def window_vs_plain(case: dict, tier: str) -> dict:
    """K2, K3, K4 (and K4's column partials) against their one-hot plain
    versions and their gather forms, and each bit-equal from launch to
    launch."""
    errs = {}
    for name, (kern, plain, gather) in window_calls(case, tier).items():
        out, again = kern(), kern()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"{name} differs from launch to launch ({tier}, {case['info']})")
        del again
        ref, gref = plain(), gather()
        pairs = [(name, out[0], ref[0], WIN_TOL), (f"{name}_gather", out[0], gref[0], GATHER_TOL)]
        if name == "K4":
            pairs += [("K4_pap", out[1], ref[1], PAP_TOL),
                      ("K4_gather_pap", out[1], gref[1], GATHER_PAP_TOL)]
        for key, o, r, tol in pairs:
            torch.cuda.synchronize()
            err = float((o - r).abs().max())
            scale = float(r.abs().max())
            check(bool(torch.isfinite(o).all()), f"{key} output not finite ({tier}, {case['info']})")
            check(err <= tol * scale, f"{key} != plain ({tier}, {case['info']}): {err} > {tol} * {scale}")
            errs[key] = err
        del out, ref, gref
    return errs


def poisoned_case(case: dict) -> dict:
    """The case with a NaN in one row of its elected windows and an infinity
    in another, and every live slot and straggler that reads either dropped
    from the plan (rows no entry reads are taken first, real rows (< n)
    before padding ones, never a padding straggler's source), so that no
    row but the two themselves references a non-finite row."""
    plan, (W, R), n = case["plan"], case["geo"], case["info"]["n"]
    n_pad = plan.n_pad
    dev = plan.cs.device
    rows = torch.arange(n_pad, device=dev)
    read = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    held = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    cols = []
    for w in range(plan.n_windows):
        cols.append((plan.cs[w].long()[rows // R] * W)[:, None] + plan.idxl[w].long())
        read[cols[w][plan.wnl[w] != 0.0]] = True
        held[(plan.cs[w].long()[:, None] * W + torch.arange(W, device=dev)).reshape(-1)] = True
    src = plan.strag_src.long()
    read[src[plan.strag_w != 0.0]] = True
    held[src[plan.strag_w == 0.0]] = False
    cand = torch.nonzero(held)[:, 0]
    key = (read[cand].long() * 2 + (cand >= n).long()) * n_pad + cand
    bad = cand[torch.sort(key).indices[:2]]
    check(bad.numel() == 2, f"no two window rows to poison ({case['info']})")
    wnl = torch.stack([torch.where(torch.isin(cols[w], bad), 0.0, plan.wnl[w])
                       for w in range(plan.n_windows)])
    strag_w = torch.where(torch.isin(src, bad), 0.0, plan.strag_w)
    X = case["Xpad"].clone()
    X[bad[0]] = float("nan")
    X[bad[1]] = float("inf")
    dropped = {"slots": int(torch.count_nonzero(plan.wnl) - torch.count_nonzero(wnl)),
               "stragglers": int(torch.count_nonzero(plan.strag_w) - torch.count_nonzero(strag_w))}
    return {**case, "plan": plan._replace(wnl=wnl, strag_w=strag_w), "Xpad": X,
            "rows": bad, "dropped": dropped}


def window_nonfinite(case: dict) -> dict:
    """The windowed tier's NaN/Inf behaviour on the card (gather semantics)
    on `poisoned_case`'s input: K2, K3 and K4 equal their gather forms (NaN
    where they have NaN), and only the two poisoned rows' outputs are not
    finite.  The one-hot forms' non-finite rows are counted beside them:
    they spread the values to every row of each block whose windows hold
    them."""
    pc = poisoned_case(case)
    bad_rows = pc["rows"].sort().values
    out = {"rows": bad_rows.tolist(), "dropped": pc["dropped"]}
    for name, (kern, plain, gather) in window_calls(pc, "bf16x3").items():
        o, r = kern()[0], gather()[0]
        torch.cuda.synchronize()
        scale = float(r[torch.isfinite(r)].abs().max())
        check(torch.allclose(o, r, rtol=0.0, atol=GATHER_TOL * scale, equal_nan=True),
              f"{name} != its gather form on non-finite input ({case['info']})")
        bad = torch.nonzero(~torch.isfinite(o).all(dim=1))[:, 0]
        check(torch.equal(bad, bad_rows),
              f"{name}: rows {bad.tolist()[:8]} not finite, expected {bad_rows.tolist()} only")
        one_hot = plain()[0]
        out[name] = {"nonfinite_rows": int(bad.numel()),
                     "onehot_nonfinite_rows": int((~torch.isfinite(one_hot).all(dim=1)).sum())}
        del o, r, one_hot
    return out


def window_bound(case: dict, name: str) -> dict:
    """The least time for one apply of K2, K3 or K4 (``bound_ms``,
    ``bound_by``): X read once (the straggler source rows are rows of X),
    out written once, idxl, wnl and cs; K3 and K4 also the straggler
    entries of the blocks' segments and the block counts and offsets; K4
    also g and the partials; over the HBM rate.  Against it one f32
    multiply-add per live slot (K3, K4: and live straggler) and column, K4
    also the g, x ⊙ out and partial work, over the f32 peak."""
    plan, nnz = case["plan"], case["nnz"]
    n_pad, d = case["Xpad"].shape
    blocks = plan.n_blocks
    nbytes = 2 * n_pad * d * 4 + 2 * plan.idxl.numel() * 4 + plan.cs.numel() * 4
    ops = 2 * nnz["wnl"] * d
    if name != "K2":
        nbytes += nnz["strag_seg"] * 12 + 2 * blocks * 4
        ops += 2 * nnz["strag_w"] * d
    if name == "K4":
        nbytes += n_pad * 4 + blocks * d * 4
        ops += 3 * n_pad * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes}


def window_timing(case: dict) -> dict:
    """K2-K4 at the default tier (bf16x3) with CUDA events, beside their
    one-hot and gather-form plain versions, their bounds, torch.sparse.mm of
    the same operator as a CSR matrix, and K1 on the same graph."""
    n = case["info"]["n"]
    X = case["X"]
    A = csr_of(case["idx"], case["wn"])
    lib_out = torch.sparse.mm(A, X)
    k1_out = spmv.lap_matvec_cuda(case["idx"], case["wn"], X)
    k3_out = window_calls(case, "bf16x3")["K3"][0]()[0][:n]
    torch.cuda.synchronize()
    lib_err = float((lib_out - k3_out).abs().max())
    check(lib_err <= 1e-4 * float(lib_out.abs().max()),
          f"library yardstick disagrees with K3: {lib_err}")
    library_ms = cuda_ms(lambda: torch.sparse.mm(A, X), 20)
    k1_ms = cuda_ms(lambda: spmv.lap_matvec_cuda(case["idx"], case["wn"], X), 20)
    k1_err = float((k1_out - k3_out).abs().max())
    rows = {}
    for name, (kern, plain, gather) in window_calls(case, "bf16x3").items():
        rows[name] = {
            "ms": cuda_ms(kern, 50), "plain_ms": cuda_ms(plain, 3),
            "gather_plain_ms": cuda_ms(gather, 3), **window_bound(case, name),
            "library_ms": library_ms,
        }
    emit("window_timing", **case["info"], tier="bf16x3", k1_same_graph_ms=k1_ms,
         k1_vs_k3_max_abs=k1_err, library_vs_k3_max_abs=lib_err, nnz=case["nnz"], **rows)
    return {"rows": rows, "k1_ms": k1_ms}


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
    m = Y[:32].mean(axis=0)
    return Y, (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def clustered_corpus(n: int, d: int, seed: int = 0):
    """The JAX package's "real clustered" corpus
    (benchmarks/probe_e2e_settle_dma16.py): 64 Gaussian centres, noise 0.35.
    psi is the normalized mean of the first 64 rows."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32)
    assign = rng.integers(0, 64, size=n)
    Y = (centers[assign] + 0.35 * rng.standard_normal((n, d))).astype(np.float32)
    m = Y[:64].mean(axis=0)
    return Y, (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def ctx_info(lat: Oscillink) -> dict:
    """The window context's plan, geometry and coverage; the card's context
    must hold no one-hot (its kernels read the plan), the CPU's must."""
    ctx = lat._window_ctx
    check(ctx is not None, "OSCILLINK_WINDOWED_MATVEC=1 built no window context")
    on_card = lat.device.type == "cuda"
    check((ctx.oh is None) == on_card,
          f"the {lat.device.type} lattice's window context "
          f"{'holds a one-hot' if on_card else 'lacks the one-hot its plain versions read'}")
    cnt = ctx.plan.strag_cnt.cpu()
    return {
        "coverage": lat._window_coverage,
        "stragglers": int(torch.count_nonzero(ctx.plan.strag_w)),
        "blocks_with_stragglers": int(torch.count_nonzero(cnt)),
        "blocks": int(cnt.numel()),
        "W": ctx.W,
        "s_max": ctx.s_max,
        "n_pad": ctx.plan.n_pad,
        "onehot_built": ctx.oh is not None,
    }


def windowed_pass(Y, psi, k: int) -> tuple[dict, dict]:
    """One pass of the windowed main path on the card: build (graph, locality
    order, plan; no one-hots), settle, U*, light and full receipt, bundle.
    Returns the phase times and what the pass counted and produced."""
    t = {}
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k)
    lat.set_query(psi)
    lat.set_receipt_detail("light")
    t["build_ms"] = sync_ms(t0)
    info = ctx_info(lat)
    k4 = tw.window_spmv3f_cuda
    before = k4.launches
    t0 = time.perf_counter()
    lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    t["settle_ms"] = sync_ms(t0)
    settle_k4 = k4.launches - before
    before = k4.launches
    t0 = time.perf_counter()
    lat._solve_ustar_device()
    t["ustar_ms"] = sync_ms(t0)
    ustar_k4 = k4.launches - before
    before = spmv.launches
    t0 = time.perf_counter()
    lat.receipt()
    t["receipt_light_ms"] = sync_ms(t0)
    lat.set_receipt_detail("full")
    t0 = time.perf_counter()
    rec = lat.receipt()
    t["receipt_full_ms"] = sync_ms(t0)
    receipt_k1 = spmv.launches - before
    t0 = time.perf_counter()
    bundle = [b["id"] for b in lat.bundle(k=8)]
    t["bundle_ms"] = sync_ms(t0)
    out = {
        **info, "settle_iters": lat.last["iters"], "ustar_iters": rec["meta"]["ustar_iters"],
        "settle_k4": settle_k4, "ustar_k4": ustar_k4, "receipt_k1": receipt_k1,
        "deltaH": rec["deltaH_total"], "null_points": len(rec["null_points"]),
        "bundle": bundle, "window_precision": rec["meta"].get("window_precision"), "lat": lat,
    }
    return t, out


def window_ctx_timing(lat: Oscillink) -> dict:
    """The window context's build on a built lattice, timed to a sync: the
    locality order alone, and the whole context (order, device plan with its
    one host read; on the card no one-hots)."""
    t = {}
    t0 = time.perf_counter()
    _locality_order(lat._Y_dev)
    t["locality_order_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    lat._maybe_build_window_ctx()
    t["window_ctx_ms"] = sync_ms(t0)
    ctx_info(lat)
    return t


def windowed_corpus() -> int:
    """The full-width windowed main path (K4) on a locality-ordered
    131072 x 768 x k8 corpus, then the gather path on the same corpus.
    Returns the K4 launches counted across the windowed run."""
    Y, psi = locality_corpus(CORPUS["n"], CORPUS["d"])
    with env(OSCILLINK_WINDOWED_MATVEC="1"):
        windowed_pass(Y, psi, CORPUS["k"])  # warm-up
        passes = [windowed_pass(Y, psi, CORPUS["k"])[0] for _ in range(2)]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t, run = windowed_pass(Y, psi, CORPUS["k"])
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        passes.append(t)
        lat = run.pop("lat")
        U = lat.U
        ctx_t = window_ctx_timing(lat)
        del lat
    with env(OSCILLINK_WINDOWED_MATVEC="0"):
        lat = Oscillink(Y, kneighbors=CORPUS["k"])
        lat.set_query(psi)
        lat.settle(dt=1.0, max_iters=12, tol=1e-3)
        rec = lat.receipt()
        gather = {"deltaH": rec["deltaH_total"], "bundle": [b["id"] for b in lat.bundle(k=8)],
                  "settle_iters": lat.last["iters"], "ustar_iters": rec["meta"]["ustar_iters"]}
        del lat
    rel = abs(run["deltaH"] - gather["deltaH"]) / max(abs(gather["deltaH"]), 1e-30)
    emit("windowed_corpus", **CORPUS, passes=len(passes), **medians(passes), last_pass=t,
         **ctx_t, **{key: val for key, val in run.items() if key != "bundle"},
         launches=counts, max_memory_allocated_bytes=peak, bundle_ids=run["bundle"],
         gather=gather, deltaH_rel_vs_gather=rel)
    check(counts["K4"] > 0, "K4 was not launched on the windowed main path")
    check(run["settle_k4"] == run["settle_iters"] + 1,
          f"K4 launches in settle {run['settle_k4']} != r0 + {run['settle_iters']} iterations")
    check(run["ustar_k4"] == run["ustar_iters"] + 1,
          f"K4 launches in U* {run['ustar_k4']} != r0 + {run['ustar_iters']} iterations")
    check(counts["K1"] == run["receipt_k1"] == 2,
          f"K1 launches {counts['K1']} != the 2 receipts' operator applies")
    check(counts["K4"] == run["settle_k4"] + run["ustar_k4"], "K4 launched off settle and U*")
    check(U.shape == (CORPUS["n"], CORPUS["d"]) and bool(np.isfinite(U).all()),
          "windowed U not finite")
    check(np.isfinite(run["deltaH"]) and run["deltaH"] >= 0, "windowed deltaH invalid")
    check(rel <= WINDOWED_VS_GATHER_TOL, f"windowed deltaH differs from gather: {rel}")
    check(run["bundle"] == gather["bundle"], "windowed bundle ids differ from gather")
    return counts["K4"]


def windowed_flow(lat: Oscillink, psi) -> dict:
    """A forced-windowed lattice: settle, U*, full receipt, bundle; settle
    and U* timed to a sync (one pass, the kernels warm from the phases
    before)."""
    info = ctx_info(lat)
    lat.set_query(psi)
    t0 = time.perf_counter()
    st = lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    settle_ms = sync_ms(t0)
    t0 = time.perf_counter()
    lat._solve_ustar_device()  # the device solve alone; receipt() then hits the cache
    ustar_ms = sync_ms(t0)
    rec = lat.receipt()
    return {
        **info, "settle_ms": settle_ms, "ustar_ms": ustar_ms,
        "deltaH": rec["deltaH_total"], "null_points": len(rec["null_points"]),
        "bundle": [b["id"] for b in lat.bundle(k=8)], "state_sig": rec["meta"]["state_sig"],
        "settle_iters": st["iters"], "ustar_iters": rec["meta"]["ustar_iters"],
        "window_precision": rec["meta"].get("window_precision"),
    }


def near_tie_witness(Y: np.ndarray, idx_card: np.ndarray, idx_cpu: np.ndarray) -> dict:
    """Where the card's top-k and the CPU's differ, the f64 similarities of
    the two neighbours in each differing slot.  Each slot holds the row's
    k-th order statistic of its f32 similarities on both sides, so when the
    two differ only by rounding, the f64 gap is at most twice the sum of the
    two sides' worst f32 errors: 8 * gamma_(D+2) for unit rows (dot product
    and row norm on each side, gamma_n = n u / (1 - n u), u = 2^-24).
    A wrong neighbour lies far outside that; ulps are reported too."""
    rows, slots = np.nonzero(idx_card != idx_cpu)
    out = {"slots_differ": int(rows.size), "slots": int(idx_card.size)}
    d = Y.shape[1]
    nu = (d + 2) * 2.0**-24
    out["gap_bound"] = 8 * nu / (1 - nu)
    if rows.size == 0:
        return {**out, "max_gap": 0.0, "max_gap_ulps": 0.0}
    Yn = Y.astype(np.float64)
    Yn /= np.linalg.norm(Yn, axis=1, keepdims=True) + 1e-12
    s_card = np.einsum("ij,ij->i", Yn[rows], Yn[idx_card[rows, slots]])
    s_cpu = np.einsum("ij,ij->i", Yn[rows], Yn[idx_cpu[rows, slots]])
    gap = np.abs(s_card - s_cpu)
    ulp = np.spacing(np.maximum(np.abs(s_card), np.abs(s_cpu)).astype(np.float32))
    return {**out, "max_gap": float(gap.max()), "max_gap_ulps": float((gap / ulp).max())}


def card_vs_cpu(tag: str, Y, psi, k: int, kernel: str) -> tuple[dict, Oscillink]:
    """The forced-windowed flow on the card, launch counts set to 0 just
    before it and read just after, held to the port's CPU path on the card's
    graph.  cuBLAS and the CPU's BLAS round the f32 similarities differently,
    so near-tied neighbours can swap slots between the two builds: the phase
    counts those slots, holds their f64 gap to the rounding bound
    (`near_tie_witness`), and then compares the windowed tier on one graph."""
    reset_counts()
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k)
    gpu = windowed_flow(lat, psi)
    wall_ms = sync_ms(t0)
    counts = read_counts()
    ties = near_tie_witness(
        Y, lat.graph.idx.cpu().numpy(), build_graph(torch.from_numpy(Y), k).idx.numpy())
    lat_cpu = Oscillink(Y, kneighbors=k, device="cpu", graph=lat.graph)
    cpu = windowed_flow(lat_cpu, psi)
    del lat_cpu
    rel = abs(gpu["deltaH"] - cpu["deltaH"]) / max(abs(cpu["deltaH"]), 1e-30)
    emit(tag, cuda={key: val for key, val in gpu.items() if key != "bundle"}, cuda_wall_ms=wall_ms,
         cpu_settle_iters=cpu["settle_iters"], cpu_ustar_iters=cpu["ustar_iters"],
         bundle_ids=gpu["bundle"], launches=counts, deltaH_rel=rel,
         graph_build_cuda_vs_cpu=ties)
    check(ties["max_gap"] <= ties["gap_bound"],
          f"{tag}: the card's graph and the CPU's differ beyond rounding: {ties}")
    check(counts[kernel] > 0, f"{kernel} was not launched on the {tag} path")
    check(rel <= LATTICE_TOL, f"{tag} deltaH differs: {rel}")
    for key in ("null_points", "bundle", "state_sig", "settle_iters", "ustar_iters",
                "window_precision", "coverage", "stragglers", "s_max"):
        check(gpu[key] == cpu[key], f"{tag} {key}: cuda {gpu[key]} vs cpu {cpu[key]}")
    return {"launches": counts[kernel], **gpu}, lat


# -- the bucket-shuffle probe (kernel K5) ---------------------------------------


def k5_vs_plain(X, li, w, n_buckets: int, tag: str) -> float:
    """K5 against its plain version on the same inputs: bit-equal, since
    each element is one multiply on both sides."""
    out = bg.bucket_gather_cuda(X, li, w, n_buckets)
    ref = bg.bucket_gather_ref(X, li, w, n_buckets)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref), f"K5 != plain at {tag} (must be bit-equal): max abs {err}")
    return err


def bucket_gather_phase() -> dict:
    """K5 held bit-equal to its plain version at the probe's check shape, a
    ragged one and the full probe shape; then the port's probe at full size,
    every launch count set to 0 just before it and read just after.
    Returns K5's entry of the kernels line."""
    t0 = time.perf_counter()
    errs = {}
    for tag, n_buckets, d, e_pad in K5_SHAPES:
        X, li, w = (torch.from_numpy(a).cuda() for a in probe.random_case(n_buckets, d, e_pad))
        errs[tag] = k5_vs_plain(X, li, w, n_buckets, tag)
    errs["probe_check"] = probe.check_correct("cuda")
    inputs = probe.probe_tensors("cuda", PROBE_D)
    errs["probe"] = k5_vs_plain(inputs["X"], inputs["local_idx"], inputs["w"],
                                inputs["n_buckets"], "probe shape")
    reset_counts()
    res = probe.measure("cuda", inputs=inputs)
    counts = read_counts()
    del inputs
    emit("bucket_gather", max_abs_err=errs, launches=counts, phase_s=sync_ms(t0) / 1e3, **res)
    check(counts["K5"] > 0, "K5 was not launched on the probe path")
    check(res["embedding_bag_max_abs_diff"] <= 1e-6,
          f"library yardstick disagrees with K5: {res['embedding_bag_max_abs_diff']}")
    return {
        "name": "bucket_gather",
        "route": "cuda",
        "source": "oscillink_tpu_torch/csrc/bucket_gather.cu",
        "replaces": "benchmarks/probe_bucket_gather.py:65",
        "launches": counts["K5"],
        "max_abs_err": max(errs.values()),
        "ms": res["bucket_gather_ms"],
        "plain_ms": res["bucket_gather_plain_ms"],
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        "library_ms": res["embedding_bag_ms"],
        "shape": res["config"],
        "effective_GBps": res["bucket_gather_effective_gbps"],
        "library_max_abs_err": res["embedding_bag_max_abs_diff"],
        "probe_decision": res["decision"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0))

    # 1. build K1, K2-K4 and K5 from the checkout's sources, one nvcc per
    # source, all started together
    sources = ("spmv", "window_spmv3f", "bucket_gather")
    t0 = time.perf_counter()
    kbuild.build(list(sources))
    build_s = time.perf_counter() - t0
    libs = {}
    for name in sources:
        log = kbuild._target(name)[1].with_suffix(".log")
        libs[name] = {
            "library": log.with_suffix(".so").name,
            "ptxas": [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln] if log.exists() else [],
        }
        kbuild.load_library(name)
    emit("build", seconds=build_s, **libs)

    # 2. K1 against its plain version on graphs built by the port
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for name, shape in (("headline", HEADLINE), ("corpus", CORPUS), ("ragged", RAGGED),
                        ("k_one", K_ONE), ("k_wide", K_WIDE)):
        cases[name] = kernel_vs_plain(shape, gen)

    # 3. K2-K4 against their plain versions, every precision tier, on the
    # kernel-bench graph at the corpus shape, at a ragged N and D, in the
    # W = 512 / R = 256 / 2-window geometry and at 40 slots a row; on
    # non-finite input at each; then their times at the corpus shape
    # (default tier)
    win_errs: dict = {}
    for shape, seed in ((CORPUS, 0), (WIN_RAGGED, 1), (WIN_512, 2), (WIN_K40, 3)):
        case = window_case(shape, seed)
        info = case["info"]
        if shape is CORPUS:
            check(0 < info["blocks_with_stragglers"] < info["blocks"],
                  f"the bench graph should give blocks with and without stragglers: {info}")
        for tier in tw.PRECISION_TIERS:
            errs = window_vs_plain(case, tier)
            emit("window_vs_plain", **info, tier=tier, max_abs_err=errs,
                 tol={"K2-K4": WIN_TOL, "K4_pap": PAP_TOL, "K2-K4_gather": GATHER_TOL,
                      "K4_gather_pap": GATHER_PAP_TOL, "relative_to": "max|plain|"},
                 bit_equal_repeat=True)
            for key, err in errs.items():
                win_errs[key] = max(win_errs.get(key, 0.0), err)
        emit("window_nonfinite", **info, tier="bf16x3", **window_nonfinite(case))
        if shape is CORPUS:
            win_timing = window_timing(case)
        del case
    torch.cuda.empty_cache()

    # 3b. K5 against its plain version, then the bucket-shuffle probe at full
    # size; its ~13 GB are freed before the lattice phases
    k5_row = bucket_gather_phase()
    torch.cuda.empty_cache()

    # 4. quickstart: the card against the port's own CPU path
    gpu, cpu = quickstart("cuda"), quickstart("cpu")
    rel = abs(gpu["deltaH"] - cpu["deltaH"]) / max(abs(cpu["deltaH"]), 1e-30)
    emit("quickstart", cuda=gpu, cpu=cpu, deltaH_rel=rel)
    check(rel <= 1e-5, f"quickstart deltaH differs: {rel}")
    for key in ("nulls", "verdict", "bundle", "state_sig", "settle_iters", "ustar_iters"):
        check(gpu[key] == cpu[key], f"quickstart {key}: cuda {gpu[key]} vs cpu {cpu[key]}")
    for run in (gpu, cpu):
        check(run["deltaH_f64_tree_bits_equal_numpy_spec"], "f64-tree deltaH != NumPy spec bits")

    # 5. headline config: the card against the CPU, then warm medians
    Y, psi = data(HEADLINE["n"], HEADLINE["d"])
    emit("headline_parity", **HEADLINE, **headline_parity(Y, psi, HEADLINE["k"]))
    flow_pass(Y, psi, HEADLINE["k"])
    passes = [flow_pass(Y, psi, HEADLINE["k"])[0] for _ in range(5)]
    emit("headline", **HEADLINE, passes=len(passes), **medians(passes))

    # 6. corpus scale, gather path (K1): the launch counts of its last pass
    Y, psi = data(CORPUS["n"], CORPUS["d"])
    flow_pass(Y, psi, CORPUS["k"])
    passes = [flow_pass(Y, psi, CORPUS["k"])[0] for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t, lat, settle_launches = flow_pass(Y, psi, CORPUS["k"])
    t0 = time.perf_counter()
    lat.set_receipt_detail("full")
    rec = lat.receipt()
    t["receipt_full_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    bundle = lat.bundle(k=8)
    chain = lat.chain_receipt([2, 5, 7, 9])
    t["bundle_chain_ms"] = sync_ms(t0)
    counts = read_counts()
    launches = counts["K1"]
    peak = torch.cuda.max_memory_allocated()
    passes.append(t)
    settle_it, ustar_it = lat.last["iters"], rec["meta"]["ustar_iters"]
    applies = (settle_it + 1) + (ustar_it + 1) + 2  # r0 + one per iteration; 2 receipts
    U = lat.U
    del lat
    emit("corpus", **CORPUS, passes=len(passes), **medians(passes), last_pass=t,
         settle_iters=settle_it, ustar_iters=ustar_it, spmv_launches=launches,
         operator_applies=applies, settle_launches=settle_launches, launches=counts,
         host_syncs_per_settle=settle_it,
         max_memory_allocated_bytes=peak, deltaH=rec["deltaH_total"],
         null_points=len(rec["null_points"]), bundle_ids=[b["id"] for b in bundle],
         chain_verdict=chain["verdict"])
    check(launches > 0, "K1 was not launched on the main path")
    check(launches == applies, f"K1 launches {launches} != operator applies {applies}")
    check(settle_launches == settle_it + 1,
          f"K1 launches in settle {settle_launches} != r0 + {settle_it} iterations")
    check(U.shape == (CORPUS["n"], CORPUS["d"]) and bool(np.isfinite(U).all()), "U not finite")
    check(np.isfinite(rec["deltaH_total"]) and rec["deltaH_total"] >= 0, "deltaH invalid")
    check(len(bundle) == 8 and len({b["id"] for b in bundle}) == 8, "bundle ids invalid")

    # 7. K1 timing at the main path's shapes
    rows = [time_kernel(HEADLINE, cases["headline"]), time_kernel(CORPUS, cases["corpus"])]
    main_row = rows[1]
    k1_err = max(c["err"] for c in cases.values())
    del cases
    torch.cuda.empty_cache()

    # 8. windowed corpus: the full-width windowed main path through K4
    win_launches = {"K4": windowed_corpus()}

    # 9. windowed stragglers: a low-coverage clustered corpus through K4
    # (fused) and K3 (OSCILLINK_WINDOWED_FUSED=0), each held to the CPU
    Y, psi = clustered_corpus(STRAGGLERS["n"], STRAGGLERS["d"])
    with env(OSCILLINK_WINDOWED_MATVEC="1", OSCILLINK_WINDOWED_FUSED="1"):
        card_vs_cpu("windowed_stragglers_fused", Y, psi, STRAGGLERS["k"], "K4")
    with env(OSCILLINK_WINDOWED_MATVEC="1", OSCILLINK_WINDOWED_FUSED="0"):
        win_launches["K3"] = card_vs_cpu(
            "windowed_stragglers_unfused", Y, psi, STRAGGLERS["k"], "K3")[0]["launches"]

    # 10. narrow D: a D = 97 lattice routes to K2 and the straggler epilogue;
    # two applies on the card must be bit-equal (no atomics in the epilogue)
    Y, psi = clustered_corpus(NARROW["n"], NARROW["d"])
    with env(OSCILLINK_WINDOWED_MATVEC="1"):
        run, lat = card_vs_cpu("windowed_narrow_d", Y, psi, NARROW["k"], "K2")
        win_launches["K2"] = run["launches"]
        ctx = lat._window_ctx
        Xp = tw.pad_rows(lat._U_dev.index_select(0, ctx.order.long()), ctx.plan.n_pad)
        first = tw.lap_matvec_windowed(ctx.plan, ctx.oh, Xp, W=ctx.W, s_max=ctx.s_max)
        second = tw.lap_matvec_windowed(ctx.plan, ctx.oh, Xp, W=ctx.W, s_max=ctx.s_max)
        torch.cuda.synchronize()
        check(torch.equal(first, second), "K2 + epilogue differs from run to run")
        emit("windowed_narrow_d_repeat", bit_equal=True)
        del lat, ctx, Xp, first, second

    print(json.dumps({"kernels": [{
        "name": "spmv_gather",
        "route": "cuda",
        "source": "oscillink_tpu_torch/csrc/spmv.cu",
        "replaces": "oscillink_tpu/ops/pallas/spmv.py:43",
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "N=131072 D=768 K=8",
        "launches_per_settle": settle_launches,
        "gather_ceiling_ms": main_row["gather_ceiling_ms"],
        "per_shape": rows,
    }] + [{
        "name": kname,
        "route": "cuda",
        "source": WINDOW_SOURCE,
        "replaces": replaces,
        "launches": win_launches[key],
        "max_abs_err": win_errs[key],
        **win_timing["rows"][key],
        "shape": "bench graph N=131072 (Npad 131328) D=768 K=8, W=R=384, 3 windows, bf16x3",
        "k1_same_graph_ms": win_timing["k1_ms"],
        "gather_plain_max_abs_err": win_errs[f"{key}_gather"],
        **({"pap_max_abs_err": win_errs["K4_pap"],
            "gather_plain_pap_max_abs_err": win_errs["K4_gather_pap"]} if key == "K4" else {}),
    } for key, kname, _, replaces in WINDOW_KERNELS] + [k5_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
