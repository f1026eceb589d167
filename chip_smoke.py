"""Smoke run of the PyTorch port on one CUDA card (an H100 for this port).

    python3 chip_smoke.py

Builds kernel K1 (``oscillink_tpu_torch/csrc/spmv.cu``) from the checkout,
holds it against its plain PyTorch version, drives the lattice's main path
(build -> settle -> U* -> receipt -> bundle / chain_receipt) through the
public entry points, and times each phase and the kernel.  Every check that
fails raises, so the script exits non-zero; it never falls back to the CPU.
Without CUDA it exits 1 before printing any result.

Output: the card's name and power limit (as nvidia-smi reports them), one
JSON line per phase, the ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
from oscillink_tpu_torch.ops.graph import build_graph, lap_matvec
from oscillink_tpu_torch.ops.kernels import build as kbuild
from oscillink_tpu_torch.ops.kernels import spmv
from oscillink_tpu_torch.ops import receipts as treceipts
from oscillink_tpu_torch.ops.path import build_path_graph
from oscillink_tpu_torch.ops.receipts import deltaH_tree_np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TOL = 1e-5  # kernel vs plain: same K order, the gap is FMA contraction only

QUICK = dict(n=120, d=128, k=6, chain=[2, 5, 7, 9], lamP=0.2)
HEADLINE = dict(n=5000, d=128, k=6)  # bench.py's workload
CORPUS = dict(n=131072, d=768, k=8)  # the 100k-131k x 768 x k8 corpus tier
RAGGED = dict(n=4099, d=97, k=5)
K_ONE = dict(n=333, d=130, k=1)
K_WIDE = dict(n=1000, d=64, k=40)  # more neighbours than one warp's 32 lanes


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


def csr_of(g, n: int) -> torch.Tensor:
    """(I - Wn) as a CSR matrix: the library yardstick computes K1's function
    with one torch.sparse.mm call."""
    dev = g.idx.device
    k = g.k_max
    cols = torch.cat([torch.arange(n, device=dev)[:, None], g.idx.long()], dim=1)
    vals = torch.cat([torch.ones(n, 1, device=dev), -g.wn], dim=1)
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
    A = csr_of(g, n)
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

    # 1. build K1 from the checkout's source
    t0 = time.perf_counter()
    kbuild.load_library("spmv")
    build_s = time.perf_counter() - t0
    log = kbuild._target("spmv")[1].with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit("build", seconds=build_s, library=log.with_suffix(".so").name, ptxas=ptxas)

    # 2. K1 against its plain version on graphs built by the port
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for name, shape in (("headline", HEADLINE), ("corpus", CORPUS), ("ragged", RAGGED),
                        ("k_one", K_ONE), ("k_wide", K_WIDE)):
        cases[name] = kernel_vs_plain(shape, gen)

    # 3. quickstart: the card against the port's own CPU path
    gpu, cpu = quickstart("cuda"), quickstart("cpu")
    rel = abs(gpu["deltaH"] - cpu["deltaH"]) / max(abs(cpu["deltaH"]), 1e-30)
    emit("quickstart", cuda=gpu, cpu=cpu, deltaH_rel=rel)
    check(rel <= 1e-5, f"quickstart deltaH differs: {rel}")
    for key in ("nulls", "verdict", "bundle", "state_sig", "settle_iters", "ustar_iters"):
        check(gpu[key] == cpu[key], f"quickstart {key}: cuda {gpu[key]} vs cpu {cpu[key]}")
    for run in (gpu, cpu):
        check(run["deltaH_f64_tree_bits_equal_numpy_spec"], "f64-tree deltaH != NumPy spec bits")

    # 4. headline config: the card against the CPU, then warm medians
    Y, psi = data(HEADLINE["n"], HEADLINE["d"])
    emit("headline_parity", **HEADLINE, **headline_parity(Y, psi, HEADLINE["k"]))
    flow_pass(Y, psi, HEADLINE["k"])
    passes = [flow_pass(Y, psi, HEADLINE["k"])[0] for _ in range(5)]
    emit("headline", **HEADLINE, passes=len(passes), **medians(passes))

    # 5. corpus scale: the main path with the launch count of its last pass
    Y, psi = data(CORPUS["n"], CORPUS["d"])
    flow_pass(Y, psi, CORPUS["k"])
    passes = [flow_pass(Y, psi, CORPUS["k"])[0] for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    spmv.launches = 0
    t, lat, settle_launches = flow_pass(Y, psi, CORPUS["k"])
    t0 = time.perf_counter()
    lat.set_receipt_detail("full")
    rec = lat.receipt()
    t["receipt_full_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    bundle = lat.bundle(k=8)
    chain = lat.chain_receipt([2, 5, 7, 9])
    t["bundle_chain_ms"] = sync_ms(t0)
    launches = spmv.launches
    peak = torch.cuda.max_memory_allocated()
    passes.append(t)
    settle_it, ustar_it = lat.last["iters"], rec["meta"]["ustar_iters"]
    applies = (settle_it + 1) + (ustar_it + 1) + 2  # r0 + one per iteration; 2 receipts
    U = lat.U
    emit("corpus", **CORPUS, passes=len(passes), **medians(passes), last_pass=t,
         settle_iters=settle_it, ustar_iters=ustar_it, spmv_launches=launches,
         operator_applies=applies, settle_launches=settle_launches,
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

    # 6. K1 timing at the main path's shapes
    rows = [time_kernel(HEADLINE, cases["headline"]), time_kernel(CORPUS, cases["corpus"])]
    main_row = rows[1]
    print(json.dumps({"kernels": [{
        "name": "spmv_gather",
        "route": "cuda",
        "source": "oscillink_tpu_torch/csrc/spmv.cu",
        "replaces": "oscillink_tpu/ops/pallas/spmv.py:43",
        "launches": launches,
        "max_abs_err": max(c["err"] for c in cases.values()),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "N=131072 D=768 K=8",
        "launches_per_settle": settle_launches,
        "gather_ceiling_ms": main_row["gather_ceiling_ms"],
        "per_shape": rows,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
