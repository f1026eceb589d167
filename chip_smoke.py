"""Smoke run of the PyTorch port on one CUDA card (an H100 for this port).

    python3 chip_smoke.py

Builds kernels K1 (``oscillink_tpu_torch/csrc/spmv.cu``), K2, K3 and K4
(``csrc/window_spmv3f.cu``, three variants of one gather kernel) and K5
(``csrc/bucket_gather.cu``) from the checkout, one ``nvcc`` per source, all
started together, and holds each against its plain PyTorch version (K1
also bit-equal from launch to launch and across forced column-slab widths,
and its slab widths swept and timed in turns at the corpus shape; K2-K4
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
  probe_bucket_gather``) at its full size, 126976 x 768 with 1015808 edges;
* the multi-query serving paths, all through K1 (held to its plain version
  at their widths first: D = 1, 16, 3, the ragged union graph and Q·D =
  6144): the batched lattice (``solve_Ustar_batch``, ``bundle_batch``)
  against the port's CPU path; the /v1/bundle batch path at the corpus
  (``diffusion_gates_batch``, ``bundle_batch`` for 8 queries) against the 8
  single solves; standalone diffusion gates (dense direct and CG) and the
  corpus lattice's ``diffusion_gates`` against the CPU; ``bundle_ragged``
  at the /v1/bundle/ragged shape against each corpus served alone; and the
  one-shot light receipt against the lattice's.  Each solve's K1 launches
  must equal 1 + its slowest lane's iterations;
* ``similarity="auto"``, the service's default, all through K1: the bf16
  scan's routes held to f64 and timed; at 131072 x 768 x k8 auto resolves
  to the fast scan, held to the exact graph of the same run (``"fastest"``
  and ``rebuild_graph(similarity="fast")`` give its bits); the blocked fast
  path (16384 x 768), the IVF build (65536 x 128) and the seeded host build
  (8192 x 128) each against the port's CPU path; the cluster tier at 524288
  x 768 x k8, accepted as IVF on the JAX package's loose study corpus, its
  tight corpus and an isotropic one built too; export and import (JSON
  state, NPZ) on the card against the CPU;
* the low-memory and column-chunked solves at the JAX package's 1M study
  shape (``million``: 1,000,000 x 768 x k8 on its loose IVF corpus, auto
  resolving to an accepted IVF build): the full flow full width, then
  settle, U* and the full receipt on the same graph under
  ``OSCILLINK_COL_CHUNKS`` = 4 and 8, held to the full-width run with the
  JAX package's bars; the classic and the low-memory CG on the same
  inputs (identical iterations, U within 1e-6 of max|U|); every step's
  peak under the working-set model's estimate, and its K1 launches equal
  to its operator applies; K1 against plain at the chunk widths 192 and
  96;
* the windowed tier under column chunks (``windowed_chunked``): the
  locality-ordered corpus at c = 2 (K4 fused, K3 unfused, at 384 columns)
  and c = 8 (K2 and its epilogue at 96) against the full-width windowed
  run, the kernels against their plain versions at those widths, and the
  straggler corpus card against CPU at each.

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
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from oscillink_tpu_torch import Oscillink, compute_diffusion_gates
from oscillink_tpu_torch.benchmarks import probe_bucket_gather as probe
from oscillink_tpu_torch.core import lattice as tlattice
from oscillink_tpu_torch.core.lattice import _locality_order
from oscillink_tpu_torch.models import coherence as tcoh
from oscillink_tpu_torch.models import ragged as tragged
from oscillink_tpu_torch.models.batched import union_graph
from oscillink_tpu_torch.models.oneshot import settle_receipt_light
from oscillink_tpu_torch.preprocess.diffusion import diffusion_sources, screened_solve
from oscillink_tpu_torch.ops import graph as tgraph
from oscillink_tpu_torch.ops import ivf as tivf
from oscillink_tpu_torch.ops.graph import build_graph, graph_from_topk, lap_matvec, normalize_rows
from oscillink_tpu_torch.ops.kernels import bucket_gather as bg
from oscillink_tpu_torch.ops.kernels import build as kbuild
from oscillink_tpu_torch.ops.kernels import spmv
from oscillink_tpu_torch.ops.kernels import window_spmv as tw
from oscillink_tpu_torch.ops import receipts as treceipts
from oscillink_tpu_torch.ops.path import build_path_graph
from oscillink_tpu_torch.ops.receipts import deltaH_tree_np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
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
# K1's slab widths swept at the corpus shape, beside D (the whole-row walk)
SLAB_SWEEP = (16, 32, 64)
# forced slab widths held to the plan's bits at the small K1 shapes: 1-32
# lanes a row, widths that leave a ragged last slab, odd widths on float4 rows
SLAB_CHECK = (1, 2, 3, 4, 5, 8, 12, 16, 20, 32, 33, 64, 100)
# K5: the probe's check shape, and D = 97 (the scalar path) with e_pad = ETILE
K5_SHAPES = (("check", 2, 128, 2 * bg.ETILE), ("ragged", 3, 97, bg.ETILE))
PROBE_D = 768  # the probe's full width; its 31 buckets are probe_tensors' default
# the multi-query serving paths: the batched lattice against the CPU, the
# /v1/bundle batch path at the corpus tier (Q queries), the standalone
# diffusion gates (dense direct at N <= 4096, CG above), the
# /v1/bundle/ragged shape and the one-shot light receipt
BATCH_PARITY = dict(n=2000, d=128, k=6, q=6)
BATCH_Q = 8
DIFF_DIRECT = dict(n=4096, d=128, k=6)
DIFF_CG = dict(n=5000, d=128, k=6)
RAGGED_BATCH = dict(corpora=32, n_min=200, n_max=4000, d=768, k=6, bundle_k=8)
LANE_TOL = 1e-5  # batch vs single, card vs CPU: relative to max|U|, or absolute on gates
RAGGED_REL, RAGGED_ABS = 1e-3, 1e-4  # tests/test_ragged.py:41-44
# similarity="auto": the blocked fast path held to the CPU (auto forced to
# "fast" above 8192 rows), the cluster tier (the tight IVF study corpus), the
# IVF build held to the CPU at the default geometry (C = 1024, P = 128), and
# the row-blocked seeded host build
FAST_PARITY = dict(n=16384, d=768, k=8, fast_sim_n=8192)
CLUSTER = dict(n=524288, d=768, k=8, centres=1024, spread=0.6)
TIGHT_SPREAD = 0.35
IVF_PARITY = dict(n=65536, d=128, k=8, centres=2048)
SEEDED = dict(n=8192, d=128, k=8, seed=3)
# the low-memory and column-chunked solves: the JAX package's 1M IVF study
# shape on its "loose" corpus (benchmarks/ivf_balanced_1m.json's config),
# full width and at the chunk counts the 16 GB chip needed; the windowed
# tier chunked on the locality-ordered corpus and the straggler corpus
MILLION = dict(n=1_000_000, d=768, k=8, centres=1024, spread=0.6)
MILLION_CHUNKS = (4, 8)
FORM_TURNS = 3
FORM_TOL = 1e-6  # classic vs low-memory CG: U relative to max|U|
CHUNK_DH_REL, CHUNK_SUM_REL = 1e-5, 1e-4  # tests/test_chunked_receipts.py:65-91
WINDOWED_CHUNK_TOL = 5e-4  # U*, relative to max|U| (tests/test_window_spmv.py:189)
# (OSCILLINK_COL_CHUNKS, OSCILLINK_WINDOWED_FUSED, the kernel the chunk width takes)
WINDOWED_CHUNKED = (("2", "1", "K4"), ("2", "0", "K3"), ("8", "1", "K2"))


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
    version on the same inputs, and hold them together; a second launch must
    give the same bits."""
    dev = torch.device("cuda")
    n, d, k = shape["n"], shape["d"], shape["k"]
    Y = torch.randn(n, d, generator=gen, device=dev)
    g = build_graph(Y, k)
    X = torch.randn(n, d, generator=gen, device=dev)
    out, again = lap_matvec(g, X), lap_matvec(g, X)
    ref = spmv.lap_matvec_ref(g.idx, g.wn, X)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()), f"K1 output not finite at {shape}")
    check(torch.allclose(out, ref, rtol=TOL, atol=TOL), f"K1 != plain at {shape}: {err}")
    check(torch.equal(out, again), f"K1 differs from launch to launch at {shape}")
    # below the corpus size, forced slab widths (every lane count, ragged last
    # slabs, scalar slabs on a float4 row) must give the plan's bits
    widths = [w for w in SLAB_CHECK if w < d] if n * d < 10_000_000 else []
    for w in widths:
        check(torch.equal(spmv.lap_matvec_cuda(g.idx, g.wn, X, slab_cols=w), out),
              f"K1 at slab_cols={w} differs from the plan's width at {shape}")
    emit("kernel_vs_plain", **shape, slab_cols=k1_slab_cols(n, d, k), max_abs_err=err, tol=TOL,
         bit_equal_repeat=True, bit_equal_slab_cols=widths)
    return {"g": g, "X": X, "err": err}


def k1_slab_cols(n: int, d: int, k: int) -> int:
    """K1's slab width on this card at [n, d] with k slots (the main path's)."""
    return spmv.slab_plan(n, d, k, spmv.device_l2_bytes(0))


def turns_ms(calls: dict, reps: int) -> dict:
    """Each callable timed by `cuda_ms` in turns, forward then backward
    (a, b, ..., b, a); the two readings of each, in that order."""
    order = list(calls) + list(reversed(calls))
    out = {key: [] for key in calls}
    for key in order:
        out[key].append(cuda_ms(calls[key], reps))
    return out


def k1_slab_sweep(shape: dict, case: dict) -> dict:
    """K1 at ``shape`` with each slab width of SLAB_SWEEP and the plan's, the
    widths timed in turns on this card; each output must equal the plan's
    bit for bit (slabbing changes no element's arithmetic).  S = D is the
    whole-row walk of the kernel's first design.  Beside them, the same walk
    with one slot a row that reads the row itself: what reading X and
    writing out in slabs costs without the gathers."""
    g, X = case["g"], case["X"]
    n, d, k = shape["n"], shape["d"], shape["k"]
    plan = k1_slab_cols(n, d, k)
    widths = sorted({*(w for w in SLAB_SWEEP if w < d), d, plan})
    ref = spmv.lap_matvec_cuda(g.idx, g.wn, X)
    for w in widths:
        out = spmv.lap_matvec_cuda(g.idx, g.wn, X, slab_cols=w)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"K1 at slab_cols={w} != the plan's ({plan}) at {shape}")
        del out
    del ref
    times = turns_ms({w: (lambda w=w: spmv.lap_matvec_cuda(g.idx, g.wn, X, slab_cols=w))
                      for w in widths}, 20)
    # the access pattern's own cost: one slot a row reading the row itself
    # (no gather traffic), at the plan's width and at S = D
    own = torch.arange(n, dtype=torch.int32, device=X.device)[:, None].contiguous()
    zero = torch.zeros(n, 1, device=X.device)
    stream = turns_ms({w: (lambda w=w: spmv.lap_matvec_cuda(own, zero, X, slab_cols=w))
                       for w in (plan, d)}, 20)
    row = {"plan_slab_cols": plan, "l2_bytes": spmv.device_l2_bytes(0),
           "l2_budget_bytes": spmv.l2_budget(spmv.device_l2_bytes(0)),
           "ms": {str(w): statistics.mean(t) for w, t in times.items()},
           "turns_ms": {str(w): t for w, t in times.items()}, "bit_equal_to_plan": True,
           "stream_only_ms": {str(w): statistics.mean(t) for w, t in stream.items()}}
    emit("k1_slab_sweep", **shape, **row)
    return row


def k1_ptxas(report: dict) -> dict:
    """K1's entries of a `ptxas_report`, keyed by vector type and lanes a row."""
    out = {}
    for key, val in report.items():
        m = re.search(r"spmv_gather_kernelI(6float4|f)Li(\d+)E", key)
        if m:
            out[f"{'float4' if m.group(1) == '6float4' else 'float'},G={m.group(2)}"] = val
    return out


def ptxas_report(log_text: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, keyed by its mangled name."""
    out: dict = {}
    name = None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


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
    the same operator as a CSR matrix, and K1 on the same graph (at its
    plan's slab width and at S = D, in turns)."""
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
    # K1 on the same graph at its plan's slab width and at S = D (the
    # whole-row walk), in turns; the two must give the same bits
    d = X.shape[1]
    k1_full = spmv.lap_matvec_cuda(case["idx"], case["wn"], X, slab_cols=d)
    torch.cuda.synchronize()
    check(torch.equal(k1_out, k1_full), "K1 on the bench graph: the plan's slabs != S = D")
    del k1_full
    k1_turns = turns_ms({
        "plan": lambda: spmv.lap_matvec_cuda(case["idx"], case["wn"], X),
        "full_width": lambda: spmv.lap_matvec_cuda(case["idx"], case["wn"], X, slab_cols=d),
    }, 20)
    k1_ms = statistics.mean(k1_turns["plan"])
    k1_err = float((k1_out - k3_out).abs().max())
    rows = {}
    for name, (kern, plain, gather) in window_calls(case, "bf16x3").items():
        rows[name] = {
            "ms": cuda_ms(kern, 50), "plain_ms": cuda_ms(plain, 3),
            "gather_plain_ms": cuda_ms(gather, 3), **window_bound(case, name),
            "library_ms": library_ms,
        }
    emit("window_timing", **case["info"], tier="bf16x3", k1_same_graph_ms=k1_ms,
         k1_slab_cols=k1_slab_cols(n, d, case["info"]["k"]), k1_turns_ms=k1_turns,
         k1_vs_k3_max_abs=k1_err, library_vs_k3_max_abs=lib_err, nnz=case["nnz"], **rows)
    return {"rows": rows, "k1_ms": k1_ms,
            "k1_full_width_ms": statistics.mean(k1_turns["full_width"])}


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


# -- the multi-query serving paths (kernel K1 at their shapes) -------------------


def queries(Y: np.ndarray, q: int) -> np.ndarray:
    """Q query vectors: the normalized means of rows 32i .. 32i + 31."""
    m = Y[: 32 * q].reshape(q, 32, -1).mean(axis=1)
    return (m / (np.linalg.norm(m, axis=1, keepdims=True) + 1e-12)).astype(np.float32)


def k1_device_ms(g, X, reps: int = 50) -> float:
    """K1's own device time per launch at (g, X), separated from the host's
    per-call cost, which bounds back-to-back calls of a small apply: CUDA
    events around ``reps`` launches queued behind a spin kernel, so the
    card runs them back to back and the span holds every launch.  Fails
    if the host had not queued them all before the spin ended."""
    spmv.lap_matvec_cuda(g.idx, g.wn, X)
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    torch.cuda._sleep(50_000_000)  # about 25 ms at the H100's clocks
    marks[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        spmv.lap_matvec_cuda(g.idx, g.wn, X)
    host_ms = 1000.0 * (time.perf_counter() - t0)
    marks[2].record()
    torch.cuda.synchronize()
    spin_ms = marks[0].elapsed_time(marks[1])
    check(host_ms < spin_ms, f"K1 device time: queuing took {host_ms} ms, the spin {spin_ms} ms")
    return marks[1].elapsed_time(marks[2]) / reps


def k1_case(shape: dict, g, X) -> dict:
    """K1 against its plain version on (g, X), rtol/atol TOL and bit-equal
    from launch to launch; then `time_kernel`'s times and bytes bound, and
    the kernel's own device time back to back (`k1_device_ms`)."""
    out, again = lap_matvec(g, X), lap_matvec(g, X)
    ref = spmv.lap_matvec_ref(g.idx, g.wn, X)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()), f"K1 output not finite at {shape}")
    check(torch.allclose(out, ref, rtol=TOL, atol=TOL), f"K1 != plain at {shape}: {err}")
    check(torch.equal(out, again), f"K1 differs from launch to launch at {shape}")
    del out, again, ref
    n, k = g.idx.shape
    row = time_kernel({**shape, "n": n, "d": X.shape[1], "k": k,
                       "slab_cols": k1_slab_cols(n, X.shape[1], k)}, {"g": g, "X": X, "err": err})
    return {**row, "device_ms": k1_device_ms(g, X)}


def ragged_inputs() -> tuple[list, list]:
    """The /v1/bundle/ragged shape: corpora of N_i spread evenly from n_min
    to n_max, Gaussian rows (`data`), one query each."""
    r = RAGGED_BATCH
    sizes = np.linspace(r["n_min"], r["n_max"], r["corpora"]).astype(int)
    pairs = [data(int(n), r["d"], seed=100 + i) for i, n in enumerate(sizes)]
    return [Y for Y, _ in pairs], [p for _, p in pairs]


def ragged_union(corpora: list, k: int):
    """The union graph `bundle_ragged` builds for one k-group on the card:
    corpora zero-padded to its bucket, each graph built alone."""
    n_pad = -(-max(len(c) for c in corpora) // tragged._BUCKET) * tragged._BUCKET
    Ys = torch.zeros((len(corpora), n_pad, corpora[0].shape[1]), device="cuda")
    for i, c in enumerate(corpora):
        Ys[i, : len(c)] = torch.from_numpy(c).cuda()
    return union_graph([build_graph(Y, k) for Y in Ys])


def k1_narrow(corpus_g, ragged_g) -> list:
    """K1 at the serving paths' new widths: the corpus graph at D = 1 (one
    diffusion solve), D = BATCH_Q (the batched diffusion solve) and D = 16,
    the 4099-row graph at D = 3, and the ragged phase's union graph at
    D = 768."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for graph, g, d in (("corpus", corpus_g, 1), ("corpus", corpus_g, BATCH_Q),
                        ("corpus", corpus_g, 16), ("ragged_4099", ragged_g, 3)):
        X = torch.randn(g.n_nodes, d, generator=gen, device="cuda")
        rows.append(k1_case({"graph": graph}, g, X))
    gu = ragged_union(ragged_inputs()[0], RAGGED_BATCH["k"])
    X = torch.randn(gu.n_nodes, RAGGED_BATCH["d"], generator=gen, device="cuda")
    rows.append(k1_case({"graph": "ragged_union"}, gu, X))
    emit("k1_narrow", rows=rows, tol=TOL, bit_equal_repeat=True)
    return rows


def batched_parity() -> dict:
    """`solve_Ustar_batch` and `bundle_batch` on the card, launch counts set
    to 0 just before and read just after, against the port's CPU path on
    the card's graph: identical per-query iterations and bundle ids, U*
    within LANE_TOL of max|U|.  Two of the queries carry gates in [0, 1],
    so the lanes stop at different counts."""
    n, d, k, q = (BATCH_PARITY[key] for key in ("n", "d", "k", "q"))
    Y, _ = data(n, d, seed=3)
    psis = queries(Y, q)
    rng = np.random.default_rng(3)
    gates = np.ones((q, n), dtype=np.float32)
    gates[1], gates[4] = rng.random(n), rng.random(n)
    lat = Oscillink(Y, kneighbors=k)
    reset_counts()
    t0 = time.perf_counter()
    U = lat.solve_Ustar_batch(psis, gates)
    ustar_ms = sync_ms(t0)
    iters = lat.last_ustar_batch["iters"]
    t0 = time.perf_counter()
    bundles = [[b["id"] for b in qb] for qb in lat.bundle_batch(psis, gates, k=8)]
    bundle_ms = sync_ms(t0)
    counts = read_counts()
    bundle_iters = lat.last_ustar_batch["iters"]
    cpu = Oscillink(Y, kneighbors=k, device="cpu", graph=lat.graph)
    U_cpu = cpu.solve_Ustar_batch(psis, gates)
    cpu_iters = cpu.last_ustar_batch["iters"]
    cpu_bundles = [[b["id"] for b in qb] for qb in cpu.bundle_batch(psis, gates, k=8)]
    err = float(np.abs(U - U_cpu).max())
    scale = float(np.abs(U_cpu).max())
    emit("batched_parity", **BATCH_PARITY, iters=iters, cpu_iters=cpu_iters, launches=counts,
         max_abs_err=err, max_abs_U=scale, ustar_ms=ustar_ms, bundle_ms=bundle_ms,
         bundle_ids=bundles)
    check(U.shape == (q, n, d) and bool(np.isfinite(U).all()), "batched U* invalid")
    check(len(set(iters)) > 1, f"the batch's lanes all stopped together: {iters}")
    check(iters == cpu_iters, f"batched iterations: cuda {iters} vs cpu {cpu_iters}")
    check(bundle_iters == iters, f"bundle_batch iterations {bundle_iters} != U* batch {iters}")
    check(err <= LANE_TOL * scale, f"batched U*: cuda vs cpu {err} > {LANE_TOL} * {scale}")
    check(bundles == cpu_bundles, "batched bundle ids: cuda != cpu")
    check(counts["K1"] == 2 * (1 + max(iters)),
          f"K1 launches {counts['K1']} != 2 solves x (1 + {max(iters)})")
    return {"launches": counts["K1"], "iters": iters}


def batched_corpus() -> dict:
    """The /v1/bundle batch path at the corpus tier: the corpus lattice,
    `diffusion_gates_batch` and `bundle_batch` for BATCH_Q queries, each
    timed to a sync with the launch counts set to 0 just before it; U* of
    the batch (`solve_Ustar_batch`) against the Q single solves on the card
    (identical iterations, U* within LANE_TOL of max|U|, identical bundle
    ids); the single diffusion solve (K1 at D = 1) against the CPU on the
    card's graph; then K1 at the batch's [N, Q·D] width."""
    n, d, k = CORPUS["n"], CORPUS["d"], CORPUS["k"]
    Y, _ = data(n, d)
    psis = queries(Y, BATCH_Q)
    t = {}
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k)
    t["build_ms"] = sync_ms(t0)
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    G = lat.diffusion_gates_batch(psis)
    t["gates_ms"] = sync_ms(t0)
    launches["gates"] = read_counts()["K1"]
    gate_iters = lat.last_gates["iters"]
    reset_counts()
    t0 = time.perf_counter()
    U = lat.solve_Ustar_batch(psis, G)
    t["ustar_ms"] = sync_ms(t0)
    launches["ustar"] = read_counts()["K1"]
    peak = torch.cuda.max_memory_allocated()
    iters = lat.last_ustar_batch["iters"]
    reset_counts()
    t0 = time.perf_counter()
    bundles = [[b["id"] for b in qb] for qb in lat.bundle_batch(psis, G, k=8)]
    t["bundle_ms"] = sync_ms(t0)
    launches["bundle"] = read_counts()["K1"]
    bundle_iters = lat.last_ustar_batch["iters"]
    check(U.shape == (BATCH_Q, n, d) and bool(np.isfinite(U).all()), "corpus batch U* invalid")
    # the single-query path, one query at a time
    single_ms, single_iters, errs = [], [], []
    for qi in range(BATCH_Q):
        t0 = time.perf_counter()
        lat.set_query(psis[qi], gates=G[qi])
        Uq = lat._solve_ustar_device()
        ids = [b["id"] for b in lat.bundle(k=8)]
        single_ms.append(sync_ms(t0))
        single_iters.append(lat.last_ustar["iters"])
        errs.append(float((torch.from_numpy(U[qi]).cuda() - Uq).abs().max() / Uq.abs().max()))
        check(ids == bundles[qi], f"corpus batch bundle {qi}: {bundles[qi]} vs single {ids}")
    del U, Uq
    # every lane of the batched gates against its single diffusion solve on
    # the card (K1 at D = 1): gates within LANE_TOL, identical iterations
    gates_single_ms, single_gate_iters, lane_errs, gate_launches = [], [], [], []
    for qi in range(BATCH_Q):
        reset_counts()
        t0 = time.perf_counter()
        h = lat.diffusion_gates(psis[qi])
        gates_single_ms.append(sync_ms(t0))
        gate_launches.append(read_counts()["K1"])
        single_gate_iters.append(lat.last_gates["iters"])
        lane_errs.append(float(np.abs(h - G[qi]).max()))
        if qi == 0:
            h0 = h
    t["gates_single_ms"] = gates_single_ms
    launches["gates_single"] = gate_launches
    # one single solve against the CPU on the card's graph
    cpu = Oscillink(Y, kneighbors=k, device="cpu", graph=lat.graph)
    h_cpu = cpu.diffusion_gates(psis[0])
    cpu_gate_iters = cpu.last_gates["iters"]
    del cpu
    gate_err = float(np.abs(h0 - h_cpu).max())
    emit("batched_corpus", **CORPUS, queries=BATCH_Q, **t, single_query_ms=single_ms,
         batch_ms_per_query=(t["gates_ms"] + t["bundle_ms"]) / BATCH_Q,
         single_ms_per_query=statistics.mean(single_ms), max_memory_allocated_bytes=peak,
         iters=iters, single_iters=single_iters, gate_iters=gate_iters,
         single_gate_iters=single_gate_iters, cpu_gate_iters=cpu_gate_iters, launches=launches,
         U_rel_err=errs, gates_cuda_vs_cpu=gate_err, gates_batch_vs_single=lane_errs,
         bundle_ids=bundles)
    check(iters == single_iters, f"corpus batch iterations {iters} != single {single_iters}")
    check(bundle_iters == iters, f"bundle_batch iterations {bundle_iters} != U* batch {iters}")
    check(max(errs) <= LANE_TOL, f"corpus batch U* vs single: {max(errs)}")
    check(gate_iters == single_gate_iters,
          f"corpus gate iterations: batch {gate_iters} != single {single_gate_iters}")
    check(launches["gates"] == 1 + max(gate_iters),
          f"K1 launches in the batched gates {launches['gates']} != 1 + {max(gate_iters)}")
    check(launches["ustar"] == 1 + max(iters),
          f"K1 launches in the batched U* {launches['ustar']} != 1 + {max(iters)}")
    check(launches["bundle"] == 1 + max(iters),
          f"K1 launches in bundle_batch {launches['bundle']} != 1 + {max(iters)}")
    check(gate_launches == [1 + it for it in single_gate_iters],
          f"K1 launches in the single gate solves {gate_launches} != 1 + {single_gate_iters}")
    check(cpu_gate_iters == single_gate_iters[0],
          f"corpus gate iterations: cuda {single_gate_iters[0]} vs cpu {cpu_gate_iters}")
    check(gate_err <= LANE_TOL, f"corpus diffusion gates: cuda vs cpu {gate_err}")
    check(max(lane_errs) <= LANE_TOL,
          f"corpus diffusion gates: batch lanes vs single solves {lane_errs}")
    # K1 at the batch's width: the [N, Q·D] view of the solve's blocks
    gen = torch.Generator(device="cuda").manual_seed(4)
    X = torch.randn(n, BATCH_Q * d, generator=gen, device="cuda")
    row = k1_case({"graph": "corpus", "queries": BATCH_Q}, lat.graph, X)
    del lat, X
    torch.cuda.empty_cache()
    return {"launches": launches, "k1_row": row, "ms": t}


def diffusion_standalone() -> dict:
    """`compute_diffusion_gates` on the card against the CPU: dense direct
    at 4096 x 128 and CG (K1 at D = 1) at 5000 x 128, after checking that
    the card's and the CPU's graph builds agree slot for slot.  Launch
    counts set to 0 just before each card run and read just after."""
    out = {}
    for shape, method in ((DIFF_DIRECT, "direct"), (DIFF_CG, "cg")):
        n, d, k = shape["n"], shape["d"], shape["k"]
        Y, psi = data(n, d, seed=5)
        g = build_graph(torch.from_numpy(Y).cuda(), k)
        cpu_idx = build_graph(torch.from_numpy(Y), k).idx.numpy()
        ties = near_tie_witness(Y, g.idx.cpu().numpy(), cpu_idx)
        check(ties["slots_differ"] == 0, f"diffusion {method}: card and CPU graphs differ: {ties}")
        compute_diffusion_gates(Y, psi, kneighbors=k, method=method)  # warm
        reset_counts()
        t0 = time.perf_counter()
        h = compute_diffusion_gates(Y, psi, kneighbors=k, method=method)
        ms = sync_ms(t0)
        k1 = read_counts()["K1"]
        h_cpu = compute_diffusion_gates(Y, psi, kneighbors=k, method=method, device="cpu")
        err = float(np.abs(h - h_cpu).max())
        iters = None
        if method == "cg":
            s = diffusion_sources(torch.from_numpy(Y).cuda(), psi[None], 1.0)[:, 0]
            iters = screened_solve(g, s, 0.1, 1e-4, 256)[1]
        out[method] = {**shape, "ms": ms, "launches": k1, "iters": iters, "max_abs_err": err}
        check(h.shape == (n,) and bool(np.isfinite(h).all()), f"diffusion {method}: gates invalid")
        check(err <= LANE_TOL, f"diffusion {method}: cuda vs cpu {err}")
        check(k1 == (0 if iters is None else 1 + iters),
              f"diffusion {method}: K1 launches {k1}, iterations {iters}")
    emit("diffusion", **out)
    return out


def ragged_phase() -> dict:
    """`bundle_ragged` at the /v1/bundle/ragged shape, launch counts set to
    0 just before and read just after, against each corpus served alone by
    a lattice on the card (tests/test_ragged.py's bar).  One k-group: its
    K1 launches are the settle's 1 + max iterations plus the U* solve's."""
    r = RAGGED_BATCH
    corpora, psis = ragged_inputs()
    kw = dict(kneighbors=r["k"], bundle_k=r["bundle_k"])
    tragged.bundle_ragged(corpora, psis, **kw)  # warm
    reset_counts()
    t0 = time.perf_counter()
    res = tragged.bundle_ragged(corpora, psis, **kw)
    ms = sync_ms(t0)
    k1 = read_counts()["K1"]
    worst = {"score_rel": 0.0, "align_rel": 0.0}
    same_iters = 0
    t0 = time.perf_counter()
    for c, p, out in zip(corpora, psis, res):
        lat = Oscillink(c, kneighbors=r["k"])
        lat.set_query(p)
        st = lat.settle(max_iters=12, tol=1e-3)
        ref = lat.bundle(k=r["bundle_k"])
        same_iters += int(st["iters"] == out["iters"])
        check([e["id"] for e in out["bundle"]] == [e["id"] for e in ref],
              f"ragged bundle of the {len(c)}-row corpus differs from serving it alone")
        for got, want in zip(out["bundle"], ref):
            for key in ("score", "align"):
                gap = abs(got[key] - want[key])
                check(gap <= max(RAGGED_REL * abs(want[key]), RAGGED_ABS),
                      f"ragged {key} of the {len(c)}-row corpus: {got[key]} vs {want[key]}")
                worst[f"{key}_rel"] = max(worst[f"{key}_rel"], gap / max(abs(want[key]), 1e-30))
    alone_ms = sync_ms(t0)
    settle_iters, ustar_iters = [o["iters"] for o in res], [o["ustar_iters"] for o in res]
    expect = (1 + max(settle_iters)) + (1 + max(ustar_iters))
    emit("ragged", **r, ms=ms, served_alone_ms=alone_ms, k_groups=1,
         launches_per_k_group=[k1], settle_iters=settle_iters, ustar_iters=ustar_iters,
         same_iters_as_alone=same_iters, worst_rel=worst)
    check(k1 == expect, f"ragged K1 launches {k1} != {expect} (two solves, 1 + max each)")
    return {"launches": k1, "ms": ms}


def oneshot_phase() -> dict:
    """`settle_receipt_light` at the headline shape, launch counts set to 0
    just before and read just after, against the lattice's light receipt on
    the card: ΔH within LATTICE_TOL, identical iterations and edge count."""
    Y, psi = data(HEADLINE["n"], HEADLINE["d"])
    k = HEADLINE["k"]
    settle_receipt_light(Y, psi, kneighbors=k)  # warm
    runs = []
    for _ in range(3):
        reset_counts()
        t0 = time.perf_counter()
        out = settle_receipt_light(Y, psi, kneighbors=k)
        runs.append(sync_ms(t0))
        k1 = read_counts()["K1"]
    lat = Oscillink(Y, kneighbors=k)
    lat.set_query(psi)
    lat.set_receipt_detail("light")
    st = lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    rec = lat.receipt()
    rel = abs(out["deltaH_total"] - rec["deltaH_total"]) / max(abs(rec["deltaH_total"]), 1e-30)
    emit("oneshot", **HEADLINE, ms=statistics.median(runs), runs_ms=runs, launches=k1,
         deltaH_rel=rel, **out)
    check(rel <= LATTICE_TOL, f"one-shot deltaH differs from the lattice's: {rel}")
    check(out["settle_iters"] == st["iters"] and out["ustar_iters"] == rec["meta"]["ustar_iters"],
          "one-shot iterations differ from the lattice's")
    check(out["edge_count"] == lat._n_edges // 2, "one-shot edge count differs")
    check(k1 == out["settle_iters"] + out["ustar_iters"] + 3,
          f"one-shot K1 launches {k1} != two solves (1 + iterations each) + deltaH")
    return {"launches": k1, "ms": statistics.median(runs)}


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


# -- similarity="auto": the fast scan, the IVF build, seeded builds, state ------


def scan_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16 scan as a TF32 matmul of the bf16 values (exact in TF32's
    10-bit mantissa), TF32 allowed inside the call only."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a.float() @ b.float().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# the ways to compute the bf16 scan with f32 sums on the card: the port's
# (`graph.scan_bf16`, a bf16 GEMM with an f32 output) and two alternatives
SCAN_ROUTES = {
    "mm_out_dtype": tgraph.scan_bf16,
    "tf32": scan_tf32,
    "f32": lambda a, b: a.float() @ b.float().T,
}


def scan_routes() -> dict:
    """The bf16 scan's routes on one corpus row block, [1024, 768] against
    all 131072 rows, each held to the f64 product of the same bf16 values
    within the f32 summation bound gamma_D (unit rows) and timed by CUDA
    events; TF32 must be off again afterwards.  The port's route
    (`graph.scan_bf16`) must be the fastest."""
    n, d = CORPUS["n"], CORPUS["d"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    Yb = normalize_rows(torch.randn(n, d, generator=gen, device="cuda")).to(torch.bfloat16)
    a = Yb[:1024]
    ref = a.double() @ Yb.double().T
    nu = d * 2.0**-24
    bound = 1.01 * nu / (1 - nu)
    # bytes: both operands read once, the f32 block written once; operations
    # at the bf16 tensor-core peak
    bytes_moved = (a.numel() + Yb.numel()) * 2 + 1024 * n * 4
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, 2.0 * 1024 * n * d / BF16_FLOPS)
    routes = {}
    for name, fn in SCAN_ROUTES.items():
        S = fn(a, Yb)
        err = float((S.double() - ref).abs().max())
        routes[name] = {"dtype": str(S.dtype), "max_abs_err": err,
                        "ms": cuda_ms(lambda fn=fn: fn(a, Yb), reps=20)}
        check(S.dtype == torch.float32, f"bf16 scan route {name} gave {S.dtype}")
        check(err <= bound, f"bf16 scan route {name}: {err} > {bound}")
        del S
    emit("bf16_scan_routes", shape=f"[1024, {d}] x [{n}, {d}] bf16 -> f32", bound_ms=bound_ms,
         err_bound=bound, route_taken="mm_out_dtype", routes=routes)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 left on after the scan routes")
    check(min(routes, key=lambda r: routes[r]["ms"]) == "mm_out_dtype",
          f"the port's bf16 scan route is not the fastest: {routes}")
    del ref, Yb, a
    torch.cuda.empty_cache()
    return routes


def lattice_flow(lat: Oscillink, psi, chain=(2, 5, 7, 9)) -> dict:
    """Settle, U*, full receipt, bundle and chain receipt on a built
    lattice, each timed to a sync; what the card and the CPU must agree
    on, and the K1 launches the flow must make (r0 + one per iteration in
    settle and U*, one in the full receipt, none in bundle and chain
    receipt, which reuse the cached U*)."""
    lat.set_query(psi)
    t = {}
    t0 = time.perf_counter()
    st = lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    t["settle_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    lat._solve_ustar_device()
    t["ustar_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    rec = lat.receipt()
    t["receipt_full_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    bundle = [b["id"] for b in lat.bundle(k=8)]
    verdict = lat.chain_receipt(list(chain))["verdict"]
    t["bundle_chain_ms"] = sync_ms(t0)
    check(np.isfinite(rec["deltaH_total"]) and rec["deltaH_total"] >= 0, "deltaH invalid")
    check(len(bundle) == 8 and len(set(bundle)) == 8, "bundle ids invalid")
    return {
        "ms": t, "deltaH": rec["deltaH_total"], "null_points": len(rec["null_points"]),
        "bundle": bundle, "state_sig": rec["meta"]["state_sig"], "chain_verdict": verdict,
        "settle_iters": st["iters"], "ustar_iters": rec["meta"]["ustar_iters"],
        "applies": (st["iters"] + 1) + (rec["meta"]["ustar_iters"] + 1) + 1,
        "similarity": rec["meta"]["similarity"],
        "recall_target": rec["meta"]["similarity_recall_target"],
        "similarity_info": rec["meta"].get("similarity_info"),
    }


def graph_agreement(g, ref) -> dict:
    """Rows whose idx equal the reference graph's, and the weights held to
    rtol 1e-5, atol 1e-6 (tests/test_fast_similarity.py's bar) on the rows
    whose neighbourhood agrees: a row's capped weights depend on the mutual
    tests and row sums of its neighbours, so the bar skips rows within two
    hops (either direction, either graph) of a row whose idx differ; their
    count and largest weight difference are reported."""
    differ = ~(g.idx == ref.idx).all(dim=1)
    near = differ.clone()
    for _ in range(2):
        grown = near.clone()
        for idx in (g.idx.long(), ref.idx.long()):
            grown |= near[idx].any(dim=1)  # rows that list a marked row
            grown[idx[near].reshape(-1)] = True  # rows a marked row lists
        near = grown
    keep = ~near[:, None] & (g.w > 0) & (ref.w > 0)
    return {"rows_identical": float((~differ).double().mean()),
            "rows_within_two_hops": int(near.sum()),
            "w_within_bar": bool(torch.allclose(g.w[keep], ref.w[keep], rtol=1e-5, atol=1e-6)),
            "w_max_abs_diff_held": float((g.w[keep] - ref.w[keep]).abs().max()),
            "w_max_abs_diff_near": float((g.w - ref.w)[near].abs().max()) if bool(near.any()) else 0.0}


def fast_stage_ms(Y: torch.Tensor, k: int) -> dict:
    """The fast build's stages summed over its row blocks, each stage
    bracketed by CUDA events: the bf16 scan, the candidate top-k (4k a row;
    its tie check reads one flag to the host), the f32 rescore, the final
    top-k over the candidates; then `graph_from_topk` once."""
    n = Y.shape[0]
    Yn = normalize_rows(Y)
    Yb = Yn.to(torch.bfloat16)
    kc = min(4 * k, n - 1)
    names = ("scan", "candidate_topk", "rescore", "final_topk")
    ms = dict.fromkeys(names, 0.0)
    vals = torch.empty((n, k), device=Y.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=Y.device)
    for r0 in range(0, n, tgraph.DEFAULT_BLOCK_ROWS):
        r1 = min(r0 + tgraph.DEFAULT_BLOCK_ROWS, n)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        S = tgraph.scan_bf16(Yb[r0:r1], Yb)
        rows = torch.arange(r1 - r0, device=Y.device)
        S[rows, rows + r0] = -torch.inf
        ev[1].record()
        cand = tgraph.stable_topk(S, kc)[1]
        ev[2].record()
        exact = torch.bmm(Yn[cand], Yn[r0:r1, :, None])[:, :, 0]
        exact = torch.where(cand == (rows + r0)[:, None], -torch.inf, exact)
        ev[3].record()
        v, sel = tgraph.stable_topk(exact, k)
        vals[r0:r1], idx[r0:r1] = v, torch.gather(cand, 1, sel).to(torch.int32)
        ev[4].record()
        ev[4].synchronize()
        for i, name in enumerate(names):
            ms[name] += ev[i].elapsed_time(ev[i + 1])
    t0 = time.perf_counter()
    graph_from_topk(vals, idx)
    ms["graph_from_topk"] = sync_ms(t0)
    return ms


def auto_corpus() -> dict:
    """The service's default request at the corpus tier: `similarity="auto"`
    at 131072 x 768 x k8 resolves to "fast".  Build, settle, U*, full
    receipt, bundle and chain receipt with the launch counts set to 0 just
    before and read just after; the fast graph held to the exact graph of
    the same run (the recall contract: rows with identical idx >= 0.99, and
    the weights bar); `"fastest"` built once (the same function off the
    TPU); `rebuild_graph(similarity="fast")` on the exact lattice gives the
    auto lattice's graph bit for bit."""
    n, d, k = CORPUS["n"], CORPUS["d"], CORPUS["k"]
    Y, psi = data(n, d)
    t = {}
    t0 = time.perf_counter()
    exact = Oscillink(Y, kneighbors=k)
    t["exact_build_ms"] = sync_ms(t0)
    exact_run = lattice_flow(exact, psi)
    t0 = time.perf_counter()
    Oscillink(Y, kneighbors=k, similarity="auto")  # first fast build: cuBLAS bf16 warm-up
    t["fast_first_build_ms"] = sync_ms(t0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k, similarity="auto")
    t["build_ms"] = sync_ms(t0)
    run = lattice_flow(lat, psi)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 left on after the fast build")
    agree = graph_agreement(lat.graph, exact.graph)
    t0 = time.perf_counter()
    fastest = Oscillink(Y, kneighbors=k, similarity="fastest")
    t["fastest_build_ms"] = sync_ms(t0)
    fastest_same = all(torch.equal(a, b) for a, b in zip(fastest.graph, lat.graph))
    del fastest
    stages = fast_stage_ms(lat._Y_dev, k)
    exact.rebuild_graph(similarity="fast")
    rebuilt_same = all(torch.equal(a, b) for a, b in zip(exact.graph, lat.graph))
    rel = abs(run["deltaH"] - exact_run["deltaH"]) / max(abs(exact_run["deltaH"]), 1e-30)
    emit("auto_corpus", **CORPUS, **t, fast_stages_ms=stages, flow_ms=run["ms"],
         exact_flow_ms=exact_run["ms"],
         speedup_build=t["exact_build_ms"] / t["build_ms"], similarity=run["similarity"],
         recall_target=run["recall_target"], graph_vs_exact=agree,
         deltaH=run["deltaH"], deltaH_exact=exact_run["deltaH"], deltaH_rel_vs_exact=rel,
         settle_iters=run["settle_iters"], ustar_iters=run["ustar_iters"],
         exact_iters=[exact_run["settle_iters"], exact_run["ustar_iters"]],
         null_points=run["null_points"], bundle_ids=run["bundle"],
         bundle_ids_exact=exact_run["bundle"], chain_verdict=run["chain_verdict"],
         launches=counts, operator_applies=run["applies"], max_memory_allocated_bytes=peak,
         fastest_graph_equals_fast=fastest_same, rebuild_fast_bit_equal=rebuilt_same)
    check(lat._similarity == "fast" and run["similarity"] == "fast",
          f"auto resolved to {lat._similarity} at N = {n}")
    check(run["recall_target"] == 0.99, f"fast recall target {run['recall_target']}")
    check(agree["rows_identical"] >= 0.99, f"fast vs exact rows identical {agree}")
    check(agree["w_within_bar"], f"fast vs exact weights beyond the bar: {agree}")
    check(counts["K1"] == run["applies"],
          f"auto corpus K1 launches {counts['K1']} != operator applies {run['applies']}")
    check(fastest_same, "fastest's graph differs from fast's (the same function off the TPU)")
    check(rebuilt_same, "rebuild_graph(similarity='fast') differs from the auto build")
    del lat, exact
    torch.cuda.empty_cache()
    return {"launches": counts["K1"], "ms": t}


def fast_parity() -> dict:
    """The blocked fast path at 16384 x 768 (OSCILLINK_FAST_SIM_N=8192 makes
    auto take it) on the card, launch counts set to 0 just before and read
    just after, against the port on the CPU: idx identical except near-tie
    slots (`near_tie_witness`); then the CPU lattice on the card's graph:
    deltaH within 1e-5 relative, identical null count, bundle ids,
    state_sig and iterations."""
    n, d, k = FAST_PARITY["n"], FAST_PARITY["d"], FAST_PARITY["k"]
    Y, psi = data(n, d, seed=1)
    with env(OSCILLINK_FAST_SIM_N=str(FAST_PARITY["fast_sim_n"])):
        reset_counts()
        lat = Oscillink(Y, kneighbors=k, similarity="auto")
        gpu = lattice_flow(lat, psi)
        counts = read_counts()
        cpu_g = build_graph(torch.from_numpy(Y), k, similarity="fast")
        ties = near_tie_witness(Y, lat.graph.idx.cpu().numpy(), cpu_g.idx.numpy())
        lat_cpu = Oscillink(Y, kneighbors=k, similarity="auto", device="cpu", graph=lat.graph)
        cpu = lattice_flow(lat_cpu, psi)
    rel = abs(gpu["deltaH"] - cpu["deltaH"]) / max(abs(cpu["deltaH"]), 1e-30)
    emit("fast_parity", **FAST_PARITY, cuda_ms=gpu["ms"], graph_build_cuda_vs_cpu=ties,
         deltaH_rel=rel, launches=counts, similarity=gpu["similarity"],
         **{key: gpu[key] for key in ("null_points", "bundle", "state_sig", "settle_iters",
                                      "ustar_iters")})
    check(gpu["similarity"] == "fast", f"auto at N = {n} resolved to {gpu['similarity']}")
    check(ties["max_gap"] <= ties["gap_bound"], f"fast_parity graphs differ beyond rounding: {ties}")
    check(counts["K1"] == gpu["applies"], f"fast_parity K1 {counts['K1']} != {gpu['applies']}")
    check(rel <= LATTICE_TOL, f"fast_parity deltaH differs: {rel}")
    for key in ("null_points", "bundle", "state_sig", "settle_iters", "ustar_iters"):
        check(gpu[key] == cpu[key], f"fast_parity {key}: cuda {gpu[key]} vs cpu {cpu[key]}")
    return {"launches": counts["K1"]}


def study_corpus(n: int, d: int, seed: int = 0, centres: int = 1024, spread: float = 0.35):
    """The JAX package's IVF study corpora (benchmarks/
    probe_ivf_balanced_1m.py:31-41): Gaussian centres, rows = a uniformly
    drawn centre + spread * noise ("tight": 1024 centres, 0.35; "loose":
    0.6), made with numpy from the seed."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((centres, d), dtype=np.float32)
    assign = rng.integers(0, centres, size=n)
    Y = centers[assign]
    Y += np.float32(spread) * rng.standard_normal((n, d), dtype=np.float32)
    m = Y[:32].mean(axis=0)
    return Y, (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def ivf_stage_ms(Y: torch.Tensor, k: int) -> dict:
    """The IVF build's stages at the lattice's geometry, each timed to a
    sync: the clusterability pre-gate, the k-means (the Lloyd loop of
    `ivf_topk`: its bf16 scans and `_lloyd_update`s), the whole of
    `ivf_topk` (k-means, balance rounds, buckets, per-cluster scan,
    patches), `_sample_quality` and `graph_from_topk`."""
    n, d = Y.shape
    C = 1024
    P = tivf._round_up(int(2.0 * n / C), 128)
    t = {}
    t0 = time.perf_counter()
    tivf._clusterability(Y)
    t["clusterability_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    Yn = normalize_rows(Y)
    Yb = Yn.to(torch.bfloat16)
    cent = normalize_rows(Yn[:: max(n // C, 1)][:C])
    for _ in range(6):
        cent = tivf._lloyd_update(tgraph.scan_bf16(Yb, cent.to(torch.bfloat16)), Yn, cent, C, d)
    t["kmeans_ms"] = sync_ms(t0)
    del Yn, Yb, cent
    t0 = time.perf_counter()
    vals, idx, ovf, _ = tivf.ivf_topk(Y, k, n_clusters=C, bucket_cap=P, m_probe=8)
    t["ivf_topk_ms"] = sync_ms(t0)
    t["scan_ms"] = t["ivf_topk_ms"] - t["kmeans_ms"]
    t0 = time.perf_counter()
    tivf._sample_quality(Y, vals, idx, k)
    t["sample_quality_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    graph_from_topk(vals, idx)
    t["graph_from_topk_ms"] = sync_ms(t0)
    t["scan_group_clusters"] = tivf._scan_group_size(C, P, 8 * P)
    return t


def cluster_corpus() -> dict:
    """The cluster tier: `similarity="auto"` at 524288 x 768 x k8 resolves
    to "cluster".  On the JAX package's "loose" study corpus (1024 centres,
    spread 0.6; overflow 0 in its 1M study, benchmarks/ivf_balanced_1m.json)
    the IVF build must be accepted ("ivf", overflow 0, recall estimate >=
    0.9 or sim-gap p99 <= 0.01); settle, U*, full receipt, bundle and chain
    receipt run with the launch counts set to 0 just before and read just
    after, and the build's stages are timed apart.  Then two builds only:
    the "tight" study corpus (spread 0.35), reported as the gate decides it
    (its 1M study recorded 7 overflow rows, and any overflow row sends the
    build to the fast scan), and an isotropic corpus, which must fall back
    at the pre-gate."""
    n, d, k = CLUSTER["n"], CLUSTER["d"], CLUSTER["k"]
    t0 = time.perf_counter()
    Y, psi = study_corpus(n, d, centres=CLUSTER["centres"], spread=CLUSTER["spread"])
    data_s = time.perf_counter() - t0
    # the stages once before the lattice's build (the first IVF build of the
    # process) and once after it
    Yd = torch.from_numpy(Y).cuda()
    stages_first = ivf_stage_ms(Yd, k)
    del Yd
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k, similarity="auto")
    build_ms = sync_ms(t0)
    del Y
    run = lattice_flow(lat, psi)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    info = run["similarity_info"]
    U = lat.U
    check(U.shape == (n, d) and bool(np.isfinite(U).all()), "cluster corpus U not finite")
    del U
    Yd = lat._Y_dev
    del lat
    torch.cuda.empty_cache()
    stages = ivf_stage_ms(Yd, k)
    del Yd
    torch.cuda.empty_cache()
    emit("cluster_corpus", **CLUSTER, data_s=data_s, build_ms=build_ms,
         stages_first_ms=stages_first, stages_ms=stages,
         flow_ms=run["ms"], similarity=run["similarity"], recall_target=run["recall_target"],
         similarity_info=info, deltaH=run["deltaH"], settle_iters=run["settle_iters"],
         ustar_iters=run["ustar_iters"], null_points=run["null_points"],
         bundle_ids=run["bundle"], chain_verdict=run["chain_verdict"], launches=counts,
         operator_applies=run["applies"], max_memory_allocated_bytes=peak)
    check(run["similarity"] == "cluster", f"auto at N = {n} resolved to {run['similarity']}")
    check(info["mode"] == "ivf", f"the loose corpus fell back: {info}")
    check(info["overflow_patched"] == 0, f"IVF overflow {info['overflow_patched']}")
    check(info["recall_estimate"] >= 0.9 or info["sim_gap_p99"] <= 0.01, f"IVF quality {info}")
    check(counts["K1"] == run["applies"],
          f"cluster corpus K1 launches {counts['K1']} != operator applies {run['applies']}")
    # the tight study corpus, build only: accepted, or sent to the fast scan
    # by overflow rows
    Y, _ = study_corpus(n, d, centres=CLUSTER["centres"], spread=TIGHT_SPREAD)
    t0 = time.perf_counter()
    tight = Oscillink(Y, kneighbors=k, similarity="auto")
    tight_ms = sync_ms(t0)
    tight_info = tight._similarity_info
    del tight, Y
    torch.cuda.empty_cache()
    emit("cluster_tight", **{**CLUSTER, "spread": TIGHT_SPREAD}, build_ms=tight_ms,
         similarity_info=tight_info)
    check(tight_info["mode"] == "ivf" or "overflow" in tight_info["reason"],
          f"tight corpus: {tight_info}")
    # the isotropic corpus of the same shape: the pre-gate falls back to the
    # fast scan without paying the cluster scan
    Y, _ = data(n, d, seed=2)
    Yi = torch.from_numpy(Y).cuda()
    t0 = time.perf_counter()
    obs, null = (float(v) for v in torch.stack(tivf._clusterability(Yi)).tolist())
    pregate_ms = sync_ms(t0)
    del Yi
    t0 = time.perf_counter()
    iso = Oscillink(Y, kneighbors=k, similarity="auto")
    iso_ms = sync_ms(t0)
    iso_info = iso._similarity_info
    del iso, Y
    torch.cuda.empty_cache()
    emit("cluster_isotropic", n=n, d=d, k=k, build_ms=iso_ms, pregate_ms=pregate_ms,
         fallback_build_ms=iso_ms - pregate_ms, clusterability=obs, clusterability_null=null,
         similarity_info=iso_info)
    check(iso_info["mode"] == "fallback-fast", f"isotropic corpus: {iso_info}")
    check("clusterability" in iso_info["reason"], f"isotropic fallback reason: {iso_info}")
    return {"launches": counts["K1"], "build_ms": build_ms}


def ivf_parity() -> dict:
    """The IVF build on the card against the port on the CPU, on a tight
    corpus of 2048 centres at 65536 x 128 and the default geometry (C =
    1024, P = 128, m = 8; with 1024 centres 8 rows overflow their buckets
    in both packages, the JAX package's too, and both fall back):
    the same info keys and mode, floats within 1e-5, identical idx on >=
    0.999 of rows, a second card build bit-equal to the first; then the
    CPU lattice on the card's graph: deltaH within 1e-5 relative."""
    n, d, k = IVF_PARITY["n"], IVF_PARITY["d"], IVF_PARITY["k"]
    Y, psi = study_corpus(n, d, seed=3, centres=IVF_PARITY["centres"])
    Yd = torch.from_numpy(Y).cuda()
    g, info = tivf.build_graph_ivf(Yd, k)
    g2, _ = tivf.build_graph_ivf(Yd, k)
    repeat_equal = all(torch.equal(a, b) for a, b in zip(g, g2))
    del g2, Yd
    g_cpu, info_cpu = tivf.build_graph_ivf(torch.from_numpy(Y), k)
    rows = float((g.idx.cpu() == g_cpu.idx).all(dim=1).double().mean())
    floats = {key: abs(val - info_cpu[key]) for key, val in info.items()
              if isinstance(val, float)}
    with env(OSCILLINK_CLUSTER_SIM_N=str(n)):
        reset_counts()
        lat = Oscillink(Y, kneighbors=k, similarity="auto")
        gpu = lattice_flow(lat, psi)
        counts = read_counts()
        graph_same = all(torch.equal(a, b) for a, b in zip(lat.graph, g))
        lat_cpu = Oscillink(Y, kneighbors=k, similarity="auto", device="cpu", graph=lat.graph)
        cpu = lattice_flow(lat_cpu, psi)
    rel = abs(gpu["deltaH"] - cpu["deltaH"]) / max(abs(cpu["deltaH"]), 1e-30)
    emit("ivf_parity", **IVF_PARITY, info_cuda=info, info_cpu=info_cpu, float_diffs=floats,
         rows_identical=rows, repeat_bit_equal=repeat_equal, lattice_graph_equal=graph_same,
         deltaH_rel=rel, launches=counts, similarity=gpu["similarity"],
         **{key: gpu[key] for key in ("null_points", "bundle", "state_sig", "settle_iters",
                                      "ustar_iters")})
    check(info["mode"] == info_cpu["mode"] == "ivf", f"ivf_parity modes {info} vs {info_cpu}")
    check(list(info) == list(info_cpu), "ivf_parity info keys differ")
    check(all(v <= 1e-5 for v in floats.values()), f"ivf_parity info floats: {floats}")
    check(rows >= 0.999, f"ivf_parity rows identical {rows}")
    check(repeat_equal, "two IVF builds on the card differ")
    check(graph_same, "the lattice's cluster graph differs from build_graph_ivf's")
    check(counts["K1"] == gpu["applies"], f"ivf_parity K1 {counts['K1']} != {gpu['applies']}")
    check(rel <= LATTICE_TOL, f"ivf_parity deltaH differs: {rel}")
    for key in ("null_points", "bundle", "state_sig", "settle_iters", "ustar_iters"):
        check(gpu[key] == cpu[key], f"ivf_parity {key}: cuda {gpu[key]} vs cpu {cpu[key]}")
    return {"launches": counts["K1"]}


def seeded_and_state(tmp_dir: str) -> dict:
    """`neighbor_seed` at N = 8192 (the row-blocked host build): the card
    and the CPU give identical idx, w and state_sig.  Then on the card
    `export_state` -> `from_state` and `save_state(npz)` -> `from_npz`:
    identical state_sig and deltaH within 1e-5 relative of each other and
    of the CPU's import of the same state."""
    n, d, k = SEEDED["n"], SEEDED["d"], SEEDED["k"]
    Y, psi = data(n, d, seed=4)
    reset_counts()
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k, neighbor_seed=SEEDED["seed"])
    build_ms = sync_ms(t0)
    gpu = lattice_flow(lat, psi)
    counts = read_counts()
    cpu_lat = Oscillink(Y, kneighbors=k, neighbor_seed=SEEDED["seed"], device="cpu")
    cpu = lattice_flow(cpu_lat, psi)
    same = {name: torch.equal(a.cpu(), b) for name, a, b in
            zip(("idx", "w", "wn", "sqrt_deg"), lat.graph, cpu_lat.graph)}
    t0 = time.perf_counter()
    state = lat.export_state()
    export_ms = sync_ms(t0)
    path = os.path.join(tmp_dir, "state.npz")
    lat.save_state(path, format="npz")
    t0 = time.perf_counter()
    imports = {"from_state": Oscillink.from_state(state)}
    import_ms = sync_ms(t0)
    imports["from_npz"] = Oscillink.from_npz(path)
    imports["from_state_cpu"] = Oscillink.from_state(state, device="cpu")
    imports["from_npz_cpu"] = Oscillink.from_npz(path, device="cpu")
    runs = {}
    for name, other in imports.items():
        other.settle(dt=1.0, max_iters=12, tol=1e-3)
        rec = other.receipt()
        runs[name] = {"state_sig": rec["meta"]["state_sig"], "deltaH": rec["deltaH_total"],
                      "similarity_info": rec["meta"].get("similarity_info")}
    rels = {name: abs(r["deltaH"] - gpu["deltaH"]) / abs(gpu["deltaH"]) for name, r in runs.items()}
    emit("seeded_and_state", **SEEDED, build_ms=build_ms, cuda_flow_ms=gpu["ms"],
         graph_cuda_equals_cpu=same, state_sig=gpu["state_sig"], launches=counts,
         export_ms=export_ms, import_ms=import_ms, imports=runs, imports_deltaH_rel=rels,
         exported_keys=sorted(state))
    check(all(same.values()), f"seeded graph: cuda vs cpu {same}")
    for key in ("state_sig", "null_points", "bundle", "settle_iters", "ustar_iters"):
        check(gpu[key] == cpu[key], f"seeded {key}: cuda {gpu[key]} vs cpu {cpu[key]}")
    check(counts["K1"] == gpu["applies"], f"seeded K1 {counts['K1']} != {gpu['applies']}")
    # the JSON state carries A_sparse (N > 2048) and installs it; the NPZ
    # carries no adjacency there, and its import rebuilds the seeded graph,
    # whose token is the original's
    check("A_sparse" in state and runs["from_state"]["similarity_info"] == {"mode": "imported"},
          f"from_state at N = {n}: {runs['from_state']}")
    for name in ("from_state", "from_npz"):
        check(runs[name]["state_sig"] == runs[f"{name}_cpu"]["state_sig"],
              f"{name}: cuda and cpu imports differ in state_sig")
    check(runs["from_npz"]["state_sig"] == gpu["state_sig"], "from_npz state_sig != the original's")
    check(max(rels.values()) <= LATTICE_TOL, f"imported deltaH differ: {rels}")
    return {"launches": counts["K1"]}


# -- the low-memory and column-chunked solves ---------------------------------


CHUNK_SOLVES = ("solve_stationary", "settle_step", "solve_stationary_windowed",
                "solve_stationary_windowed_fused", "settle_step_windowed",
                "settle_step_windowed_fused")


@contextlib.contextmanager
def chunk_iters():
    """Record the iteration count of every per-chunk solve: the chunked
    loops of `models.coherence` look their per-chunk solve up by name at
    each call, so wrapping those names sees each chunk (and nothing of a
    full-width solve, which the lattice calls through its own names)."""
    saved = {name: getattr(tcoh, name) for name in CHUNK_SOLVES}
    seen: list = []

    def wrap(fn):
        def solve(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.append(out[1])
            return out
        return solve

    for name, fn in saved.items():
        setattr(tcoh, name, wrap(fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(tcoh, name, fn)


def measured_step(fn) -> dict:
    """``fn`` run to a sync with the launch counts set to 0 and the peak
    counter reset just before: its ms, the per-chunk iterations it made,
    the bytes allocated before it and its ``max_memory_allocated``, and the
    launches it made."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    with chunk_iters() as chunks:
        t0 = time.perf_counter()
        out = fn()
        ms = sync_ms(t0)
    return {"out": out, "ms": ms, "chunk_iters": list(chunks), "before": before,
            "peak": torch.cuda.max_memory_allocated(),
            "peak_reserved": torch.cuda.max_memory_reserved(), "launches": read_counts()}


def solve_steps(lat: Oscillink, kernel: str = "K1") -> dict:
    """Settle, U* and the full receipt on a built lattice, each a
    `measured_step`; each solve's ``kernel`` launches must equal its
    operator applies (r0 + one an iteration, summed over its chunks) and
    the receipt's K1 launches its column chunks.  Returns the steps and
    the receipt."""
    resident = lat._resident_blocks()
    settle = measured_step(lambda: lat.settle(dt=1.0, max_iters=12, tol=1e-3))
    settle.update(iters=lat.last["iters"], resident=resident)
    resident = lat._resident_blocks()
    ustar = measured_step(lambda: lat._solve_ustar_device())
    ustar.update(iters=lat.last_ustar["iters"], resident=resident)
    resident = lat._resident_blocks()
    receipt = measured_step(lat.receipt)
    receipt["resident"] = resident
    rec = receipt.pop("out")
    for name, step in (("settle", settle), ("ustar", ustar)):
        step.pop("out")
        its = step["chunk_iters"] or [step["iters"]]
        step["applies"] = sum(it + 1 for it in its)
        check(max(its) == step["iters"], f"{name}: chunk iterations {its} vs {step['iters']}")
        check(step["launches"][kernel] == step["applies"],
              f"{name}: {kernel} launches {step['launches'][kernel]} != operator applies "
              f"{step['applies']} (chunks {step['chunk_iters']})")
    check(rec["meta"]["ustar_cached"], "the receipt solved U* again")
    check(rec["meta"]["ustar_iters"] == ustar["iters"] and rec["cg_iters"] == settle["iters"],
          "the receipt's iterations are not the maxima over chunks")
    cc = lat._auto_col_chunks()
    check(receipt["launches"]["K1"] == cc,
          f"receipt: K1 launches {receipt['launches']['K1']} != its {cc} column chunks")
    return {"settle": settle, "ustar": ustar, "receipt": receipt, "rec": rec}


def receipt_values(rec: dict) -> dict:
    return {"deltaH": rec["deltaH_total"], "coh_drop_sum": rec["coh_drop_sum"],
            "anchor_pen_sum": rec["anchor_pen_sum"], "query_term_sum": rec["query_term_sum"],
            "null_points": len(rec["null_points"])}


def hold_chunked_receipt(tag: str, got: dict, ref: dict) -> dict:
    """The JAX package's bars for a chunked run against the full-width one
    (tests/test_chunked_receipts.py:65-91)."""
    rel = abs(got["deltaH"] - ref["deltaH"]) / max(abs(ref["deltaH"]), 1e-30)
    check(rel <= CHUNK_DH_REL, f"{tag}: deltaH differs from full width by {rel}")
    for key in ("coh_drop_sum", "anchor_pen_sum", "query_term_sum"):
        diff = abs(got[key] - ref[key])
        check(diff <= max(CHUNK_SUM_REL * abs(ref[key]), CHUNK_SUM_REL),
              f"{tag}: {key} {got[key]} vs full width {ref[key]}")
    check(got["null_points"] == ref["null_points"], f"{tag}: null points differ")
    return {"deltaH_rel": rel}


def step_row(step: dict, block: int) -> dict:
    """What a step reports: ms, iterations, launches, peak GB and its live
    blocks (the peak less what was allocated when it started, in [N, D]
    blocks)."""
    out = {key: step[key] for key in ("ms", "chunk_iters", "launches") if key in step}
    for key in ("iters", "applies", "resident"):
        if key in step:
            out[key] = step[key]
    out.update(peak_gb=step["peak"] / 1e9, before_gb=step["before"] / 1e9,
               peak_reserved_gb=step["peak_reserved"] / 1e9,
               live_blocks=(step["peak"] - step["before"]) / block)
    return out


def model_check(checks: list, tag: str, n: int, d: int, k: int, route: str, resident: int,
                col_chunks: int, step: dict, donated: bool = False,
                form: str | None = None) -> None:
    """The working-set model's estimate for a run configuration, with the
    full-width blocks held when it ran (the lattice's `_resident_blocks`
    and any the script holds) and the CG form it ran in (None: the one the
    lattice picked), must be at least its measured peak; recorded now,
    held at the end of the phase."""
    est = tlattice.working_set_bytes(n, d, k, route, resident, col_chunks, donated, form)
    checks.append({"tag": tag, "route": route, "resident": resident, "col_chunks": col_chunks,
                   "donated": donated, "form": form, "estimate_gb": est / 1e9,
                   "peak_gb": step["peak"] / 1e9, "ok": est >= step["peak"]})


def first_chunked_n(d: int, k: int, capacity: int, routes: list) -> int:
    """The least N (to 1024 rows) at which `auto_col_chunks` takes c > 1."""
    lo, hi = 1024, 1 << 28
    while hi - lo > 1024:
        mid = (lo + hi) // 2
        if tlattice.auto_col_chunks(mid, d, k, capacity, routes) > 1:
            hi = mid
        else:
            lo = mid
    return hi


def model_decisions(lat: Oscillink, capacity: int) -> dict:
    """The models' decisions at this lattice's size on this card, and what
    the card holds outside the caching allocator (the CUDA context)."""
    n, d, k = lat.N, lat.D, lat._kneighbors
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return {
        "total_memory": capacity,
        "outside_allocator_bytes": total - free - torch.cuda.memory_reserved(),
        "col_chunks": lat._auto_col_chunks(),
        "col_chunks_gather_settle": lat._auto_col_chunks_gather(2),
        "col_chunks_gather_ustar": lat._auto_col_chunks_gather(1),
        "lowmem_solve_bytes": tcoh.LOWMEM_SOLVE_BYTES,
        "lowmem_at_this_n": tcoh._pick_cg(lat._Y_dev) is tcoh.cg_solve_lowmem,
        # the gather solves with Y, U and the U* cache held, the most the
        # lattice holds beside them
        "first_chunked_n_gather": first_chunked_n(d, k, capacity, [("settle", 3), ("ustar", 3)]),
        "first_chunked_n_receipt": first_chunked_n(d, k, capacity, [("receipt", 3)]),
        "n": n,
    }


def cg_form(lat: Oscillink, form: str, fn):
    """``fn`` with the solves' CG form forced: "classic" or "lowmem"."""
    saved = tcoh.LOWMEM_SOLVE_BYTES
    tcoh.LOWMEM_SOLVE_BYTES = 0 if form == "lowmem" else 1 << 62
    try:
        return fn()
    finally:
        tcoh.LOWMEM_SOLVE_BYTES = saved


def million() -> dict:
    """The JAX package's 1M study shape: 1,000,000 x 768 x k8 on the loose
    IVF study corpus.  ``similarity="auto"`` must resolve to "cluster" and
    the IVF build be accepted with overflow 0.  The whole flow full width
    (settle, U*, full receipt, bundle, chain receipt), then settle, U* and
    the full receipt again on the same graph from the same start under
    OSCILLINK_COL_CHUNKS = 4 and 8, each held to the full-width run; then
    the classic and the low-memory CG on the same inputs (identical
    iterations, U within FORM_TOL of max|U|; U* timed in turns).  K1's
    launches are counted from 0 before each step and must equal its
    operator applies; every step's peak must lie under the working-set
    model's estimate.  Last, K1 against its plain version at the chunk
    widths on this graph."""
    n, d, k = MILLION["n"], MILLION["d"], MILLION["k"]
    block = n * d * 4
    t0 = time.perf_counter()
    Y, psi = study_corpus(n, d, centres=MILLION["centres"], spread=MILLION["spread"])
    data_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k, similarity="auto")
    build_ms = sync_ms(t0)
    del Y
    lat.set_query(psi)
    info = lat._similarity_info
    check(lat._similarity == "cluster", f"auto at N = {n} resolved to {lat._similarity}")
    check(info["mode"] == "ivf" and info["overflow_patched"] == 0, f"1M IVF build: {info}")
    capacity = torch.cuda.get_device_properties(0).total_memory
    decisions = model_decisions(lat, capacity)
    checks: list = []
    cc0 = lat._auto_col_chunks()
    full = solve_steps(lat)
    t0 = time.perf_counter()
    bundle = [b["id"] for b in lat.bundle(k=8)]
    chain = lat.chain_receipt([2, 5, 7, 9])
    bundle_chain_ms = sync_ms(t0)
    ref = receipt_values(full["rec"])
    emit("million_full", **MILLION, data_s=data_s, build_ms=build_ms, similarity_info=info,
         decisions=decisions, bundle_chain_ms=bundle_chain_ms, receipt_values=ref,
         **{key: step_row(full[key], block) for key in ("settle", "ustar", "receipt")})
    check(lat._U_dev.shape == (n, d) and bool(torch.isfinite(lat._U_dev).all()),
          "1M U not finite")
    check(np.isfinite(ref["deltaH"]) and ref["deltaH"] >= 0, "1M deltaH invalid")
    check(len(bundle) == 8 and len(set(bundle)) == 8, "1M bundle ids invalid")
    for route in ("settle", "ustar", "receipt"):
        model_check(checks, f"full_{route}", n, d, k, route, full[route]["resident"], cc0,
                    full[route])
    runs = {"full": {key: step_row(full[key], block) for key in ("settle", "ustar", "receipt")}}
    runs["full"].update(receipt_values=ref, bundle_ids=bundle, bundle_chain_ms=bundle_chain_ms,
                        chain_verdict=chain["verdict"], col_chunks=cc0)
    # the chunked runs on the same graph, U reset to the fresh lattice's Y
    for c in MILLION_CHUNKS:
        lat._U_dev = lat._Y_dev
        lat._invalidate_cache()
        with env(OSCILLINK_COL_CHUNKS=str(c)):
            steps = solve_steps(lat)
            ids = [b["id"] for b in lat.bundle(k=8)]
        got = receipt_values(steps["rec"])
        for route in ("settle", "ustar", "receipt"):
            model_check(checks, f"c{c}_{route}", n, d, k, route, steps[route]["resident"], c,
                        steps[route])
        runs[f"c{c}"] = {key: step_row(steps[key], block) for key in ("settle", "ustar", "receipt")}
        runs[f"c{c}"].update(receipt_values=got, bundle_ids=ids)
        emit("million_chunked", col_chunks=c, **runs[f"c{c}"])
        runs[f"c{c}"].update(hold_chunked_receipt(f"million c={c}", got, ref))
        check(ids == bundle, f"million c={c}: bundle ids {ids} vs full width {bundle}")
        del steps
    # the two CG forms on the same inputs: the settle from the fresh start
    # (U is Y), the settle from a settled U (which the low-memory form then
    # writes in place) and U*; the classic result is held while the
    # low-memory form runs, one more resident block
    U_start = lat._U_dev  # settled, by the c = 8 run
    lat._invalidate_cache()
    forms: dict = {"classic": {}, "lowmem": {}}
    form_errs = {}
    # resident [N, D] blocks of each measurement: Y and the held start U;
    # the settled settle's own U copy
    base = {"settle_fresh": 2, "settle_settled": 3, "ustar": 2}
    for key, res in base.items():
        vals = {}
        for form in ("classic", "lowmem"):
            if key == "settle_fresh":
                lat._U_dev = lat._Y_dev
            elif key == "settle_settled":
                lat._U_dev = U_start.clone()  # held by the lattice alone: the donated route
            else:
                lat._U_dev = U_start
            if key == "ustar":
                st = cg_form(lat, form, lambda: measured_step(
                    lambda: lat._solve_ustar_device(use_cache=False)))
                st["iters"] = lat.last_ustar["iters"]
                vals[form] = st.pop("out")
            else:
                st = cg_form(lat, form, lambda: measured_step(
                    lambda: lat.settle(dt=1.0, max_iters=12, tol=1e-3)))
                st["iters"] = lat.last["iters"]
                st.pop("out")
                vals[form] = lat._U_dev
            lat._U_dev = U_start
            check(st["launches"]["K1"] == st["iters"] + 1,
                  f"{form} {key}: K1 launches {st['launches']['K1']} != {st['iters']} + 1")
            donated = key == "settle_settled" and form == "lowmem"
            model_check(checks, f"{form}_{key}", n, d, k, "ustar" if key == "ustar" else "settle",
                        res + (form == "lowmem"), 1, st, donated=donated, form=form)
            forms[form][key] = st
        scale = float(vals["classic"].abs().max())
        form_errs[key] = float((vals["classic"] - vals["lowmem"]).abs().max()) / scale
        del vals
        emit("million_forms", step=key, rel_err=form_errs[key],
             **{form: step_row(forms[form][key], block) for form in forms})
        check(forms["classic"][key]["iters"] == forms["lowmem"][key]["iters"],
              f"{key}: classic {forms['classic'][key]['iters']} vs low-memory "
              f"{forms['lowmem'][key]['iters']} iterations")
        check(form_errs[key] <= FORM_TOL, f"{key}: classic vs low-memory U {form_errs[key]}")
    # U* in turns, classic and low-memory, on the same inputs
    lat._invalidate_cache()
    turn_ms: dict = {"classic": [], "lowmem": []}
    for _ in range(FORM_TURNS):
        for form in ("classic", "lowmem"):
            t0 = time.perf_counter()
            cg_form(lat, form, lambda: lat._solve_ustar_device(use_cache=False))
            turn_ms[form].append(sync_ms(t0))
    # K1 against its plain version at the chunk widths on this graph
    g = lat.graph
    del lat, U_start
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(5)
    k1_rows = []
    for c in MILLION_CHUNKS:
        X = torch.randn(n, d // c, generator=gen, device="cuda")
        k1_rows.append(k1_case({"case": f"million_chunk_c{c}"}, g, X))
        del X
    # K1 at full width on this graph: its plan's slab width beside S = D
    X = torch.randn(n, d, generator=gen, device="cuda")
    k1_full = {"slab_cols": k1_slab_cols(n, d, k), **turns_ms({
        "plan": lambda: spmv.lap_matvec_cuda(g.idx, g.wn, X),
        "full_width": lambda: spmv.lap_matvec_cuda(g.idx, g.wn, X, slab_cols=d),
    }, 5)}
    del X, g
    torch.cuda.empty_cache()
    emit("million", **MILLION, decisions=decisions, form_rel_err=form_errs,
         ustar_turns_ms=turn_ms,
         ustar_median_ms_in_turns={form: statistics.median(turn_ms[form]) for form in turn_ms},
         model_checks=checks, k1_chunk_widths=k1_rows, k1_full_width_ms=k1_full)
    for row in checks:
        check(row["ok"], f"working-set model under the measured peak: {row}")
    launches = {f"{run}_{key}": runs[run][key]["launches"]["K1"]
                for run in runs for key in ("settle", "ustar", "receipt")}
    return {"launches": launches, "k1_rows": k1_rows}


def window_chunk_kernels(lat: Oscillink, widths: dict) -> list:
    """K4 (fused, at a multiple of 128), K3 and K2 (K2 alone, without its
    epilogue) against their gather-form plain versions on a lattice's
    window context at the chunk widths ``widths`` ({kernel: D/c}), timed
    beside the plain version, with their bounds."""
    ctx = lat._window_ctx
    plan, W, s_max = ctx.plan, ctx.W, ctx.s_max
    R = plan.n_pad // plan.n_blocks
    cnt = plan.strag_cnt.cpu().numpy()
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for key, width in widths.items():
        X = tw.pad_rows(torch.randn(lat.N, width, generator=gen, device="cuda"), plan.n_pad)
        g = 1.5 + torch.rand(plan.n_pad, 1, generator=gen, device="cuda")
        calls = {
            "K2": (lambda: (tw.window_spmv_cuda(plan, X, W, R, "bf16x3"),),
                   lambda: (tw.window_spmv_gather_ref(plan, X, W, R, "bf16x3"),)),
            "K3": (lambda: (tw.window_spmv3_cuda(plan, X, W, R, s_max, "bf16x3"),),
                   lambda: (tw.window_spmv3_gather_ref(plan, X, W, R, s_max, "bf16x3"),)),
            "K4": (lambda: tw.window_spmv3f_cuda(plan, X, g, W, R, s_max, "bf16x3"),
                   lambda: tw.window_spmv3f_gather_ref(plan, X, g, W, R, s_max, "bf16x3")),
        }[key]
        out, ref = calls[0](), calls[1]()
        torch.cuda.synchronize()
        errs = []
        for o, r, tol in zip(out, ref, (GATHER_TOL, GATHER_PAP_TOL)):
            err = float((o - r).abs().max())
            check(bool(torch.isfinite(o).all()) and err <= tol * float(r.abs().max()),
                  f"{key} at D = {width} != its gather plain version: {err}")
            errs.append(err)
        case = {"plan": plan, "Xpad": X, "nnz": {
            "strag_w": int(torch.count_nonzero(plan.strag_w)),
            "wnl": int(torch.count_nonzero(plan.wnl)),
            "strag_seg": int(np.minimum(cnt, s_max).sum())}}
        rows.append({"kernel": key, "d": width, "n_pad": plan.n_pad, "max_abs_err": errs[0],
                     **({"pap_max_abs_err": errs[1]} if key == "K4" else {}),
                     "ms": cuda_ms(calls[0], 20), "plain_ms": cuda_ms(calls[1], 3),
                     **window_bound(case, key)})
        del X, g, out, ref
    return rows


def windowed_chunked() -> dict:
    """The windowed tier under column chunks (OSCILLINK_WINDOWED_MATVEC=1).
    On the locality-ordered 131072 x 768 x k8 corpus: the full-width
    windowed settle, U* and full receipt, then the same from the same start
    on the same context rebuilt under OSCILLINK_COL_CHUNKS = 2 (K4 fused,
    K3 unfused, at D/c = 384) and 8 (K2 and its epilogue at 96); U* held
    to the full-width run within WINDOWED_CHUNK_TOL of max|U|, each
    solve's launches equal to its operator applies, the receipt's K1
    launches its chunks.  The kernels against their plain versions at the
    chunk widths.  Then the straggler corpus card against CPU at c = 2
    (fused, unfused) and c = 8, held to the lattice bar."""
    n, d, k = CORPUS["n"], CORPUS["d"], CORPUS["k"]
    block = n * d * 4
    Y, psi = locality_corpus(n, d)
    out: dict = {"launches": {}}
    with env(OSCILLINK_WINDOWED_MATVEC="1", OSCILLINK_WINDOWED_FUSED="1"):
        lat = Oscillink(Y, kneighbors=k)
        lat.set_query(psi)
        check(lat._window_fullwidth and lat._auto_col_chunks() == 1,
              "the windowed corpus should solve full width on the card")
        full = solve_steps(lat, "K4")
        checks: list = []
        for route in ("settle", "ustar", "receipt"):
            model_check(checks, f"windowed_full_{route}", n, d, k,
                        "receipt" if route == "receipt" else "windowed",
                        full[route]["resident"], 1, full[route])
        Ustar_ref = lat._Ustar_cache_dev
        scale = float(Ustar_ref.abs().max())
        runs = {"full": {key: step_row(full[key], block) for key in ("settle", "ustar", "receipt")}}
        runs["full"]["receipt_values"] = receipt_values(full["rec"])
    for cc, fused, kernel in WINDOWED_CHUNKED:
        with env(OSCILLINK_WINDOWED_MATVEC="1", OSCILLINK_WINDOWED_FUSED=fused,
                 OSCILLINK_COL_CHUNKS=cc):
            lat._maybe_build_window_ctx()
            check(not lat._window_fullwidth and lat._window_ctx.oh is None,
                  f"c = {cc}: the forced context should solve chunked, with no one-hot")
            lat._U_dev = lat._Y_dev
            lat._invalidate_cache()
            steps = solve_steps(lat, kernel)
            for route in ("settle", "ustar", "receipt"):
                # the full-width U* is held beside the lattice's blocks
                model_check(checks, f"windowed_c{cc}_fused{fused}_{route}", n, d, k,
                            "receipt" if route == "receipt" else "windowed",
                            steps[route]["resident"] + 1, int(cc), steps[route])
            err = float((lat._Ustar_cache_dev - Ustar_ref).abs().max()) / scale
            check(err <= WINDOWED_CHUNK_TOL, f"windowed c={cc} fused={fused}: U* {err}")
            tag = f"c{cc}_fused{fused}"
            runs[tag] = {key: step_row(steps[key], block) for key in ("settle", "ustar", "receipt")}
            runs[tag].update(kernel=kernel, ustar_rel_err=err,
                             receipt_values=receipt_values(steps["rec"]))
            out["launches"][tag] = {kernel: steps["settle"]["launches"][kernel]
                                    + steps["ustar"]["launches"][kernel],
                                    "K1": steps["receipt"]["launches"]["K1"]}
            del steps
    del Ustar_ref
    with env(OSCILLINK_WINDOWED_MATVEC="1"):
        lat._maybe_build_window_ctx()  # OSCILLINK_COL_CHUNKS unset: full width again
    rows = window_chunk_kernels(lat, {"K4": d // 2, "K3": d // 2, "K2": d // 8})
    k1_row = k1_case({"case": "windowed_chunk_c2"}, lat.graph,
                     torch.randn(n, d // 2, device="cuda"))
    del lat
    torch.cuda.empty_cache()
    emit("windowed_chunked", **CORPUS, runs=runs, kernels_at_chunk_widths=rows,
         k1_chunk_width=k1_row, model_checks=checks)
    for row in checks:
        check(row["ok"], f"working-set model under the measured peak: {row}")
    out["rows"], out["k1_row"] = rows, k1_row
    # the straggler corpus, card against CPU on the card's graph
    Y, psi = clustered_corpus(STRAGGLERS["n"], STRAGGLERS["d"])
    for cc, fused, kernel in WINDOWED_CHUNKED:
        with env(OSCILLINK_WINDOWED_MATVEC="1", OSCILLINK_WINDOWED_FUSED=fused,
                 OSCILLINK_COL_CHUNKS=cc):
            run, lat = card_vs_cpu(f"windowed_stragglers_c{cc}_fused{fused}", Y, psi,
                                   STRAGGLERS["k"], kernel)
            check(not lat._window_fullwidth, f"stragglers c = {cc}: the context solved full width")
            out["launches"][f"stragglers_c{cc}_fused{fused}"] = {kernel: run["launches"]}
            del lat
    return out


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
            "ptxas": ptxas_report(log.read_text()) if log.exists() else {},
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

    # 7. K1 timing at the main path's shapes, then its slab widths swept at
    # the corpus shape
    rows = [time_kernel(HEADLINE, cases["headline"]), time_kernel(CORPUS, cases["corpus"])]
    main_row = rows[1]
    sweep = k1_slab_sweep(CORPUS, cases["corpus"])
    # 7b. K1 at the serving paths' narrow widths and on the ragged union graph
    narrow = k1_narrow(cases["corpus"]["g"], cases["ragged"]["g"])
    k1_err = max([c["err"] for c in cases.values()] + [r["max_abs_err"] for r in narrow])
    del cases
    torch.cuda.empty_cache()

    # 7c. the multi-query serving paths through K1, each with its launches
    # counted from 0: the batched lattice (card vs CPU), the /v1/bundle batch
    # path at the corpus tier, standalone diffusion gates, ragged bundles,
    # the one-shot light receipt
    serving = {"batched_parity": batched_parity()["launches"]}
    corpus_batch = batched_corpus()
    serving.update({f"batched_corpus_{key}": val for key, val in corpus_batch["launches"].items()})
    diff = diffusion_standalone()
    serving.update({f"diffusion_{key}": val["launches"] for key, val in diff.items()})
    serving["ragged"] = ragged_phase()["launches"]
    serving["oneshot"] = oneshot_phase()["launches"]
    k1_err = max(k1_err, corpus_batch["k1_row"]["max_abs_err"])
    torch.cuda.empty_cache()

    # 7d. similarity="auto", all through K1 with its launches counted from 0
    # in each phase: the bf16 scan's routes; the corpus tier's default
    # request (fast) against the exact build; the blocked fast path, the IVF
    # build and the seeded host build each against the CPU; the cluster tier
    # (IVF at 524288) and its isotropic fallback; export and import
    auto_launches = {}
    scan_routes()
    auto_launches["auto_corpus"] = auto_corpus()["launches"]
    auto_launches["fast_parity"] = fast_parity()["launches"]
    auto_launches["cluster_corpus"] = cluster_corpus()["launches"]
    auto_launches["ivf_parity"] = ivf_parity()["launches"]
    with tempfile.TemporaryDirectory() as tmp:
        auto_launches["seeded_and_state"] = seeded_and_state(tmp)["launches"]
    torch.cuda.empty_cache()

    # 7e. the 1M study shape: full width, column-chunked and the two CG
    # forms, K1's launches counted from 0 before each step
    big = million()
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

    # 11. the windowed tier under column chunks: K4 and K3 at D/c = 384, K2
    # and its epilogue at 96
    wchunk = windowed_chunked()
    chunk_rows = {row["kernel"]: row for row in wchunk["rows"]}
    chunk_launches = {key: {tag: val[key] for tag, val in wchunk["launches"].items() if key in val}
                      for key in ("K2", "K3", "K4")}
    k1_chunk_rows = big["k1_rows"] + [wchunk["k1_row"]]

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
        "slab_cols": sweep["plan_slab_cols"],
        "l2_budget_bytes": sweep["l2_budget_bytes"],
        "slab_sweep_ms": sweep["ms"],
        "slab_stream_only_ms": sweep["stream_only_ms"],
        "bench_graph_ms": win_timing["k1_ms"],
        "bench_graph_full_width_ms": win_timing["k1_full_width_ms"],
        "ptxas": k1_ptxas(libs["spmv"]["ptxas"]),
        "launches_per_settle": settle_launches,
        "launches_serving": serving,
        "launches_auto": auto_launches,
        "gather_ceiling_ms": main_row["gather_ceiling_ms"],
        "per_shape": rows + narrow + [corpus_batch["k1_row"]],
        "launches_chunked": {**big["launches"], **{
            f"windowed_{tag}": val["K1"]
            for tag, val in wchunk["launches"].items() if "K1" in val}},
        "chunk_max_abs_err": max(r["max_abs_err"] for r in k1_chunk_rows),
        "per_chunk_width": k1_chunk_rows,
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
        "launches_chunked": chunk_launches[key],
        "chunk_max_abs_err": chunk_rows[key]["max_abs_err"],
        "chunk_width": chunk_rows[key],
    } for key, kname, _, replaces in WINDOW_KERNELS] + [k5_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
