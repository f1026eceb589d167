"""Where the time goes on the card: a torch.profiler breakdown of the port's
main path (settle -> U* -> light receipt) at the chip_smoke.py cells: the
gather path at the headline and corpus shapes, and the windowed tier
(OSCILLINK_WINDOWED_MATVEC=1, kernel K4) on chip_smoke.py's locality-ordered
corpus of the same shape; then the multi-query serving paths at
chip_smoke.py's serving cells: the /v1/bundle batch path at the corpus
(``diffusion_gates_batch``, ``bundle_batch``), ``solve_Ustar_batch`` (its
CG and the copy of U* to the host) and ``bundle_ragged``.

    python3 scripts/profile_torch_main_path.py

Needs one CUDA card.  For each cell it runs one warm pass on a lattice,
then profiles two windows on a second one: its build (construction and
set_query) and its solve (settle, U* solve, light receipt).  It prints one
JSON line per cell; for each window the wall time, the device time summed
over kernels and copies, the device's idle share, the top kernels and the
top aten ops by device time, and the device time and share of the cell's
operator kernel (K1's ``spmv_gather_kernel`` on the gather path, K4's
``window_spmv3f_kernel`` on the windowed one) with its launch count.  It
fails when CUDA is missing or the trace holds no device time.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    BATCH_Q, CORPUS, HEADLINE, RAGGED_BATCH, data, env, locality_corpus, queries, ragged_inputs,
)
from oscillink_tpu_torch import Oscillink  # noqa: E402
from oscillink_tpu_torch.models.ragged import bundle_ragged  # noqa: E402

# cell: (shape, corpus generator, environment, the operator kernel's name)
CELLS = {
    "headline": (HEADLINE, data, {}, "spmv_gather_kernel"),
    "corpus": (CORPUS, data, {}, "spmv_gather_kernel"),
    "windowed_corpus": (CORPUS, locality_corpus, {"OSCILLINK_WINDOWED_MATVEC": "1"},
                        "window_spmv3f_kernel"),
}


def _solve_pass(lat) -> dict:
    st = lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    rec = lat.receipt()
    return {"settle_iters": st["iters"], "ustar_iters": rec["meta"]["ustar_iters"]}


def _lattice(Y, psi, k):
    lat = Oscillink(Y, kneighbors=k)
    lat.set_query(psi)
    lat.set_receipt_detail("light")
    return lat


def _device_us(evt) -> float:
    # torch >= 2.4 names it device time; older releases cuda time
    return float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0)))


def _rows(events) -> list:
    rows = [(e.key, _device_us(e) / 1000.0, e.count) for e in events]
    return sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])


def _window(fn, kernel: str) -> tuple[dict, object]:
    """Profile ``fn()`` and summarise the window's device time, with the
    time of the kernels whose name holds ``kernel``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # device-side events (kernels, copies) carry the device time once; the
    # aten ops that launched them carry the same time again as their "self"
    kernels = _rows(e for e in events if e.device_type == DeviceType.CUDA)
    aten = _rows(e for e in events if e.device_type != DeviceType.CUDA)
    device_ms = sum(ms for _, ms, _ in kernels)
    if device_ms <= 0:
        raise RuntimeError("the trace holds no device time; time with CUDA events instead")
    own = [(ms, count) for key, ms, count in kernels if kernel in key]
    own_ms = sum(ms for ms, _ in own)
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "operator_kernel": {"kernel": kernel, "ms": own_ms, "share": own_ms / device_ms,
                            "calls": sum(count for _, count in own)},
        "top_kernels": [
            {"kernel": key[:100], "ms": ms, "share": ms / device_ms, "calls": count}
            for key, ms, count in kernels[:8]
        ],
        "top_ops": [
            {"op": key, "ms": ms, "share": ms / device_ms, "calls": count}
            for key, ms, count in aten[:12]
        ],
    }, out


def profile_cell(name: str, shape: dict, corpus, envs: dict, kernel: str) -> dict:
    n, d, k = shape["n"], shape["d"], shape["k"]
    Y, psi = corpus(n, d)
    with env(**envs):
        _solve_pass(_lattice(Y, psi, k))  # warm-up on a lattice of its own
        build, lat = _window(lambda: _lattice(Y, psi, k), kernel)  # its U* is not cached
        solve, iters = _window(lambda: _solve_pass(lat), kernel)
    return {"cell": name, "n": n, "d": d, "k": k, **iters, "build": build, "solve": solve}


def profile_serving():
    """One window per serving path, each after a warm call of its own; K1
    (``spmv_gather_kernel``) is the operator kernel of all of them.
    Yields one JSON-ready dict per path."""
    kernel = "spmv_gather_kernel"
    n, d, k = CORPUS["n"], CORPUS["d"], CORPUS["k"]
    Y, _ = data(n, d)
    psis = queries(Y, BATCH_Q)
    lat = Oscillink(Y, kneighbors=k)
    G = lat.diffusion_gates_batch(psis)  # warm-up
    gates, G = _window(lambda: lat.diffusion_gates_batch(psis), kernel)
    yield {"cell": "batched_corpus_gates", "n": n, "d": d, "k": k, "queries": BATCH_Q, **gates}
    lat.bundle_batch(psis, G, k=8)  # warm-up
    bundles, _ = _window(lambda: lat.bundle_batch(psis, G, k=8), kernel)
    yield {"cell": "batched_corpus_bundle_batch", "n": n, "d": d, "k": k, "queries": BATCH_Q,
           **bundles}
    ustar, _ = _window(lambda: lat.solve_Ustar_batch(psis, G), kernel)
    yield {"cell": "batched_corpus_solve_Ustar_batch", "n": n, "d": d, "k": k,
           "queries": BATCH_Q, **ustar}
    del lat
    torch.cuda.empty_cache()
    corpora, qs = ragged_inputs()
    kw = dict(kneighbors=RAGGED_BATCH["k"], bundle_k=RAGGED_BATCH["bundle_k"])
    bundle_ragged(corpora, qs, **kw)  # warm-up
    ragged, _ = _window(lambda: bundle_ragged(corpora, qs, **kw), kernel)
    yield {"cell": "ragged", **RAGGED_BATCH, **ragged}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_main_path: no CUDA card", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)
    for name, (shape, corpus, envs, kernel) in CELLS.items():
        print(json.dumps(profile_cell(name, shape, corpus, envs, kernel)), flush=True)
    for row in profile_serving():
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
