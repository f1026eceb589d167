"""Run one cell of the port's benchmark on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (a ``workloads`` entry of ``BENCHMARK.json``) names a configuration
and a traffic mix; `harness` finds their files by name.  Set-up makes the
inputs on the card from ``--seed``, builds the system, warms the cell's own
shapes and times that as ``setup_s``.  Then one caller issues queries back
to back for ``--seconds`` (a closed loop), each timed on the host clock from
the call to its result on the host.  After the window the program's state
is freed and the plain reference (`reference.py`) checks a sample of what
the window produced (`compare.py`).  The last line of standard output is
the result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; its per-layer metrics with ``--trace 1``), ``device``
and, traced, ``breakdown``; ``checks`` last, each compared number beside
its limit, which also end standard error.

With ``--trace 1`` a torch.profiler trace covers the first
`TRACE_SECONDS` of the window.  The run fails, printing no result, without
a CUDA card, or when a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import data, harness  # noqa: E402
from portbench.harness import Cell, Run  # noqa: E402

TRACE_SECONDS = 8.0
SPANS = ("request", "set_query", "settle", "receipt", "bundle", "ustar")


def pin_caches(root: Path) -> None:
    """Every kernel build and cache in fixed directories of the checkout, so
    that only a checkout's first run builds.  The port builds its CUDA
    sources into ``build/oscillink_tpu_torch/`` of the checkout;
    ``OSCILLINK_COMPILE_CACHE_DIR`` names the same directory to the
    service."""
    build = root / "build"
    os.environ["OSCILLINK_COMPILE_CACHE_DIR"] = str(build / "oscillink_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "portbench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "portbench" / "triton")


def card_info() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        name, limit = out.splitlines()[0].rsplit(",", 1)
        return {"smi_name": name.strip(), "power_limit": limit.strip()}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        return {"power_limit": f"not read ({type(e).__name__})"}


def choose_sample(check: dict, seed: int, seconds: float, per_query_s: float) -> object:
    """Indices of the window's queries whose outputs the check compares:
    "all", or ``check["sample"]`` drawn from the seed among the first four
    fifths of the queries the warm-up's pace leads one to expect."""
    if check["sample"] == "all":
        return "all"
    s = int(check["sample"])
    expected = int(0.8 * seconds / max(per_query_s, 1e-6))
    rng = random.Random(data.sub_seed(seed, "sample"))
    return set(rng.sample(range(max(s, expected)), s))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             out=sys.stdout, err=sys.stderr, program=None) -> int:
    """Run the cell and print its result; ``program`` stands another system
    in for the port's (the control, `control.py`)."""
    import torch

    from portbench import trace as tracemod
    from portbench.run_support import Snapshots, sync

    torch.backends.cuda.matmul.allow_tf32 = False
    run = Run(config=cell.config)
    sysmod = importlib.import_module(f"portbench.systems.{cell.config['system']}")
    t_system = time.perf_counter()
    system = sysmod.System(cell.config, cell.traffic, seed, device, run, trace,
                           **({} if program is None else {"program": program}))
    t_warm = time.perf_counter()
    snap = Snapshots(device)
    check = cell.traffic["check"]
    warm_s = []
    for i in range(cell.traffic["warmup"]):
        start = i == 0 and check.get("start", False)
        prep = system.prepare(i, "warmup", snap if start else None)
        t0 = time.perf_counter()
        res = system.call(prep)
        warm_s.append(time.perf_counter() - t0)
        system.after(prep, res)
    run.spans.clear()
    run.counters.clear()
    sample = choose_sample(check, seed, seconds, statistics.median(warm_s))
    sync(device)
    run.setup_s = time.perf_counter() - t_start
    setup_parts = {"start": t_system - t_start, "system": t_warm - t_system,
                   "warmup": t_start + run.setup_s - t_warm, **run.setup_spans}

    prof = win = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        win = record_function(tracemod.WINDOW)
        win.__enter__()

    def end_trace():
        nonlocal win
        sync(device)
        win.__exit__(None, None, None)
        prof.stop()
        win = None

    failed, first_error = 0, None
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        prep = system.prepare(i, "queries", snap if sample == "all" or i in sample else None)
        t1 = time.perf_counter()
        try:
            res = system.call(prep)
        except Exception:  # a failed query is counted and its latency is infinite
            failed += 1
            first_error = first_error or traceback.format_exc()
            run.latencies.append(None)
        else:
            run.latencies.append(time.perf_counter() - t1)
            system.after(prep, res)
        i += 1
        if win is not None and time.perf_counter() - t0 >= TRACE_SECONDS:
            end_trace()
    run.window_s = time.perf_counter() - t0
    if win is not None:
        end_trace()
    sync(device)
    peak = snap.peak()
    if first_error:
        print(first_error, file=err)
    if prof is not None:
        run.trace = tracemod.reduce_events(prof.events(), SPANS)
        del prof

    system.release()
    t_check = time.perf_counter()
    try:
        checks = system.check()
    except Exception:  # the check itself failed: not correct
        print(traceback.format_exc(), file=err)
        checks = {}
    check_s = time.perf_counter() - t_check
    correct = harness.judge(checks, cell.limits) and failed == 0 and len(system.samples) > 0

    metrics = harness.read_metrics(cell, run, trace)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev.update(card_info())
    breakdown = None
    if run.trace is not None:
        dev.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        breakdown = {k: run.trace[k] for k in ("device_ops", "idle_gaps")}
    done = [x for x in run.latencies if x is not None]
    print(json.dumps({"summary": {
        "workload": cell.name, "seed": seed, "queries": len(run.latencies), "failed": failed,
        "median_ms": 1e3 * statistics.median(done) if done else None,
        "window_s": run.window_s, "setup_s": run.setup_s, "setup_parts": setup_parts,
        "checked": len(system.samples),
        "check_s": check_s}}),
        file=out)

    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=err)
        return 3
    for key, lim in cell.limits.items():
        print(f"check {key} = {checks.get(key)} (limit {lim})", file=err)
    print(harness.result_line(correct, len(run.latencies), failed, metrics, dev, checks,
                              cell.limits, breakdown), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches(ROOT)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                    T_START)


if __name__ == "__main__":
    sys.exit(main())
