"""The benchmark's data-driven core: it finds a cell's configuration,
traffic mix, limits and metric readers by the names in ``BENCHMARK.json``,
drives the measured window, and prints the result line.

Files, all found by name:

* ``configs/<config>.json`` — a configuration (as `BENCHMARK.json` names
  its ``file``); its ``system`` names the module that runs it,
  ``systems/<system>.py``.
* ``traffic/<traffic>.json`` — a traffic mix: the parameters the system's
  generator reads (what each query calls, the warm-up, the sample the
  correctness check takes).
* ``checks/<workload>.json`` — the limit of each number the correctness
  check compares in that cell.
* ``metrics/<metric>.py`` — one reader per metric, end-to-end or per-layer:
  ``read(run) -> float | None`` over the run record (`Run`).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "oscillink_tpu")


def load_json(path: Path) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path):
    """Import a Python file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path = BENCH_DIR

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's metrics: end-to-end with ``trace`` 0, per-layer with 1.
        An end-to-end metric belongs to the cells its ``workloads`` lists,
        or to every cell without it; a per-layer metric to the cells its
        ``workloads`` lists, which every entry gives."""
        if trace:
            return [m for m in self.per_layer if self.name in m["workloads"]]
        return [m for m in self.end_to_end if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` (or of ``bench``)
    with its files, found under ``root`` and its ``portbench/``."""
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    bench_dir = root / BENCH_DIR.name
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench_dir / "checks" / f"{name}.json")
    return Cell(name, int(w["chips"]), config, traffic, limits, bench["end_to_end"],
                bench["per_layer"], bench_dir)


@dataclass
class Run:
    """What a run records, for the metric readers: host-clock latencies of
    the window's queries (None for a failed one), the window's length, the
    harness's spans of set-up (name -> seconds) and of the window's queries
    (name -> list of seconds), the program's counters
    (name -> list of numbers, one per query or per event) and, in a traced
    run, the reduced device trace."""

    config: dict
    setup_s: float = 0.0
    latencies: list = field(default_factory=list)
    window_s: float = 0.0
    setup_spans: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    trace: Optional[dict] = None

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def count(self, name: str, value: float) -> None:
        self.counters.setdefault(name, []).append(value)


def nearest_rank(values: list, q: float) -> float:
    """The q-quantile by nearest rank: the ceil(q n)-th smallest value."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def read_metrics(cell: Cell, run: Run, trace: bool) -> dict:
    """{name: {"value", "unit"}} of each of the cell's metrics whose reader
    finds something to read."""
    out = {}
    for m in cell.metrics(trace):
        value = load_module(cell.bench_dir / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of `FORBIDDEN_MODULES`: ``oscillink_tpu_torch`` is not
    ``oscillink_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def judge(checks: dict, limits: dict) -> bool:
    """True when every compared number is at most its limit, and no limit
    lacks its number."""
    return all(k in checks and checks[k] <= limits[k] for k in limits)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, limits: dict, breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": _finite(checks.get(k)), "limit": limits[k]} for k in limits}
    return json.dumps(out)


def _finite(x):
    """A number as JSON can carry it: a non-finite one as its name."""
    return x if x is None or math.isfinite(x) else str(x)
