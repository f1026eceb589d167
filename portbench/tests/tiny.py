"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
the tests: the corpus at N rows of 64 columns about 64 centres, the fast
scan forced on the lattice, a pool of 16 sets of 40-200 rows."""

from __future__ import annotations

import io
import json
import time
from pathlib import Path

import torch

from portbench import harness
from portbench.run import run_cell

SEED = 2**31 + 77


def shrink(c: harness.Cell, n: int = 3000) -> harness.Cell:
    c.config["corpus"].update(n=n, d=64, centres=64)
    if c.config["system"] == "lattice":
        c.config["similarity"] = "fast"
    else:
        c.traffic["pool"].update(sets=16, strata=4, n_min=40, n_max=200)
        c.traffic["warmup_sets"] = [0, 8, 15]
    return c


def cell(name: str, n: int = 3000, root: Path = harness.ROOT) -> harness.Cell:
    return shrink(harness.load_cell(name, root=root), n)


def run(c: harness.Cell, seconds: float = 0.5, trace: bool = False, seed: int = SEED):
    """Run the cell on the CPU: (exit code, result line or None, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(c, seed, seconds, trace, torch.device("cpu"), time.perf_counter(), out, err)
    lines = out.getvalue().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None), err.getvalue()
