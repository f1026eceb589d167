"""The control and the planted faults of a cell whose graph is approximate
(``systems/lattice_ivf.py``), each put in the program's place and driven
through the cell's own run (`run.run_cell`: the same set-up, window,
sample and check) for a short window.  Their numbers, held to the cell's
limits (``checks/<workload>.json``), must come out not correct.  The
benchmark's runs do not run it.

    python3 portbench/control_ivf.py --workload <cell> --seeds 1,2,3 \\
        [--stand-in tf32|m_probe1|no_balance] [--seconds 20]

* ``tf32``: the plain reference one precision below the configuration's
  float32 (`control.RefLattice`, every matmul's inputs rounded to TF32);
* ``m_probe1``: the port with its IVF build probing one cluster a row;
* ``no_balance``: the port with the IVF build's balance rounds off.

prints one JSON line a seed with the numbers and whether they pass.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import control, harness  # noqa: E402
from portbench.harness import Cell  # noqa: E402
from portbench.systems import lattice  # noqa: E402

FAULTS = {"m_probe1": {"m_probe": 1}, "no_balance": {"balance_rounds": 0}}


def faulty(overrides: dict):
    """The port's lattice, its IVF build called with ``overrides`` over the
    arguments the lattice passes."""
    def program(Y, cfg: dict, device):
        from oscillink_tpu_torch.ops import ivf

        orig = ivf.build_graph_ivf

        def build(*args, **kwargs):
            return orig(*args, **{**kwargs, **overrides})

        ivf.build_graph_ivf = build
        try:
            return lattice.build_program(Y, cfg, device)
        finally:
            ivf.build_graph_ivf = orig

    return program


def stand_in(name: str):
    if name == "tf32":
        return lambda Y, cfg, device: control.RefLattice(Y, cfg, device, "tf32")
    return faulty(FAULTS[name])


def numbers(cell: Cell, seed: int, device, name: str, seconds: float) -> dict:
    """The numbers that the cell's run, with stand-in ``name`` in the
    program's place, compares with their limits."""
    from portbench.run import run_cell

    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(cell, seed, seconds, False, device, time.perf_counter(), out, err,
                  program=stand_in(name))
    if rc != 0:
        raise RuntimeError(f"the stand-in's run exited {rc}: {err.getvalue()[-2000:]}")
    checks = json.loads(out.getvalue().splitlines()[-1])["checks"]
    return {k: (math.inf if c["value"] is None else float(c["value"])) for k, c in checks.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--stand-in", default="tf32", choices=["tf32", *FAULTS])
    ap.add_argument("--seconds", type=float, default=20.0, help="the stand-in's window")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control_ivf: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = numbers(cell, seed, torch.device("cuda", 0), args.stand_in, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "stand_in": args.stand_in,
                          "passes": harness.judge(nums, cell.limits), "numbers": nums}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
