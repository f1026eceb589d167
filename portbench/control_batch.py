"""The control of a cell of batched queries (``systems/lattice_batch.py``):
the plain reference put in the program's place and computed one precision
below the configuration's float32 (TF32: every matmul's inputs rounded to
10 mantissa bits), driven through the cell's own run (`run.run_cell`: the
same set-up, window, sample and check) for a short window.  Its numbers,
held to the cell's limits (``checks/<workload>.json``), must come out not
correct.  The benchmark's runs do not run it.

    python3 portbench/control_batch.py --workload <cell> --seeds 1,2,3 [--precision tf32] [--seconds 20]

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
from portbench import reference as ref  # noqa: E402
from portbench.harness import Cell  # noqa: E402


class RefBatchLattice(control.RefLattice):
    """The reference with the batched lattice's surface as the batch system
    drives it: ``bundle_batch`` over ``_solve_batch_device`` (each lane the
    reference's single solve), the graph and ``last_ustar_batch``."""

    last_ustar_batch = None

    def _solve_batch_device(self, psis, gates, tol: float, max_iters: int):
        if gates is not None:
            raise ValueError("the reference's lattice has gates of one")
        psis_d = torch.as_tensor(psis, device=self.Y.device)
        t0, lam, lanes = time.perf_counter(), self.lam, []
        for psi in psis_d:
            lanes.append(ref.cg(lambda X: ref.m_apply(self.graph, lam, X),
                                ref.rhs(self.Y, psi, lam), self.Y, lam.G + lam.Q, tol, max_iters))
        iters = [it for _, it in lanes]
        self.last_ustar_batch = {"solve_ms": 1e3 * (time.perf_counter() - t0), "iters": iters}
        return torch.stack([x for x, _ in lanes]), psis_d

    def bundle_batch(self, psis, gates=None, k: int = 8, alpha: float = 0.5) -> list:
        Ustars, psis_d = self._solve_batch_device(psis, gates, 1e-4, 64)
        return [control._bundle(self.graph, self.Y, Us, psi, self.lam, k, alpha, self.precision)
                for Us, psi in zip(Ustars, psis_d)]


def stand_in(precision: str):
    """The reference as the batch cell's program, in ``precision``."""
    return lambda Y, cfg, device: RefBatchLattice(Y, cfg, device, precision)


def numbers(cell: Cell, seed: int, device, precision: str = "tf32",
            seconds: float = 20.0) -> dict:
    """The numbers that the cell's run, with the reference in ``precision``
    standing in for the program, compares with their limits."""
    from portbench.run import run_cell

    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(cell, seed, seconds, False, device, time.perf_counter(), out, err,
                  program=stand_in(precision))
    if rc != 0:
        raise RuntimeError(f"the control's run exited {rc}: {err.getvalue()[-2000:]}")
    checks = json.loads(out.getvalue().splitlines()[-1])["checks"]
    return {k: (math.inf if c["value"] is None else float(c["value"])) for k, c in checks.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default="tf32")
    ap.add_argument("--seconds", type=float, default=20.0, help="the control run's window")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control_batch: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = numbers(cell, seed, torch.device("cuda", 0), args.precision, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": args.precision,
                          "passes": harness.judge(nums, cell.limits), "numbers": nums}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
