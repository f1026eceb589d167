"""The control of the correctness check: the plain reference put in the
program's place and computed one precision below the configuration's
float32 (TF32: every matmul's inputs rounded to 10 mantissa bits), driven
through the cell's own run (`run.run_cell`: the same set-up, window, sample
and check) for a short window.  Its numbers, held to the cell's limits
(``checks/<workload>.json``), must come out not correct.  The benchmark's
runs do not run it.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--precision tf32] [--seconds 20]

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
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import reference as ref  # noqa: E402
from portbench.harness import Cell  # noqa: E402


def _bundle(g, Y, Us, psi, lam, k: int, alpha: float, precision: str) -> list:
    score, align = ref.bundle_scores(g, Y, Us, psi, lam, alpha, precision)
    picks = ref.mmr(ref.normalize(Y), score, k, precision)
    return [{"id": p, "score": float(score[p]), "align": float(align[p])} for p in picks]


class RefLattice:
    """The reference with the lattice's surface as the lattice system drives
    it: ``set_query``, ``settle``, ``receipt``, ``bundle``, the graph, U, the
    cached U* and the last U* solve's stats."""

    def __init__(self, Y, cfg: dict, device, precision: str):
        self.Y = torch.as_tensor(Y, device=device)
        self.lam, self.precision = ref.Lam(*cfg["lam"]), precision
        self.graph = ref.build_graph(self.Y, cfg["kneighbors"], cfg["similarity"], precision)
        self._U_dev, self._Ustar_cache_dev, self.last_ustar = self.Y.clone(), None, None

    def set_query(self, psi) -> None:
        self.psi = torch.as_tensor(psi, device=self.Y.device)
        self._Ustar_cache_dev = None

    def settle(self, dt: float = 1.0, max_iters: int = 12, tol: float = 1e-3) -> dict:
        self._U_dev = ref.settle(self.graph, self._U_dev, self.Y, self.psi, self.lam, dt, tol,
                                 max_iters)
        return {}

    def _ustar(self) -> torch.Tensor:
        if self._Ustar_cache_dev is None:
            t0, lam = time.perf_counter(), self.lam
            self._Ustar_cache_dev, iters = ref.cg(
                lambda X: ref.m_apply(self.graph, lam, X), ref.rhs(self.Y, self.psi, lam), self.Y,
                lam.G + lam.Q, 1e-4, 64)
            self.last_ustar = {"solve_ms": 1e3 * (time.perf_counter() - t0), "iters": iters}
        return self._Ustar_cache_dev

    def receipt(self) -> dict:
        Us = self._ustar()
        flag, j = ref.null_points(self.graph, Us, self.lam)
        rows = flag.nonzero()[:, 0]
        return {"deltaH_total": ref.delta_h(self.graph, self._U_dev, Us, self.lam),
                "null_points": [{"edge": [a, b]} for a, b in zip(rows.tolist(), j[rows].tolist())]}

    def bundle(self, k: int = 8, alpha: float = 0.5) -> list:
        return _bundle(self.graph, self.Y, self._ustar(), self.psi, self.lam, k, alpha,
                       self.precision)


class RefClient:
    """The reference with the service client's surface: a ``/v1/bundle``
    body in, the response's bundle out."""

    def __init__(self, cfg: dict, device, precision: str):
        self.cfg, self.device, self.precision = cfg, device, precision

    def request(self, method: str, path: str, data: bytes):
        body, cfg = json.loads(data), self.cfg
        Y = torch.tensor(body["Y"], dtype=torch.float32, device=self.device)
        psi = torch.tensor(body["psi"], dtype=torch.float32, device=self.device)
        lam = ref.Lam(*cfg["lam"])
        g = ref.build_graph(Y, cfg["kneighbors"], cfg["similarity"], self.precision)
        Us = ref.ustar(g, Y, psi, lam)
        out = {"bundle": _bundle(g, Y, Us, psi, lam, body["bundle_k"], 0.5, self.precision)}
        return SimpleNamespace(status_code=200, json=lambda: out)


def stand_in(cell: Cell, precision: str):
    """The reference as the cell's program, in ``precision``."""
    if cell.config["system"] == "lattice":
        return lambda Y, cfg, device: RefLattice(Y, cfg, device, precision)
    return lambda cfg, device: RefClient(cfg, device, precision)


def control(cell: Cell, seed: int, device, precision: str = "tf32", seconds: float = 20.0) -> dict:
    """The numbers that the cell's run, with the reference in ``precision``
    standing in for the program, compares with their limits."""
    from portbench.run import run_cell

    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(cell, seed, seconds, False, device, time.perf_counter(), out, err,
                  program=stand_in(cell, precision))
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
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = control(cell, seed, torch.device("cuda", 0), args.precision, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": args.precision,
                          "passes": harness.judge(nums, cell.limits), "numbers": nums}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
