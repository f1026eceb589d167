"""Wall time of the port's CG loop on the card: the lattice's U* solve
(`solve_Ustar(use_cache=False)`, `ops/solver.py` under it) at chip_smoke.py's
headline (5000 x 128 x k6) and corpus (131072 x 768 x k8) shapes.

    python3 scripts/time_ustar_solve.py [--repo PATH]

``--repo`` times the package of another checkout (a parent unpacked with
``git archive`` for a comparison in one call); by default this checkout's.
For each shape it builds one lattice, runs one warm solve, then 60
solves at the headline and 12 at the corpus, each ended by a sync, and
prints one JSON line: the median and the other quantiles of the wall
time, the solve's iterations and the package it timed.  Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

SHAPES = {"headline": (5000, 128, 6, 60), "corpus": (131072, 768, 8, 12)}  # n, d, k, reps


def _data(n: int, d: int, seed: int = 0):
    """Gaussian anchors and psi = the normalized mean of 32 rows."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d), dtype=np.float32)
    m = Y[:32].mean(axis=0)
    return Y, (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    import oscillink_tpu_torch as pt

    if not torch.cuda.is_available():
        print("time_ustar_solve: no CUDA card", file=sys.stderr)
        return 1
    for name, (n, d, k, reps) in SHAPES.items():
        Y, psi = _data(n, d)
        lat = pt.Oscillink(Y, kneighbors=k)
        lat.set_query(psi)
        lat.solve_Ustar(use_cache=False)
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            lat._solve_ustar_device(use_cache=False)
            torch.cuda.synchronize()
            ms.append(1000.0 * (time.perf_counter() - t0))
        q = statistics.quantiles(ms, n=4)
        print(json.dumps({"shape": name, "n": n, "d": d, "k": k, "reps": len(ms),
                          "median_ms": statistics.median(ms), "q1_ms": q[0], "q3_ms": q[2],
                          "min_ms": min(ms), "iters": lat.last_ustar["iters"],
                          "package": os.path.dirname(pt.__file__)}), flush=True)
        del lat
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
