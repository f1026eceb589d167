"""The library path over a corpus whose graph the cluster tier builds: from
500,000 rows ``similarity="auto"`` takes the gated IVF build of
``oscillink_tpu_torch/ops/ivf.py``.  The queries are `lattice.System`'s.
The lattice is built under the port's span recorder, so the set-up holds
the seconds of ``lattice.graph`` and the ``ivf.*`` stages; the build's
``similarity_info`` and the lattice's ``ivf_*`` counters go to standard
error as one JSON line; the check is `compare_ivf`'s, for an approximate
graph."""

from __future__ import annotations

import json
import sys
import time

import torch

from .. import compare_ivf
from . import lattice

BUILD_SPANS = ("lattice.graph", "ivf.pregate", "ivf.kmeans", "ivf.scan", "ivf.quality")
IVF_STATS = ("ivf_builds", "ivf_fallbacks", "ivf_overflow_rows", "ivf_patched_rows")


def recorded(program, run):
    """``program`` run under the port's span recorder; the seconds of its
    build spans are added to ``run.setup_spans`` by name.  A program
    without such spans adds nothing."""
    from oscillink_tpu_torch.utils import profiling

    def build(Y, cfg: dict, device: torch.device):
        t0 = time.perf_counter_ns()
        with profiling.recording() as rec:
            lat = program(Y, cfg, device)
        for s in rec.spans:
            if s.name in BUILD_SPANS and s.start_ns >= t0:
                run.setup_spans[s.name] = run.setup_spans.get(s.name, 0.0) + 1e-9 * (
                    s.end_ns - s.start_ns)
        return lat

    return build


class System(lattice.System):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, run,
                 traced: bool, program=lattice.build_program):
        super().__init__(cfg, traffic, seed, device, run, traced, program=recorded(program, run))
        self.info = getattr(self.lat, "_similarity_info", None)
        stats = getattr(self.lat, "stats", {})
        self.ivf_stats = {key: stats[key] for key in IVF_STATS if key in stats}
        print(json.dumps({"similarity_info": self.info, "stats": self.ivf_stats}),
              file=sys.stderr, flush=True)

    def check(self) -> dict:
        Y = torch.from_numpy(self.Y).to(self.device)
        return compare_ivf.lattice_ivf_checks(Y, self.cfg, self.traffic,
                                              {"graph": self.graph, "info": self.info,
                                               "queries": self.samples})
