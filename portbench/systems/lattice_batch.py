"""Micro-batched re-ranking over a standing corpus: one ``OscillinkLattice``
built as `lattice.System` builds it, and each call one ``bundle_batch`` of
the configuration's ``batch`` queries, as ``POST /v1/settle/batch`` calls
the library.  Call i takes queries batch·i … batch·i + batch − 1 of its
stream.

Each call runs under the port's span recorder.  Its spans and the
lattice's ``last_ustar_batch`` become the run's counters:
``batch_ustar_ms`` (the ``lattice.ustar_batch`` span),
``batch_ms_per_iter`` (that over the solve's ``loop_iters``),
``batch_bundle_ms`` (``lattice.bundle_batch`` less ``lattice.ustar_batch``)
and, a call, the solve's ``fused``, ``classic`` and select iterations
(those in which some lane had stopped).  A program without those spans or
keys adds none of them.  While a profiler runs (the first seconds of a
traced run) the calls record no program span: under a profiler each span
enters ``record_function``, whose mirror on the device's timeline the
trace's reduction would count as busy time.  After the window one JSON
line on standard error gives the window's iteration totals.

For a sampled call the check reads, lane by lane, the queries, the bundles
and each lane's U* (held by `Snapshots`, off the peak); `compare_batch`
holds each lane to the single-query reference."""

from __future__ import annotations

import contextlib
import json
import sys

import numpy as np
import torch

from .. import compare_batch
from . import lattice

LOOP_KEYS = ("fused", "classic", "select")


def _profiler_on() -> bool:
    from torch._C._autograd import _profiler_enabled

    return _profiler_enabled()


class System(lattice.System):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, run,
                 traced: bool, program=lattice.build_program):
        self.batch = int(cfg["batch"])
        self.kw = dict(traffic["bundle_batch"])
        super().__init__(cfg, {**traffic, "steps": []}, seed, device, run, traced,
                         program=program)
        self.traffic = traffic
        self._solved = None
        inner = self.lat._solve_batch_device

        def solve(*args, **kwargs):
            from torch.profiler import record_function

            with record_function("ustar") if traced else contextlib.nullcontext():
                self._solved = out = inner(*args, **kwargs)
            return out

        self.lat._solve_batch_device = solve

    def prepare(self, i: int, stream: str, snap) -> dict:
        q = self.streams[stream]
        return {"psis": np.stack([q[self.batch * i + j] for j in range(self.batch)]),
                "snap": snap}

    def call(self, prep: dict) -> dict:
        from torch.profiler import record_function

        from oscillink_tpu_torch.utils import profiling

        rec_ctx = contextlib.nullcontext() if _profiler_on() else profiling.recording()
        with rec_ctx as rec, record_function("bundle"):
            bundles = self.lat.bundle_batch(prep["psis"], **self.kw)
        return {"bundles": bundles, "spans": [] if rec is None else rec.spans,
                "solve": self.lat.last_ustar_batch}

    def after(self, prep: dict, res: dict) -> None:
        solved, self._solved = self._solved, None
        self._count(res["spans"], res["solve"] or {})
        snap = prep["snap"]
        if snap is None:
            return
        Ustars = solved[0]
        for q, bundle in enumerate(res["bundles"]):
            self.samples.append({"psi": prep["psis"][q], "bundle": bundle,
                                 "ustar": snap.hold(Ustars[q])})

    def _count(self, spans: list, solve: dict) -> None:
        """The call's counters from its spans and ``last_ustar_batch``."""
        run = self.run
        ms = {s.name: s.ms for s in spans}
        ustar, whole = ms.get("lattice.ustar_batch"), ms.get("lattice.bundle_batch")
        loop = solve.get("loop_iters")
        if ustar is not None:
            run.count("batch_ustar_ms", ustar)
            if loop:
                run.count("batch_ms_per_iter", ustar / loop)
            if whole is not None:
                run.count("batch_bundle_ms", whole - ustar)
        if loop is not None and "fused" in solve:
            run.count("batch_fused", solve["fused"])
            run.count("batch_classic", solve["classic"])
            run.count("batch_select", loop - min(solve["iters"], default=0))

    def release(self) -> None:
        counters = self.run.counters
        totals = {key: (sum(counters[f"batch_{key}"]) if f"batch_{key}" in counters else None)
                  for key in LOOP_KEYS}
        print(json.dumps({"batch": self.batch, "calls": len(self.run.latencies),
                          "iterations": totals}), file=sys.stderr, flush=True)
        self._solved = None
        super().release()

    def check(self) -> dict:
        Y = torch.from_numpy(self.Y).to(self.device)
        return compare_batch.lattice_batch_checks(Y, self.cfg, self.traffic,
                                                  {"graph": self.graph,
                                                   "queries": self.samples})
