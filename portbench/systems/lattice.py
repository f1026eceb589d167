"""The library path: one ``OscillinkLattice`` over a standing corpus, and
each query runs the traffic's steps on it (``set_query``, ``settle``,
``receipt``, ``bundle``), as a RAG application's request thread calls the
library.  U carries over from query to query."""

from __future__ import annotations

import gc
import time

import torch

from .. import compare, data
from ..run_support import sync


def build_program(Y, cfg: dict, device: torch.device):
    """The system under test: the port's lattice over the corpus."""
    import oscillink_tpu_torch as ot

    return ot.OscillinkLattice(Y, kneighbors=cfg["kneighbors"], similarity=cfg["similarity"],
                               device=device)


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, run,
                 traced: bool, program=build_program):
        self.cfg, self.traffic, self.run, self.traced = cfg, traffic, run, traced
        self.device = device
        self.steps = [(name, dict(kw)) for name, kw in traffic["steps"]]
        self.settles = any(name == "settle" for name, _ in self.steps)
        corpus = cfg["corpus"]
        Y, centres = data.study_corpus(corpus, seed, device)
        topics = data.pool_topics(corpus, seed, device)
        self.streams = {s: data.Queries(centres, topics, corpus["query_noise"], seed, s)
                        for s in ("warmup", "queries")}
        self.Y = Y.cpu().numpy()
        del Y
        sync(device)
        t0 = time.perf_counter()
        self.lat = program(self.Y, cfg, device)
        sync(device)
        run.setup_spans["graph.build"] = time.perf_counter() - t0
        g = self.lat.graph
        self.graph = (g.idx.cpu(), g.w.cpu())
        if traced:
            self._label_ustar()
        self.samples: list = []
        self.chain: list = []  # every query's psi in the order called, where U carries over
        self._seen_ustar = None

    def _label_ustar(self) -> None:
        """Put the U* solve, which ``bundle`` and ``receipt`` run inside, in
        a span of its own in the trace."""
        from torch.profiler import record_function

        inner = self.lat._solve_ustar_device

        def labelled(*args, **kwargs):
            with record_function("ustar"):
                return inner(*args, **kwargs)

        self.lat._solve_ustar_device = labelled

    def prepare(self, i: int, stream: str, snap) -> dict:
        return {"psi": self.streams[stream][i], "snap": snap}

    def call(self, prep: dict) -> dict:
        from torch.profiler import record_function

        lat, out, timed = self.lat, {}, []
        for name, kw in self.steps:
            t0 = time.perf_counter()
            with record_function(name):
                if name == "set_query":
                    lat.set_query(prep["psi"])
                else:
                    out[name] = getattr(lat, name)(**kw)
            solve = lat.last_ustar if lat.last_ustar is not self._seen_ustar else None
            self._seen_ustar = lat.last_ustar
            timed.append((name, time.perf_counter() - t0, solve))
        out["_timed"] = timed
        return out

    def after(self, prep: dict, res: dict) -> None:
        run = self.run
        for name, seconds, solve in res.pop("_timed"):
            run.span(name, seconds)
            if solve is not None:
                run.count("ustar_solve_ms", solve["solve_ms"])
                run.count("ustar_iters", solve["iters"])
            if name in ("receipt", "bundle"):  # the step's own work, less the U* it solved
                run.count(f"{name}_ms", 1e3 * seconds - (solve["solve_ms"] if solve else 0.0))
        if self.settles:
            self.chain.append(prep["psi"])
        snap = prep["snap"]
        if snap is None:
            return
        q = {"psi": prep["psi"], "bundle": res["bundle"],
             "ustar": snap.hold(self.lat._Ustar_cache_dev)}
        if self.settles:
            q["at"], q["u_settled"] = len(self.chain) - 1, snap.hold(self.lat._U_dev)
        if "receipt" in res:
            q["receipt"] = {key: res["receipt"][key] for key in ("deltaH_total", "null_points")}
        self.samples.append(q)

    def release(self) -> None:
        del self.lat
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        Y = torch.from_numpy(self.Y).to(self.device)
        return compare.lattice_checks(Y, self.cfg, self.traffic,
                                      {"graph": self.graph, "chain": self.chain,
                                       "queries": self.samples})
