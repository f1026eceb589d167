"""The service path of `service.System`, each request split by the port's
own spans: ``POST <route>`` through the in-process ``LocalClient``, one
fresh candidate set per request, run under the port's span recorder.

A request's spans become the run's counters: ``large_build_ms`` (the
``service.build`` span: Y to the card, its hash, the graph build with its
top-k and the edge count's read), ``large_topk_ms`` (``graph.topk``, the
top-k scan inside the build) and ``large_solve_ms`` (``service.settle``
plus ``service.bundle``).  The program's count of top-k routes
(``ops/graph.py`` ``topk_routes``) is read before and after each request.
A program without a span or the route count, as one from before they were
added, adds none of what it lacks.  While a profiler runs (the first
seconds of a traced run) the requests record no program span, as
`lattice_batch` says why.  After the window one JSON line on standard
error gives, in all and by candidate-set size, the window's requests, the
top-k routes they took, and their mean milliseconds: the request on the
host clock, its parse where the run is traced (`service.System`'s parse
clock), and the spans above where they were recorded.

For a sampled request the check also reads the graph its program built
(`_graph_catch`): `compare_large` judges that graph against the exact
mutual graph up to float32's ties, and the bundle on its edges."""

from __future__ import annotations

import contextlib
import json
import statistics
import sys

import torch

from .. import compare_large, reference
from . import service
from .lattice_batch import _profiler_on

ROUTES = ("dense", "blocked", "blocked_fast")
PARTS = {"build_ms": "large_build_ms", "topk_ms": "large_topk_ms",
         "solve_ms": "large_solve_ms"}


def _route_counts():
    """The program's top-k route counter (``ops.graph.topk_routes``), or
    None where the program has none."""
    from oscillink_tpu_torch.ops import graph

    return getattr(graph, "topk_routes", None)


class System(service.System):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.window: list = []  # the window's requests: size, routes, milliseconds

    def prepare(self, i: int, stream: str, snap) -> dict:
        return {**super().prepare(i, stream, snap), "stream": stream}

    def call(self, prep: dict) -> dict:
        from oscillink_tpu_torch.utils import profiling

        counts = _route_counts()
        before = None if counts is None else dict(counts)
        rec_ctx = contextlib.nullcontext() if _profiler_on() else profiling.recording()
        with rec_ctx as rec, self._graph_catch(prep["snap"]) as caught:
            res = super().call(prep)
        res["spans"] = [] if rec is None else rec.spans
        res["routes"] = None if counts is None else {
            key: counts.get(key, 0) - before.get(key, 0) for key in ROUTES}
        res["graph"] = caught[0]
        return res

    @contextlib.contextmanager
    def _graph_catch(self, snap):
        """For a sampled request, the graph its program built, (idx, w) held
        by ``snap`` (off the peak): the port's request lattice's, from
        ``api._build_lattice``, or the plain reference's standing in
        (``reference.build_graph``), wrapped from outside as
        `service.System._parse_clock` wraps the parse; None otherwise."""
        caught = [None]
        if snap is None:
            yield caught
            return
        from oscillink_tpu_torch.service import api

        saved = (api._build_lattice, reference.build_graph)

        def build_lattice(*args, **kwargs):
            out = saved[0](*args, **kwargs)
            g = out[0]._graph
            caught[0] = (snap.hold(g.idx), snap.hold(g.w))
            return out

        def build_graph(*args, **kwargs):
            g = saved[1](*args, **kwargs)
            caught[0] = (g.idx, g.w)
            return g

        api._build_lattice, reference.build_graph = build_lattice, build_graph
        try:
            yield caught
        finally:
            api._build_lattice, reference.build_graph = saved

    def after(self, prep: dict, res: dict) -> None:
        super().after(prep, res)
        if prep["snap"] is not None:
            self.samples[-1]["graph"] = res["graph"]
        parts = self._count(res["spans"])
        if prep["stream"] == "queries":
            if res["parse_s"] is not None:
                parts["parse_ms"] = 1e3 * res["parse_s"]
            self.window.append({"rows": len(self.rows[prep["entry"]]), "routes": res["routes"],
                                "request_ms": 1e3 * res["seconds"], **parts})

    def _count(self, spans: list) -> dict:
        """The request's counters from its spans; returns them by part."""
        ms: dict = {}
        for s in spans:
            ms[s.name] = ms.get(s.name, 0.0) + s.ms
        parts = {}
        if "service.build" in ms:
            parts["build_ms"] = ms["service.build"]
        if "graph.topk" in ms:
            parts["topk_ms"] = ms["graph.topk"]
        if "service.settle" in ms and "service.bundle" in ms:
            parts["solve_ms"] = ms["service.settle"] + ms["service.bundle"]
        for part, value in parts.items():
            self.run.count(PARTS[part], value)
        return parts

    def window_totals(self) -> dict:
        """The window's requests, in all and by candidate-set size: how many,
        how many recorded their spans, the routes they took (None without
        the program's count) and their mean milliseconds."""
        def totals(reqs: list) -> dict:
            routed = [r["routes"] for r in reqs if r["routes"] is not None]
            out = {"requests": len(reqs),
                   "recorded": sum("build_ms" in r for r in reqs),
                   "routes": ({key: sum(r[key] for r in routed) for key in ROUTES}
                              if routed else None)}
            for part in ("request_ms", "parse_ms", *PARTS):
                values = [r[part] for r in reqs if part in r]
                if values:
                    out[part] = statistics.fmean(values)
            return out

        sizes = sorted({r["rows"] for r in self.window})
        return {**totals(self.window),
                "by_rows": {str(n): totals([r for r in self.window if r["rows"] == n])
                            for n in sizes}}

    def release(self) -> None:
        print(json.dumps({"large_window": self.window_totals()}), file=sys.stderr, flush=True)
        super().release()

    def check(self) -> dict:
        Y = torch.from_numpy(self.Y).to(self.device)
        return compare_large.service_checks(Y, self.cfg, self.samples)
