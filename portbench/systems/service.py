"""The service path: ``POST <route>`` through the port's in-process
``LocalClient`` (the real handlers, no socket), one fresh candidate set per
request.  Set-up serialises a pool of candidate sets once; each request
splices a fresh psi into one of them, in the traffic's stratified order of
sizes."""

from __future__ import annotations

import contextlib
import gc
import json
import time

import torch

from .. import compare, data
from ..run_support import sync


class ServiceError(RuntimeError):
    pass


def build_program(cfg: dict, device: torch.device):
    """The system under test: the port's service with its defaults, behind
    its in-process client."""
    from oscillink_tpu_torch.service import LocalClient, create_state

    return LocalClient(create_state(device=device))


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, run,
                 traced: bool, program=build_program):
        self.cfg, self.traffic, self.run, self.traced = cfg, traffic, run, traced
        self.device = device
        corpus, pool = cfg["corpus"], traffic["pool"]
        Y, centres = data.study_corpus(corpus, seed, device)
        topics = data.pool_topics(corpus, seed, device)
        sizes = data.stratified_sizes(pool["n_min"], pool["n_max"], pool["sets"])
        self.rows = [r.cpu() for r in data.candidate_sets(Y, centres, topics, sizes, seed)]
        self.order = data.stratified_order(pool["sets"], pool["strata"], seed)
        self.streams = {s: data.Queries(centres, topics, corpus["query_noise"], seed, s)
                        for s in ("warmup", "queries")}
        self.Y = Y.cpu().numpy()
        del Y
        sync(device)
        t0 = time.perf_counter()
        self.bodies = [
            json.dumps({"Y": self.Y[rows.numpy()].tolist(), **cfg["request"]})[:-1].encode()
            + b', "psi": ' for rows in self.rows]
        run.setup_spans["bodies"] = time.perf_counter() - t0
        self.client = program(cfg, device)
        self.samples: list = []

    def entry(self, i: int, stream: str) -> int:
        if stream == "warmup":  # the smallest, a middle and the largest set
            return self.traffic["warmup_sets"][i]
        return self.order[i % len(self.order)]

    def prepare(self, i: int, stream: str, snap) -> dict:
        e = self.entry(i, stream)
        psi = self.streams[stream][i]
        return {"psi": psi, "entry": e, "snap": snap,
                "body": self.bodies[e] + json.dumps(psi.tolist()).encode() + b"}"}

    def call(self, prep: dict) -> dict:
        from torch.profiler import record_function

        with record_function("request"), self._parse_clock() as parse:
            t0 = time.perf_counter()
            resp = self.client.request("POST", self.cfg["route"], data=prep["body"])
            seconds = time.perf_counter() - t0
        if resp.status_code != 200:
            raise ServiceError(f"{self.cfg['route']}: {resp.status_code} {str(resp.json())[:300]}")
        return {"body": resp.json(), "seconds": seconds, "parse_s": parse[0]}

    @contextlib.contextmanager
    def _parse_clock(self):
        """In a traced run, the seconds the service spends parsing the request
        (JSON decode ``ApiRequest.json``, validation ``api._parse``, array
        conversion ``api._np_array_or_400``), wrapped from outside as
        ``chip_smoke.py:parse_clock`` does; None otherwise."""
        spent = [None]
        if not self.traced:
            yield spent
            return
        from oscillink_tpu_torch.service import api

        saved = (api.ApiRequest.json, api._parse, api._np_array_or_400)
        spent[0] = 0.0

        def timed(fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spent[0] += time.perf_counter() - t0
            return call

        api.ApiRequest.json, api._parse, api._np_array_or_400 = (timed(fn) for fn in saved)
        try:
            yield spent
        finally:
            api.ApiRequest.json, api._parse, api._np_array_or_400 = saved

    def after(self, prep: dict, res: dict) -> None:
        self.run.span("request", res["seconds"])
        if res["parse_s"] is not None:
            self.run.count("parse_s", res["parse_s"])
        if prep["snap"] is not None:
            self.samples.append({"rows": self.rows[prep["entry"]], "psi": prep["psi"],
                                 "bundle": res["body"]["bundle"]})

    def release(self) -> None:
        del self.client
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        Y = torch.from_numpy(self.Y).to(self.device)
        return compare.service_checks(Y, self.cfg, self.samples)
