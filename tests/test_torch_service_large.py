"""The service's largest requests on the CPU, as the
``rag_svc_large.bundle_large`` cell sends them at full size on the card.

The port's service (``LocalClient`` over ``create_state(device="cpu")``)
answers ``POST /v1/bundle`` at 4100 rows x 32 (the exact scan's row
blocks, past its 4096-row dense limit) and at 1000 rows (one [N, N]
product), both at k 6, within the cell's limits of the plain reference
(``portbench/checks/rag_svc_large.bundle_large.json``): its graph against
the exact mutual graph up to float32's ties and its bundle on that graph's
edges (`compare_large`), and its bundle against the reference's own graph
(`compare.service_checks`).  `compare_large` lets a near tie go either
way and fails a planted wrong edge, one-sided edge, weight or score.
Each request's graph build records one ``graph.topk`` span inside its
``service.build`` under the span recorder, and ``ops.graph.topk_routes``
counts the route it took.  The blocked and dense scans select the same
neighbours, ties to the lower index.  The cell's system module
(``portbench/systems/service_spans.py``) turns a request's spans and route
counts into the counters that ``large.build_ms``, ``large.topk_ms`` and
``large.solve_ms`` read, and leaves out what a program without the span
or the count cannot give.  At the HTTP front a body over
``OSCILLINK_MAX_BODY_BYTES`` gets 413."""

import asyncio
import contextlib
import json
import statistics

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu_torch.ops import graph as graph_mod  # noqa: E402
from oscillink_tpu_torch.ops.graph import (  # noqa: E402
    DENSE_TOPK_LIMIT,
    _topk_blocked,
    _topk_dense,
    normalize_rows,
)
from oscillink_tpu_torch.service import LocalClient, create_state  # noqa: E402
from oscillink_tpu_torch.utils import profiling  # noqa: E402
from oscillink_tpu_torch.service import api  # noqa: E402
from portbench import compare, compare_large, control, data, harness  # noqa: E402
from portbench import reference as ref  # noqa: E402
from portbench.harness import Run  # noqa: E402
from portbench.run_support import Snapshots  # noqa: E402
from portbench.systems import service_spans  # noqa: E402

NAME = "rag_svc_large.bundle_large"
SEED = 2**31 + 25
D = 32
SIZES = (4100, 1000)
ROUTE_ENV = ("OSCILLINK_NATIVE_SMALL_N", "OSCILLINK_SHARDED_MIN_N", "OSCILLINK_API_KEYS",
             "OSCILLINK_GRAPH_CACHE_SIZE", "OSCILLINK_FAST_SIM_N", "OSCILLINK_RATE_LIMIT")
METRICS = {"large.build_ms": "large_build_ms", "large.topk_ms": "large_topk_ms",
           "large.solve_ms": "large_solve_ms"}


@pytest.fixture(scope="module")
def few_threads():
    """Two threads for this module's builds and solves: the suite's workers
    share the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def service_env():
    """The device route with its defaults: no native, mesh or graph-cache
    route, no key."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ROUTE_ENV:
            mp.delenv(name, raising=False)
        yield


def _routes() -> dict:
    return dict(graph_mod.topk_routes)


@pytest.fixture(scope="module")
def served(few_threads, service_env):
    """One request of each size through the port's service, each under the
    span recorder: its rows of a seeded clustered corpus, psi, response,
    spans and route counts."""
    cpu = torch.device("cpu")
    corpus = {"n": max(SIZES), "d": D, "centres": 64, "spread": 0.35}
    Y, centres = data.study_corpus(corpus, SEED, cpu)
    client = LocalClient(create_state(device="cpu"))
    built = []
    build_lattice = api._build_lattice

    def keep_graph(*args, **kwargs):
        out = build_lattice(*args, **kwargs)
        built.append((out[0]._graph.idx, out[0]._graph.w))
        return out

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api, "_build_lattice", keep_graph)
        for i, n in enumerate(SIZES):
            psi = data.query_chunk(centres, torch.arange(8), 0.35, SEED, "psi", i)[0]
            body = {"Y": Y[:n].tolist(), "psi": psi.tolist(), "bundle_k": 8}
            before = _routes()
            with profiling.recording() as rec:
                resp = client.post("/v1/bundle", json_body=body)
            after = _routes()
            assert resp.status_code == 200, resp.json()
            out[n] = {"rows": torch.arange(n), "psi": psi.numpy(),
                      "bundle": resp.json()["bundle"], "meta": resp.json()["meta"],
                      "graph": built[-1], "spans": rec.spans,
                      "routes": {key: after[key] - before[key] for key in after}}
    assert len(built) == len(SIZES)
    return {"Y": Y, "out": out}


@pytest.mark.parametrize("n", SIZES)
def test_the_service_is_within_the_cells_limits(served, n):
    cell = harness.load_cell(NAME)
    assert set(cell.limits) == {"graph_edges_wrong", "graph_not_mutual", "graph_w_err",
                                "bundle_gap", "bundle_score_err"}
    got = served["out"][n]
    assert got["meta"]["N"] == n and got["meta"]["kneighbors_effective"] == 6
    assert len(got["bundle"]) == cell.config["request"]["bundle_k"]
    nums = compare_large.service_checks(served["Y"], cell.config, [got])
    assert set(nums) == set(cell.limits)
    assert harness.judge(nums, cell.limits), nums
    # against the reference's own graph too: no near tie in these rows
    plain = compare.service_checks(served["Y"], cell.config, [got])
    assert all(plain[key] <= cell.limits[key] for key in plain), plain


def _faulted(served, n, fault):
    """The request of ``n`` rows with ``fault`` planted in its graph or
    bundle."""
    got = dict(served["out"][n])
    idx, w = (t.clone() for t in got["graph"])
    bundle = [dict(b) for b in got["bundle"]]
    row = int(bundle[0]["id"])
    slot = int(torch.nonzero(w[row] > 0)[0, 0])
    if fault == "far_edges":  # ten rows' first edges moved to their least similar rows
        Yn = normalize_rows(served["Y"][:n])
        for r in range(10):
            s = int(torch.nonzero(w[r] > 0)[0, 0])
            far = int(torch.argmin(Yn @ Yn[r]))
            idx[r, s], idx[far, 0], w[far, 0] = far, r, w[r, s]
    elif fault == "one_sided":
        other = int(idx[row, slot])
        w[other][idx[other] == row] = 0.0
    elif fault == "weight":
        w[row, slot] += 1e-4
    elif fault == "score":
        bundle[0]["score"] += 1e-3
    got.update(graph=(idx, w), bundle=bundle)
    return got


@pytest.mark.parametrize("fault, fails", [
    ("far_edges", "graph_edges_wrong"), ("one_sided", "graph_not_mutual"),
    ("weight", "graph_w_err"), ("score", "bundle_score_err")])
def test_a_planted_fault_fails_a_limit(served, fault, fails):
    cell = harness.load_cell(NAME)
    nums = compare_large.service_checks(served["Y"], cell.config,
                                        [_faulted(served, 1000, fault)])
    assert nums[fails] > cell.limits[fails], nums


def test_a_near_tie_may_go_either_way():
    """Rows whose k-th neighbour ties others exactly: the graph with ties
    to the lower index and the one with ties to the higher index differ,
    and both are right."""
    g = torch.Generator().manual_seed(11)
    Y = _sign_rows(400, g)
    Yn = normalize_rows(Y)
    S = Yn @ Yn.T
    S.fill_diagonal_(-torch.inf)
    k = 6
    low = ref.mutual_graph(*ref._top(S, k))
    flipped = torch.flip(S, dims=[1])  # column c is row 399 - c: ties to the higher index
    v, i = ref._top(flipped, k)
    high = ref.mutual_graph(v, 399 - i)
    assert compare.graph_numbers(high.idx, high.w, low)["graph_rows_differ"] > 0.1
    for graph in (low, high):
        assert compare_large.tie_band_numbers(Y, graph.idx, graph.w, k) == \
            {"graph_edges_wrong": 0.0}


@pytest.mark.parametrize("n", SIZES)
def test_each_build_records_one_topk_span_inside_service_build(served, n):
    spans = served["out"][n]["spans"]
    ids = {s.span_id: s for s in spans}
    (topk,) = [s for s in spans if s.name == "graph.topk"]
    parent = ids[topk.parent]
    assert parent.name == "lattice.graph"
    assert ids[parent.parent].name == "service.build"
    assert parent.start_ns <= topk.start_ns <= topk.end_ns <= parent.end_ns
    assert topk.ms > 0


@pytest.mark.parametrize("n, route", [(4100, "blocked"), (1000, "dense")])
def test_topk_routes_count_the_route_each_request_took(served, n, route):
    assert n > DENSE_TOPK_LIMIT if route == "blocked" else n <= DENSE_TOPK_LIMIT
    want = {"dense": 0, "blocked": 0, "blocked_fast": 0}
    want[route] = 1
    assert served["out"][n]["routes"] == want


def test_no_span_outside_a_recorder_and_the_route_still_counts(monkeypatch):
    opened = []
    enter = profiling._Open.__enter__

    def counted(self):
        opened.append(self.name)
        return enter(self)

    monkeypatch.setattr(profiling._Open, "__enter__", counted)
    Y = torch.randn(300, 16, generator=torch.Generator().manual_seed(5))
    before = _routes()
    graph_mod.build_graph(Y, 6)
    assert opened == [] and profiling._recorder is None
    assert profiling.span("graph.topk") is profiling._NOOP
    # the route count is a module count, as `edge_dists.launches`: it moves
    # with or without a recorder
    after = _routes()
    assert {key: after[key] - before[key] for key in after} == \
        {"dense": 1, "blocked": 0, "blocked_fast": 0}


def _sign_rows(n: int, g: torch.Generator) -> torch.Tensor:
    """Rows of four +-1 entries among D zeros: normalised, each entry is
    0 or +-0.5 and each similarity a multiple of 0.25, exact in any order
    of summation, so most rows' k-th neighbour ties others."""
    Z = torch.zeros(n, D)
    cols = torch.argsort(torch.rand(n, D, generator=g), dim=1)[:, :4]
    signs = torch.where(torch.rand(n, 4, generator=g) < 0.5, -1.0, 1.0)
    return Z.scatter_(1, cols, signs)


@pytest.mark.parametrize("rows", ["ties", "gaussian"])
@pytest.mark.parametrize("n", [4097, 4100])
def test_the_blocked_scan_selects_as_the_dense_one(few_threads, n, rows):
    g = torch.Generator().manual_seed(n)
    Y = _sign_rows(n, g) if rows == "ties" else torch.randn(n, D, generator=g)
    Yn = normalize_rows(Y)
    k = 6
    vd, id_ = _topk_dense(Yn, k)
    vb, ib = _topk_blocked(Yn, k, 1024)
    assert ib.dtype == id_.dtype == torch.int32
    assert torch.equal(ib, id_)
    if rows == "gaussian":
        # one [N, N] product against [1024, N] blocks: the f32 sums of D
        # products may round apart by an ulp or two at 1.0
        torch.testing.assert_close(vb, vd, rtol=0, atol=2.5e-7)
        return
    assert torch.equal(vb, vd)
    # exact similarities: (value desc, index asc) is the order to meet
    S = (Yn @ Yn.T).numpy()
    np.fill_diagonal(S, -np.inf)
    want = np.stack([np.lexsort((np.arange(n), -S[i]))[:k] for i in range(n)])
    assert np.array_equal(ib.numpy(), want)
    kth = vd[:, -1:]
    assert bool(((vd[:, :] >= kth).all()))
    # most rows have more candidates at their k-th value than slots
    ties = (torch.from_numpy(S) == kth).sum(dim=1) > (vd == kth).sum(dim=1)
    assert float(ties.double().mean()) > 0.5


# --- the cell's system module ------------------------------------------------


def tiny_cell() -> harness.Cell:
    """The cell at 6000 x 32 about 64 centres, two candidate sets: 1613 rows
    (dense scan) and 4200 (blocked)."""
    c = harness.load_cell(NAME)
    c.config["corpus"].update(n=6000, d=D, centres=64)
    c.traffic["pool"].update(sets=2, strata=2, n_min=1000, n_max=6770)
    c.traffic["warmup_sets"] = [0, 1]
    return c


def run_system(c: harness.Cell, program=None, requests: int = 2):
    cpu = torch.device("cpu")
    kw = {} if program is None else {"program": program}
    system = service_spans.System(c.config, c.traffic, SEED, cpu, Run(config=c.config), False,
                                  **kw)
    snap = Snapshots(cpu)
    for i in range(requests):
        prep = system.prepare(i, "queries", snap)
        system.after(prep, system.call(prep))
    return system


@pytest.fixture(scope="module")
def system(few_threads, service_env):
    return run_system(tiny_cell())


def test_the_tiny_cell_has_one_set_each_side_of_the_dense_limit():
    pool = tiny_cell().traffic["pool"]
    sizes = data.stratified_sizes(pool["n_min"], pool["n_max"], pool["sets"])
    assert sizes[0] <= DENSE_TOPK_LIMIT < sizes[1] <= 5000, sizes


def test_the_system_records_the_three_counters(system):
    c = tiny_cell()
    counters = system.run.counters
    assert all(len(counters[key]) == 2 for key in METRICS.values())
    got = harness.read_metrics(c, system.run, True)
    for metric, key in METRICS.items():
        assert got[metric] == {"value": pytest.approx(statistics.fmean(counters[key])),
                               "unit": "ms"}
        assert got[metric]["value"] > 0
    assert all(t < b for t, b in zip(counters["large_topk_ms"], counters["large_build_ms"]))
    nums = system.check()
    assert set(nums) == set(c.limits) and harness.judge(nums, c.limits), nums


def test_the_window_totals_split_by_candidate_set_size(system):
    sizes = sorted(len(r) for r in system.rows)
    window = system.window[:2]  # the fixture's two requests
    assert sorted(r["rows"] for r in window) == sizes
    saved, system.window = system.window, window
    try:
        totals = system.window_totals()
    finally:
        system.window = saved
    assert totals["requests"] == totals["recorded"] == 2
    assert totals["routes"] == {"dense": 1, "blocked": 1, "blocked_fast": 0}
    counters = system.run.counters
    assert totals["build_ms"] == pytest.approx(statistics.fmean(counters["large_build_ms"]))
    small, large = (totals["by_rows"][str(n)] for n in sizes)
    assert small["routes"] == {"dense": 1, "blocked": 0, "blocked_fast": 0}
    assert large["routes"] == {"dense": 0, "blocked": 1, "blocked_fast": 0}
    for per in (small, large):
        assert per["requests"] == per["recorded"] == 1
        assert 0 < per["topk_ms"] < per["build_ms"] < per["request_ms"]
        assert "parse_ms" not in per  # an untraced run has no parse clock


def test_a_request_under_a_profiler_records_no_span(system):
    saved = system.run
    run = system.run = Run(config=saved.config)
    try:
        prep = system.prepare(3, "queries", None)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            res = system.call(prep)
        system.after(prep, res)
    finally:
        system.run = saved
    assert res["spans"] == [] and run.counters == {}
    # the route count still moves: it is no span
    assert sum(res["routes"].values()) == 1
    assert "build_ms" not in system.window[-1]


def test_the_readers_give_nothing_where_the_program_records_nothing(system, monkeypatch):
    c = tiny_cell()
    bare = Run(config=c.config)
    saved, system.run = system.run, bare
    try:
        assert system._count([]) == {}
    finally:
        system.run = saved
    assert bare.counters == {}
    assert not set(METRICS) & set(harness.read_metrics(c, bare, True))

    # a program with neither the top-k span nor the route count, as one from
    # before they were added: the build and solve spans alone are counted
    monkeypatch.setattr(service_spans, "_route_counts", lambda: None)
    monkeypatch.setattr(graph_mod, "span", lambda name: contextlib.nullcontext())
    old = system.run = Run(config=c.config)
    try:
        prep = system.prepare(2, "queries", None)  # a fresh psi: no bundle-cache hit
        res = system.call(prep)
        system.after(prep, res)
    finally:
        system.run = saved
    assert res["routes"] is None
    assert set(old.counters) == {"large_build_ms", "large_solve_ms"}
    got = harness.read_metrics(c, old, True)
    assert set(got) & set(METRICS) == {"large.build_ms", "large.solve_ms"}
    last = system.window[-1]
    assert last["routes"] is None and "topk_ms" not in last and "solve_ms" in last


def test_release_prints_the_route_line(few_threads, service_env, capsys):
    system = run_system(tiny_cell(), requests=1)
    system.release()
    line = json.loads(capsys.readouterr().err.splitlines()[-1])
    assert line == {"large_window": system.window_totals()}
    assert line["large_window"]["requests"] == 1


def test_the_control_stands_in_a_reference_client():
    c = tiny_cell()
    assert c.config["system"] == "service_spans"
    program = control.stand_in(c, "tf32")(c.config, torch.device("cpu"))
    assert isinstance(program, control.RefClient)


@pytest.mark.parametrize("precision, passes", [("tf32", False), ("f32", True)])
def test_the_reference_in_the_programs_place(few_threads, service_env, precision, passes):
    """The control through the system module: the plain reference with
    TF32-rounded matmul inputs fails the cell's limits; in float32 it
    passes.  It records no span and no route."""
    c = tiny_cell()
    system = run_system(c, program=control.stand_in(c, precision))
    assert harness.judge(system.check(), c.limits) == passes, system.check()
    totals = system.window_totals()
    assert totals["routes"] == {"dense": 0, "blocked": 0, "blocked_fast": 0}
    assert totals["recorded"] == 0


# --- the HTTP front's body cap -----------------------------------------------


def _bundle_body(rows: int) -> bytes:
    """A /v1/bundle body of ``rows`` 768-d float32 rows as a client's
    json.dumps sends them: about 17 kB a row."""
    rng = np.random.default_rng(7)
    Y = rng.standard_normal((rows, 768)).astype(np.float32)
    psi = rng.standard_normal(768).astype(np.float32)
    return json.dumps({"Y": Y.tolist(), "psi": psi.tolist(), "bundle_k": 4}).encode()


def test_a_body_over_the_cap_gets_413_at_the_http_front(service_env, monkeypatch):
    aiohttp = pytest.importorskip("aiohttp", reason="the HTTP front needs aiohttp")
    del aiohttp
    from aiohttp.test_utils import TestClient, TestServer

    from oscillink_tpu_torch.service import config
    from oscillink_tpu_torch.service.http import create_app

    body = _bundle_body(70)
    assert 1024 * 1024 < len(body) < 70 * 18_000

    async def post(max_body):
        if max_body is None:
            monkeypatch.delenv("OSCILLINK_MAX_BODY_BYTES", raising=False)
        else:
            monkeypatch.setenv("OSCILLINK_MAX_BODY_BYTES", str(max_body))
        config.get_app_settings.cache_clear()
        app = create_app(create_state(device="cpu"))
        async with TestClient(TestServer(app)) as client:
            r = await client.post("/v1/bundle", data=body,
                                  headers={"Content-Type": "application/json"})
            return r.status

    loop = asyncio.new_event_loop()
    try:
        assert loop.run_until_complete(post(None)) == 413  # the 1 MiB default
        assert loop.run_until_complete(post(128 * 1024 * 1024)) == 200
    finally:
        loop.close()
        monkeypatch.delenv("OSCILLINK_MAX_BODY_BYTES", raising=False)
        config.get_app_settings.cache_clear()
