"""The port's span recorder (`utils/profiling.py` `span`, `recording`) and
the spans inside the lattice, the CG and the service: nothing recorded and
no profiler event while recording is off; nesting, parents, trace ids and
the bounded buffer; the spans of ``set_query``, ``settle``, ``bundle``
and ``receipt`` with their parents, ``cg.wait`` once a CG iteration; a
``POST /v1/bundle`` under one ``service.request`` whose trace id is the
request id; results bit-equal with recording on and off; the spans as
profiler events by name."""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu_torch import OscillinkLattice  # noqa: E402
from oscillink_tpu_torch.service import LocalClient  # noqa: E402
from oscillink_tpu_torch.service.api import REQUEST_ID_HEADER, create_state  # noqa: E402
from oscillink_tpu_torch.utils import profiling  # noqa: E402
from oscillink_tpu_torch.utils.profiling import SPAN_CAPACITY, SPANS, recording, span  # noqa: E402

LATTICE_SPANS = {"lattice.set_query", "lattice.signature", "lattice.ustar", "lattice.settle",
                 "lattice.receipt", "receipt.energy", "receipt.nulls", "lattice.bundle",
                 "bundle.scores", "bundle.mmr", "cg.wait"}
BATCH_SPANS = {"lattice.bundle_batch", "lattice.ustar_batch"}
GRAPH_SPANS = {"lattice.graph", "graph.topk", "ivf.pregate", "ivf.kmeans", "ivf.scan",
               "ivf.quality"}
SERVICE_SPANS = {"service.request", "service.decode", "service.validate", "service.arrays",
                 "service.build", "service.settle", "service.bundle"}


def _lattice(n=96, d=16, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    lat = OscillinkLattice(Y, kneighbors=5, device="cpu")
    return lat, rng.standard_normal(d).astype(np.float32)


def _query(lat, psi):
    """set_query, settle, the full receipt and the bundle, as a gating query."""
    lat.set_query(psi)
    lat.settle()
    rec = lat.receipt()
    return rec, lat.bundle(k=6)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_span_names_are_the_tables():
    assert set(SPANS) == LATTICE_SPANS | BATCH_SPANS | GRAPH_SPANS | SERVICE_SPANS
    assert len(SPANS) == len(set(SPANS))


def test_recording_off_is_one_shared_no_op():
    assert profiling._recorder is None
    assert span("lattice.ustar") is span("cg.wait") is span("x", trace_id="r")
    lat, psi = _lattice()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _query(lat, psi)
    names = {e.name for e in prof.events()}
    assert names and not names & set(SPANS)
    with recording() as rec:
        pass
    assert rec.spans == [] and profiling._recorder is None


def test_nesting_parents_and_trace_ids():
    with recording() as rec:
        with span("a", trace_id="req-1") as a:
            with span("b") as b:
                with span("c") as c:
                    pass
            with span("d") as d:
                pass
        with span("e") as e:
            pass
        with recording() as inner:  # a nested block shares the recorder
            assert inner is rec
    assert [s.name for s in rec.spans] == ["c", "b", "d", "a", "e"]  # in order of ending
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (
        None, a.span_id, b.span_id, a.span_id, None)
    assert {s.trace_id for s in (a, b, c, d)} == {"req-1"}
    assert e.trace_id == e.span_id != a.span_id
    for s in rec.spans:
        assert 0 < s.start_ns <= s.end_ns and s.ms >= 0
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns <= e.start_ns
    assert profiling._recorder is None


def test_a_span_closes_on_an_exception():
    with recording() as rec:
        with pytest.raises(ValueError):
            with span("outer"):
                with span("inner"):
                    raise ValueError("x")
        with span("after") as after:
            pass
    assert [s.name for s in rec.spans] == ["inner", "outer", "after"]
    assert after.parent is None


def test_the_buffer_keeps_the_newest_and_counts_the_dropped():
    with recording() as rec:
        for i in range(SPAN_CAPACITY + 5):
            with span("s", trace_id=i):
                pass
        kept = rec.spans
        assert len(kept) == SPAN_CAPACITY and rec.dropped == 5
        assert kept[0].trace_id == 5 and kept[-1].trace_id == SPAN_CAPACITY + 4
        rec.clear()
        assert rec.spans == [] and rec.dropped == 0


def test_threads_keep_their_own_stacks():
    """More threads than cores, a short switch interval: every span's parent
    is the span its own thread had open, and none is lost."""
    n_threads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording() as rec:
            def work(t):
                for i in range(per):
                    with span("outer", trace_id=(t, i)):
                        with span("inner"):
                            pass

            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    spans = rec.spans
    assert len(spans) == 2 * n_threads * per and rec.dropped == 0
    outer = {s.span_id: s for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner":
            assert s.trace_id == outer[s.parent].trace_id
    assert len({s.trace_id for s in outer.values()}) == n_threads * per


def test_the_lattice_spans_and_their_parents():
    lat, psi = _lattice()
    lat.set_query(psi)
    lat.settle()
    lat.receipt()  # the memo and the U* cache filled: the query below starts afresh
    with recording() as rec:
        rec_out, bundle = _query(lat, psi)
    spans = rec.spans
    by = _by_name(spans)
    ids = {s.span_id: s for s in spans}

    def parent(s):
        return None if s.parent is None else ids[s.parent].name

    assert set(by) == LATTICE_SPANS
    for name in ("lattice.set_query", "lattice.settle", "lattice.receipt", "lattice.bundle"):
        assert [parent(s) for s in by[name]] == [None]
    # the receipt misses the memo set_query cleared and solves U*; the
    # bundle reuses both
    assert [parent(s) for s in by["lattice.signature"]] == ["lattice.receipt"]
    assert [parent(s) for s in by["lattice.ustar"]] == ["lattice.receipt"]
    assert [parent(s) for s in by["receipt.energy"]] == ["lattice.receipt"]
    assert [parent(s) for s in by["receipt.nulls"]] == ["lattice.receipt"]
    assert [parent(s) for s in by["bundle.scores"]] == ["lattice.bundle"]
    assert [parent(s) for s in by["bundle.mmr"]] == ["lattice.bundle"]
    waits = [parent(s) for s in by["cg.wait"]]
    assert waits.count("lattice.settle") == lat.last["iters"]
    assert waits.count("lattice.ustar") == lat.last_ustar["iters"]
    assert len(waits) == lat.last["iters"] + lat.last_ustar["iters"]
    # each query's spans share its root's trace id; roots differ
    for s in spans:
        root = s
        while root.parent is not None:
            root = ids[root.parent]
        assert s.trace_id == root.trace_id
    # lattice.ustar covers the interval last_ustar["solve_ms"] times
    (u,) = by["lattice.ustar"]
    assert u.ms >= lat.last_ustar["solve_ms"]
    assert rec_out["meta"]["ustar_cached"] is False and bundle


def test_every_graph_build_is_one_lattice_graph_span():
    Y = np.random.default_rng(1).standard_normal((96, 16)).astype(np.float32)
    with recording() as rec:
        lat = OscillinkLattice(Y, kneighbors=5, device="cpu")
        lat.rebuild_graph(kneighbors=4)
    roots = [s for s in rec.spans if s.name == "lattice.graph"]
    assert [s.parent for s in roots] == [None] * 2
    # each build's top-k scan is one graph.topk span inside it
    assert sorted((s.name, s.parent) for s in rec.spans if s.name != "lattice.graph") == \
        [("graph.topk", r.span_id) for r in roots]


def test_signature_only_on_a_memo_miss_and_ustar_only_on_a_cache_miss():
    lat, psi = _lattice()
    lat.set_query(psi)
    with recording() as rec:
        lat.bundle(k=4)  # miss: the signature and U*
        lat.bundle(k=4)  # hit: neither
        lat.receipt()
        lat.set_query(psi)  # clears the memo
        lat.bundle(k=4)
    names = [s.name for s in rec.spans]
    assert names.count("lattice.signature") == 2
    assert names.count("lattice.ustar") == 2
    assert names.count("lattice.bundle") == 3 and names.count("lattice.receipt") == 1
    assert names.count("cg.wait") == 2 * lat.last_ustar["iters"]


def test_the_bundle_route_under_one_service_request(monkeypatch):
    for name in ("OSCILLINK_NATIVE_SMALL_N", "OSCILLINK_SHARDED_MIN_N", "OSCILLINK_API_KEYS",
                 "OSCILLINK_GRAPH_CACHE_SIZE"):
        monkeypatch.delenv(name, raising=False)
    rng = np.random.default_rng(3)
    body = {"Y": rng.standard_normal((40, 12)).astype(np.float32).tolist(),
            "psi": rng.standard_normal(12).astype(np.float32).tolist(), "bundle_k": 5}
    client = LocalClient(create_state(device="cpu"))
    with recording() as rec:
        resp = client.post("/v1/bundle", json_body=body, headers={REQUEST_ID_HEADER: "rid-77"})
        other = client.post("/v1/bundle", json_body={**body, "psi": body["psi"][::-1]})
    assert resp.status_code == 200 and other.status_code == 200
    spans = rec.spans
    roots = [s for s in spans if s.name == "service.request"]
    assert [r.trace_id for r in roots] == ["rid-77", other.headers[REQUEST_ID_HEADER]]
    assert resp.headers[REQUEST_ID_HEADER] == "rid-77"
    mine = [s for s in spans if s.trace_id == "rid-77"]
    by = _by_name(mine)
    assert SERVICE_SPANS <= set(by)
    ids = {s.span_id: s for s in spans}
    for name in ("service.decode", "service.validate", "service.arrays", "service.build",
                 "service.settle", "service.bundle"):
        assert all(ids[s.parent].name == "service.request" for s in by[name]), name
    assert len(by["service.build"]) == len(by["service.settle"]) == 1
    assert [ids[s.parent].name for s in by["lattice.settle"]] == ["service.settle"]
    assert [ids[s.parent].name for s in by["lattice.bundle"]] == ["service.bundle"]
    assert all(ids[s.parent].name == "service.build" for s in by["lattice.set_query"])


def test_results_are_bit_equal_with_recording_on_and_off():
    outs = []
    for on in (False, True):
        lat, psi = _lattice(seed=5)
        lat.add_chain([1, 4, 9], lamP=0.3)
        if on:
            with recording() as rec:
                rec_out, bundle = _query(lat, psi)
            assert rec.spans
        else:
            rec_out, bundle = _query(lat, psi)
        outs.append((rec_out, bundle, lat.solve_Ustar().copy(), lat.U.copy(), lat._signature()))
    (r0, b0, u0, s0, g0), (r1, b1, u1, s1, g1) = outs
    for key in ("deltaH_total", "coh_drop_sum", "anchor_pen_sum", "query_term_sum",
                "null_points", "cg_iters", "residual"):
        assert r0[key] == r1[key], key
    assert r0["meta"]["state_sig"] == r1["meta"]["state_sig"] == g0 == g1
    assert b0 == b1
    assert np.array_equal(u0, u1) and np.array_equal(s0, s1)


def test_spans_are_profiler_events_by_name():
    lat, psi = _lattice()
    with recording() as rec:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _query(lat, psi)
        n_profiled = len(rec.spans)
        _query(lat, psi)  # after the session: recorded, not profiled
    recorded = [s.name for s in rec.spans]
    assert len(recorded) > n_profiled
    profiled = [e.name for e in prof.events() if e.name in SPANS]
    assert sorted(profiled) == sorted(recorded[:n_profiled])
    assert set(profiled) == LATTICE_SPANS
