"""The ``trec_covid_batch.batch8`` cell's pieces on the CPU at 4096 x 64,
8 queries a call: the system module (``portbench/systems/lattice_batch.py``)
builds the lattice and runs two ``bundle_batch`` calls; `compare_batch`'s
numbers against the plain reference sit within the cell's limits
(``portbench/checks/trec_covid_batch.batch8.json``), and each planted fault
fails at least one of them; lanes that stop at different counts take the
select path and each still equals its single reference solve; the batch
path's spans nest under ``lattice.bundle_batch`` and reach the cell's
three ``batch.*`` metrics.

64 centres, not the cell's 1024, and the fast scan forced, as the
benchmark's own tiny cells do: 4096 rows over 1024 centres would leave
four rows a centre, and ``auto`` takes the exact scan below 65536 rows."""

import statistics

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import oscillink_tpu_torch.core.lattice as L  # noqa: E402
from oscillink_tpu_torch.ops import solver  # noqa: E402
from oscillink_tpu_torch.utils import profiling  # noqa: E402
from portbench import compare, control_batch, harness  # noqa: E402
from portbench import reference as ref  # noqa: E402
from portbench.harness import Run  # noqa: E402
from portbench.run_support import Snapshots  # noqa: E402
from portbench.systems import lattice, lattice_batch  # noqa: E402

N, D, Q, K = 4096, 64, 8, 8
SEED = 2**31 + 11
BATCH_SPANS = ("lattice.ustar_batch", "bundle.scores", "bundle.mmr")
METRICS = {"batch.ustar_ms": "batch_ustar_ms", "batch.ms_per_iter": "batch_ms_per_iter",
           "batch.bundle_ms": "batch_bundle_ms"}


@pytest.fixture(scope="module")
def few_threads():
    """Two threads for this module's solves: the suite's workers share the
    CPU, and more threads a worker only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def small_cell() -> harness.Cell:
    c = harness.load_cell("trec_covid_batch.batch8")
    c.config["corpus"].update(n=N, d=D, centres=64)
    c.config["similarity"] = "fast"
    return c


def run_system(c: harness.Cell, calls: int = 2, program=lattice.build_program):
    """The cell's system on the CPU after ``calls`` calls, each sampled."""
    cpu = torch.device("cpu")
    system = lattice_batch.System(c.config, c.traffic, SEED, cpu, Run(config=c.config), False,
                                  program=program)
    snap = Snapshots(cpu)
    for i in range(calls):
        prep = system.prepare(i, "queries", snap)
        system.after(prep, system.call(prep))
    return system


@pytest.fixture(scope="module")
def cell(few_threads):
    c = small_cell()
    system = run_system(c)
    return {"cell": c, "system": system, "Y": torch.from_numpy(system.Y)}


def failed(nums, limits):
    return sorted(k for k in nums if nums[k] > limits[k])


def queries(system, scales=None) -> np.ndarray:
    """The stream's first Q queries, lane q scaled by ``scales[q]``."""
    psis = np.stack([system.streams["queries"][i] for i in range(Q)])
    return psis if scales is None else psis * np.asarray(scales, np.float32)[:, None]


def test_the_numbers_are_within_the_cell_limits(cell):
    system, limits = cell["system"], cell["cell"].limits
    assert set(limits) == {"graph_rows_differ", "graph_w_err", "ustar_rel_err", "bundle_gap",
                           "bundle_score_err"}
    assert len(system.samples) == 2 * Q
    # call i takes queries Q i .. Q i + Q - 1 of its stream
    np.testing.assert_array_equal(system.samples[Q + 3]["psi"],
                                  system.streams["queries"][Q + 3])
    nums = system.check()
    assert set(nums) == set(limits)
    assert failed(nums, limits) == [], nums


def swapped_lanes(mp):
    """Lanes 0 and 1 of the solve hand back each other's U*."""
    orig = L.solve_stationary_batch

    def swapped(g, Y, psis, Bs, lam, tol=1e-4, max_iters=64):
        U, its, res = orig(g, Y, psis, Bs, lam, tol=tol, max_iters=max_iters)
        order = [1, 0, *range(2, U.shape[0])]
        return U[order], its[order], res[order]

    mp.setattr(L, "solve_stationary_batch", swapped)


def lane_stopped(after=None, short=None):
    """A fault: lane 0's U* is that of its solve stopped after ``after``
    iterations, or ``short`` iterations before its own stop."""
    def plant(mp):
        orig = L.solve_stationary_batch

        def frozen(g, Y, psis, Bs, lam, tol=1e-4, max_iters=64):
            U, its, res = orig(g, Y, psis, Bs, lam, tol=tol, max_iters=max_iters)
            stop = after if short is None else int(its[0]) - short
            U1, _, _ = orig(g, Y, psis[:1], Bs[:1], lam, tol=tol, max_iters=stop)
            U = U.clone()
            U[0] = U1[0]
            return U, its, res

        mp.setattr(L, "solve_stationary_batch", frozen)

    return plant


@pytest.mark.parametrize("fault", [swapped_lanes, lane_stopped(after=1), lane_stopped(short=2)],
                         ids=["swapped_lanes", "lane_stopped_after_one", "lane_stopped_two_short"])
def test_a_planted_fault_fails_a_limit(few_threads, fault):
    c = small_cell()
    with pytest.MonkeyPatch.context() as mp:
        fault(mp)
        system = run_system(c, calls=1)
    nums = system.check()
    assert "ustar_rel_err" in failed(nums, c.limits), nums


@pytest.mark.parametrize("precision, passes", [("tf32", False), ("f32", True)])
def test_the_reference_in_the_programs_place(few_threads, precision, passes):
    """The control: the plain reference standing in for the program fails
    the limits with TF32-rounded matmul inputs and passes in float32."""
    c = small_cell()
    system = run_system(c, calls=1, program=control_batch.stand_in(precision))
    nums = system.check()
    assert harness.judge(nums, c.limits) == passes, nums


def test_lanes_that_stop_apart_take_the_select_path(cell):
    """Each lane's U* and iterations are its single reference solve's, on
    a batch whose lanes stop at different counts."""
    system, Y = cell["system"], cell["Y"]
    psis = queries(system, [1.0, 0.01, 3.0, 0.1, 10.0, 1.0, 0.3, 30.0])
    Ustars = system.lat.solve_Ustar_batch(psis)
    rec = system.lat.last_ustar_batch
    iters = rec["iters"]
    assert len(set(iters)) > 1, iters
    assert rec["loop_iters"] == max(iters) > min(iters)  # some iterations ran the selects
    assert (rec["fused"], rec["classic"]) == (0, rec["loop_iters"])
    g = ref.build_graph(Y, K, "fast")
    lam = ref.Lam(*cell["cell"].config["lam"])
    for q in range(Q):
        psi = torch.from_numpy(psis[q])
        Us, its = ref.cg(lambda X: ref.m_apply(g, lam, X), ref.rhs(Y, psi, lam), Y,
                         lam.G + lam.Q, 1e-4, 64)
        assert its == iters[q], q
        assert compare.rel_err(torch.from_numpy(Ustars[q]), Us) <= \
            cell["cell"].limits["ustar_rel_err"], q


def test_the_batch_metrics_read_the_recorded_counters(cell):
    system, c = cell["system"], cell["cell"]
    counters = system.run.counters
    assert all(len(counters[key]) == 2 for key in METRICS.values())
    got = harness.read_metrics(c, system.run, True)
    for metric, key in METRICS.items():
        assert got[metric] == {"value": pytest.approx(statistics.fmean(counters[key])),
                               "unit": "ms"}
        assert got[metric]["value"] > 0
    # a call's counters are its spans and its solve's trip count
    saved = system.run
    run = system.run = Run(config=c.config)
    try:
        prep = system.prepare(2, "queries", None)
        res = system.call(prep)
        system.after(prep, res)
    finally:
        system.run = saved
    ms = {s.name: s.ms for s in res["spans"] if s.name != "cg.wait"}
    solve = res["solve"]
    assert run.counters == {
        "batch_ustar_ms": [ms["lattice.ustar_batch"]],
        "batch_ms_per_iter": [ms["lattice.ustar_batch"] / solve["loop_iters"]],
        "batch_bundle_ms": [ms["lattice.bundle_batch"] - ms["lattice.ustar_batch"]],
        "batch_fused": [0], "batch_classic": [solve["loop_iters"]],
        "batch_select": [solve["loop_iters"] - min(solve["iters"])]}
    # a program without the spans and keys, as the parent's, adds none
    bare = system.run = Run(config=c.config)
    try:
        system._count([], {"solve_ms": 1.0, "iters": [3, 4], "res": [0.0, 0.0]})
    finally:
        system.run = saved
    assert bare.counters == {}
    assert not set(METRICS) & set(harness.read_metrics(c, bare, True))


def test_release_prints_the_windows_iteration_totals(few_threads, capsys):
    import json

    system = run_system(small_cell(), calls=2)
    counters = system.run.counters
    system.release()
    line = json.loads(capsys.readouterr().err.splitlines()[-1])
    assert line["batch"] == Q
    assert line["iterations"] == {key: sum(counters[f"batch_{key}"])
                                  for key in ("fused", "classic", "select")}
    assert line["iterations"]["classic"] > 0


def _by_name(spans) -> dict:
    by: dict = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    return by


def test_the_batch_spans_nest_under_bundle_batch_once(cell):
    lat = cell["system"].lat
    with profiling.recording() as rec:
        lat.bundle_batch(queries(cell["system"]), k=8)
    by = _by_name(rec.spans)
    assert set(by) == {"lattice.bundle_batch", *BATCH_SPANS, "cg.wait"}
    assert all(len(by[name]) == 1 for name in ("lattice.bundle_batch", *BATCH_SPANS))
    root = by["lattice.bundle_batch"][0]
    assert root.parent is None
    for name in BATCH_SPANS:
        s = by[name][0]
        assert s.parent == root.span_id and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert sorted(BATCH_SPANS, key=lambda name: by[name][0].start_ns) == list(BATCH_SPANS)
    solve = by["lattice.ustar_batch"][0]
    assert len(by["cg.wait"]) == lat.last_ustar_batch["loop_iters"]
    assert all(s.parent == solve.span_id for s in by["cg.wait"])
    assert solve.ms >= lat.last_ustar_batch["solve_ms"] - 1e-6  # the interval of solve_ms


def test_solve_ustar_batch_records_ustar_batch_alone(cell):
    lat = cell["system"].lat
    with profiling.recording() as rec:
        lat.solve_Ustar_batch(queries(cell["system"]))
    by = _by_name(rec.spans)
    assert set(by) == {"lattice.ustar_batch", "cg.wait"}
    assert len(by["lattice.ustar_batch"]) == 1 and by["lattice.ustar_batch"][0].parent is None


def test_nothing_is_recorded_outside_recording(cell, monkeypatch):
    opened = []
    enter = profiling._Open.__enter__

    def counted(self):
        opened.append(self.name)
        return enter(self)

    monkeypatch.setattr(profiling._Open, "__enter__", counted)
    lat, psis = cell["system"].lat, queries(cell["system"])
    lat.bundle_batch(psis, k=8)
    lat.solve_Ustar_batch(psis)
    assert opened == [] and profiling._recorder is None


@pytest.mark.parametrize("q", [1, Q])
def test_last_ustar_batch_counts_match_the_solver_counters(cell, q):
    """A one-query batch (one Jacobi value a row) runs the fused passes; a
    batch of Q (a diagonal a lane) runs the classic body."""
    lat = cell["system"].lat
    fused0, classic0 = solver.fused_iterations, solver.classic_iterations
    lat.bundle_batch(queries(cell["system"])[:q], k=8)
    rec = lat.last_ustar_batch
    assert rec["fused"] == solver.fused_iterations - fused0
    assert rec["classic"] == solver.classic_iterations - classic0
    assert rec["fused"] + rec["classic"] == rec["loop_iters"] == max(rec["iters"])
    assert (rec["fused"] > 0) == (q == 1) and (rec["classic"] > 0) == (q > 1)
