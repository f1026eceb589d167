"""The windowed tier's routing in the PyTorch port against the JAX package's.

``OSCILLINK_WINDOWED_MATVEC=auto`` (the default in both) decides, once per
graph, whether a lattice builds a window context and whether `solve_auto`
takes the windowed halo tier.  Both packages read the same environment
names; their defaults differ (the port's were read on an H100, PERF.md's
routing table), so every case here sets the names it depends on, and
``monkeypatch.setenv`` reaches both packages.  Each case holds the port's
decision (context or none), its reason (``accepted`` of ``window_ctx``, or
``reason`` of ``window_ctx_skipped``) and ``_window_fullwidth`` equal to the
JAX lattice's on the same corpus; where it solves, ΔH is held at the JAX
routing tests' bar (1e-3 against the gather path, ``tests/test_window_spmv.py``)
or at the lattice bar (1e-5 against the JAX lattice).  The cases are the
JAX package's routing tests (``tests/test_window_spmv.py``: the small-N
skip, the chunked-solve skip, the acceptance table, the bounded-straggler
retry, the full-width admission) and its halo tier's unforced branch
(``oscillink_tpu/parallel/halo_cg.py`` `solve_auto`).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.models import coherence as jcoh  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jax_build_graph  # noqa: E402
from oscillink_tpu.ops.pallas import window_spmv as ws  # noqa: E402
from oscillink_tpu.parallel import halo_cg as jh  # noqa: E402
from oscillink_tpu.parallel.mesh import lattice_mesh as jax_mesh  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.benchmarks import window_routing as wr  # noqa: E402
from oscillink_tpu_torch.core import lattice as tl  # noqa: E402
from oscillink_tpu_torch.models import coherence as tcoh  # noqa: E402
from oscillink_tpu_torch.ops.kernels import window_spmv as tw  # noqa: E402
from oscillink_tpu_torch.parallel import halo_cg as th  # noqa: E402
from oscillink_tpu_torch.parallel.mesh import lattice_mesh  # noqa: E402

H100_BYTES = 85_020_000_000  # total_memory of the H100 80GB HBM3 PERF.md's readings ran on
ROUTING = dict(OSCILLINK_WINDOWED_MIN_N="512", OSCILLINK_WINDOWED_MIN_COVERAGE="0.92",
               OSCILLINK_WINDOWED_LOWCOV_SMAX="768")


def _clustered(n, d, seed=0, n_centers=16, noise=0.35):
    """The corpus of tests/test_torch_windowed_lattice.py, whose graphs the
    two packages build alike."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    assign = rng.integers(0, n_centers, size=n)
    return (centers[assign] + noise * rng.standard_normal((n, d))).astype(np.float32)


def _psi(Y):
    m = Y[:40].mean(0)
    return (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def _env(monkeypatch, **values):
    for key, val in {**ROUTING, **values}.items():
        if val is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, val)


def _decision(lat):
    """(context built, reason, full width, coverage) of the lattice's last
    routing decision, re-made with a logger attached."""
    events = []
    lat.set_logger(lambda ev, p: events.append((ev, p)))
    lat._maybe_build_window_ctx()
    lat.set_logger(None)
    reason = None
    if events:
        ev, payload = events[-1]
        reason = payload["accepted"] if ev == "window_ctx" else payload["reason"]
    return lat._window_ctx is not None, reason, bool(lat._window_fullwidth), lat._window_coverage


def _both(Y, k=6):
    lj = ot.Oscillink(Y, kneighbors=k)
    lt = pt.Oscillink(Y, kneighbors=k, device="cpu")
    return lj, lt, _decision(lj), _decision(lt)


def _assert_same(dj, dt):
    assert dt[:3] == dj[:3]
    if dj[3] is None:
        assert dt[3] is None
    else:
        assert dt[3] == pytest.approx(dj[3], abs=1e-6)


def _assert_solves_as_gather(monkeypatch, lt, Y):
    """The lattice's settle and receipt against the gather path's on the
    same corpus: ΔH within the JAX routing tests' 1e-3."""
    psi = _psi(Y)
    lt.set_query(psi)
    lt.settle(max_iters=12, tol=1e-3)
    r = lt.receipt()
    monkeypatch.setenv("OSCILLINK_WINDOWED_MATVEC", "0")
    base = pt.Oscillink(Y, kneighbors=6, device="cpu")
    base.set_query(psi)
    base.settle(max_iters=12, tol=1e-3)
    assert r["deltaH_total"] == pytest.approx(base.receipt()["deltaH_total"], rel=1e-3)


# one corpus for most cases (coverage about 1.0), so the JAX package
# compiles its graph build and plan once
CORPUS_A = _clustered(1200, 48, seed=6)


# -- accept_window_plan -----------------------------------------------------------


def test_accept_window_plan_rules_match_jax():
    """The JAX package's acceptance table (tests/test_window_spmv.py
    `test_accept_window_plan_rules`), each call equal in the port."""
    kw = dict(forced=False, min_cov=0.92, lowcov_bound=512)
    table = [
        ((0.99, 2000, True, 384, 1000), kw, (False, "straggler overflow")),
        ((0.99, 10, False, 384, 1000), kw, (False, "straggler overflow")),
        ((0.99, 2000, True, 384, 1000), dict(kw, forced=True), (False, "straggler overflow")),
        ((0.95, 10, True, 384, 1000), kw, (True, "coverage")),
        ((0.07, 900, True, 512, 1000), kw, (True, "bounded stragglers")),
        ((0.07, 900, True, 2560, 100000), kw, (False, "low coverage")),
        ((0.07, 900, True, 512, 1000), dict(kw, lowcov_bound=0), (False, "low coverage")),
        ((0.07, 900, True, 2560, 100000), dict(kw, forced=True, lowcov_bound=0),
         (True, "forced")),
    ]
    for args, kwargs, want in table:
        assert tw.accept_window_plan(*args, **kwargs) == ws.accept_window_plan(*args, **kwargs)
        assert tw.accept_window_plan(*args, **kwargs) == want


# -- the lattice's branches ----------------------------------------------------------


@pytest.mark.parametrize("mode", [None, "auto", "0", "1"])
def test_lattice_routes_as_jax(monkeypatch, mode):
    """The mode's branch at N above OSCILLINK_WINDOWED_MIN_N on a corpus of
    coverage about 1.0: unset and ``auto`` accept on coverage, ``1`` forced,
    ``0`` builds nothing and says nothing; the same in both packages.  An
    ``auto``-accepted lattice solves as the gather path does (1e-3, the
    JAX routing tests' bar; the windowed solves themselves are held to the
    JAX package's in tests/test_torch_windowed_lattice.py)."""
    _env(monkeypatch, OSCILLINK_WINDOWED_MATVEC=mode)
    lj, lt, dj, dt = _both(CORPUS_A)
    _assert_same(dj, dt)
    want = {None: "coverage", "auto": "coverage", "0": None, "1": "forced"}[mode]
    assert dt[1] == want and dt[0] == (want is not None)
    if mode is None:
        _assert_solves_as_gather(monkeypatch, lt, CORPUS_A)


@pytest.mark.parametrize("min_n", [None, "2048", "x"])
def test_auto_skips_small_n_as_jax(monkeypatch, min_n):
    """N below OSCILLINK_WINDOWED_MIN_N (unset: each package's default; a
    value that is not an integer: the default too): no context in either.
    The JAX lattice returns without a word; the port logs the reason."""
    _env(monkeypatch, OSCILLINK_WINDOWED_MATVEC="auto", OSCILLINK_WINDOWED_MIN_N=min_n)
    lj, lt, dj, dt = _both(CORPUS_A)
    assert dj == (False, None, True, None)
    assert dt == (False, "small N", True, None)


@pytest.mark.parametrize("mode,chunks,want", [
    ("auto", "2", (False, "col-chunked solve", True)),
    ("auto", "1", (True, "coverage", True)),
    ("1", "2", (True, "forced", False)),
])
def test_auto_skips_col_chunked_solves_as_jax(monkeypatch, mode, chunks, want):
    """An explicit OSCILLINK_COL_CHUNKS = 2 chunks the gather solve: ``auto``
    skips with "col-chunked solve" (the windowed tier is taken full width
    only); at 1 it accepts; forced, the context solves chunked."""
    _env(monkeypatch, OSCILLINK_WINDOWED_MATVEC=mode, OSCILLINK_COL_CHUNKS=chunks)
    lj, lt, dj, dt = _both(CORPUS_A)
    _assert_same(dj, dt)
    assert dt[:3] == want


@pytest.mark.parametrize("bound,want", [
    ("768", (True, "bounded stragglers", True)),
    ("384", (False, "straggler overflow", True)),
])
def test_low_coverage_corpus_routes_as_jax(monkeypatch, bound, want):
    """A noisy corpus (coverage about 0.87) under ``auto``: its first plan
    overflows; with the bound above 384 the retry's window fits and the plan
    is accepted on its bounded stragglers, at 384 there is no retry."""
    _env(monkeypatch, OSCILLINK_WINDOWED_MATVEC="auto", OSCILLINK_WINDOWED_LOWCOV_SMAX=bound)
    Y = _clustered(2048, 16, seed=0, n_centers=64, noise=1.0)
    lj, lt, dj, dt = _both(Y)
    _assert_same(dj, dt)
    assert dt[:3] == want and dt[3] < 0.9
    if want[0]:
        assert lt._window_ctx.s_max == lj._window_ctx.oh.strag.shape[1] == 768


@pytest.mark.parametrize("bound", ["512", "0"])
def test_bounded_straggler_retry_as_jax(monkeypatch, bound):
    """tests/test_window_spmv.py `test_lowcov_bounded_straggler_acceptance`
    in both packages: the plan builder reports coverage 0.07 and, at the
    first pass's s_max 384, a window that does not fit; the retry at the
    bound is accepted on bounded stragglers and solves as the gather path
    does; with the bound 0 there is no retry and the overflow is refused."""
    _env(monkeypatch, OSCILLINK_WINDOWED_MATVEC="auto", OSCILLINK_WINDOWED_LOWCOV_SMAX=bound)
    calls = {"jax": [], "torch": []}

    def faked(real, tag, low, no):
        def fake(idx, wn, order, W, R, strag_cap, s_max, n_windows):
            calls[tag].append(s_max)
            plan, _, n_strag, fits = real(idx, wn, order, W, R, strag_cap, s_max, n_windows)
            return plan, low, n_strag, (no if s_max == 384 else fits)
        return fake

    monkeypatch.setattr(ws, "build_window_plan_device",
                        faked(ws.build_window_plan_device, "jax", jnp.float32(0.07),
                              jnp.bool_(False)))
    monkeypatch.setattr(tl, "build_window_plan_device",
                        faked(tl.build_window_plan_device, "torch", torch.tensor(0.07),
                              torch.tensor(False)))
    lj, lt, dj, dt = _both(CORPUS_A)
    _assert_same(dj, dt)
    assert calls["torch"] == calls["jax"]
    if bound == "0":
        assert dt[:3] == (False, "straggler overflow", True)
        assert set(calls["torch"]) == {384}
        return
    assert dt[:3] == (True, "bounded stragglers", True) and lt._window_ctx.s_max == 512
    _assert_solves_as_gather(monkeypatch, lt, CORPUS_A)


@pytest.mark.parametrize("case", ["fits", "over budget", "disabled"])
def test_full_width_admission_as_jax(monkeypatch, case):
    """tests/test_window_spmv.py `test_auto_mode_admits_fullwidth_windowed_
    when_fits` and `test_fw_admission_disabled_by_env`: with the gather model
    chunking (both packages' chunk models patched to 2), ``auto`` admits the
    full-width windowed solve when its working set fits the budget (the
    port's: the H100's memory less the models' headroom; the JAX package's
    17.7 GB), skips with "fw working set" when the estimate does not fit,
    and with OSCILLINK_WINDOWED_FW_GB=0 skips as a chunked solve."""
    _env(monkeypatch, OSCILLINK_WINDOWED_MATVEC="auto",
         OSCILLINK_WINDOWED_FW_GB="0" if case == "disabled" else None)
    monkeypatch.setattr(ot.OscillinkLattice, "_auto_col_chunks", lambda self: 2)
    monkeypatch.setattr(tl.OscillinkLattice, "_auto_col_chunks_gather",
                        lambda self, resident_blocks, capacity=None: 2)
    monkeypatch.setattr(tl.OscillinkLattice, "_capacity", lambda self: H100_BYTES)
    if case == "over budget":
        for cls in (ot.OscillinkLattice, tl.OscillinkLattice):
            monkeypatch.setattr(cls, "_windowed_fw_est_gb", lambda self, *a, **k: 99.0)
    lj, lt, dj, dt = _both(CORPUS_A)
    _assert_same(dj, dt)
    want = {"fits": (True, "coverage", True), "over budget": (False, "fw working set", True),
            "disabled": (False, "col-chunked solve", True)}[case]
    assert dt[:3] == want
    if case == "fits":
        _assert_solves_as_gather(monkeypatch, lt, CORPUS_A)


def test_routing_defaults_pin_perf_md(monkeypatch):
    """The port's defaults are PERF.md's routing table's, read on an NVIDIA
    H100 80GB HBM3 at 700 W; unset or unreadable names give them, as the
    JAX package's give its own."""
    assert tl.WINDOWED_MIN_N_DEFAULT == 2**62
    assert tw.MIN_COVERAGE_DEFAULT == 2.0
    assert tw.LOWCOV_SMAX_DEFAULT == 0
    lat = pt.Oscillink(_clustered(300, 16, seed=1), kneighbors=4, device="cpu")
    monkeypatch.setattr(tl.OscillinkLattice, "_capacity", lambda self: H100_BYTES)
    for value in (None, "x"):
        for name in ("OSCILLINK_WINDOWED_MIN_N", "OSCILLINK_WINDOWED_MIN_COVERAGE",
                     "OSCILLINK_WINDOWED_LOWCOV_SMAX", "OSCILLINK_WINDOWED_FW_GB"):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        assert tl._windowed_min_n() == tl.WINDOWED_MIN_N_DEFAULT
        assert tw.min_coverage() == tw.MIN_COVERAGE_DEFAULT
        assert tw.lowcov_smax_bound() == tw.LOWCOV_SMAX_DEFAULT
        assert lat._windowed_fw_budget_gb() == (H100_BYTES - tl._HEADROOM_BYTES) / 1e9
    monkeypatch.setenv("OSCILLINK_WINDOWED_FW_GB", "17.7")
    assert lat._windowed_fw_budget_gb() == 17.7


def test_defaults_are_what_the_committed_readings_give():
    """`derive` on the committed H100 readings (PERF.md's routing table)
    gives no MIN_N, no coverage bar and no straggler window, which the
    defaults encode as a MIN_N and a bar no lattice or plan reaches and 0."""
    path = Path(wr.__file__).with_name("window_routing_h100.jsonl")
    got = wr.derive(*wr.read_rows(str(path)))
    assert (got["min_n"], got["min_coverage"], got["lowcov_smax"]) == (None, None, 0)
    assert tl.WINDOWED_MIN_N_DEFAULT > 2**40 and tw.MIN_COVERAGE_DEFAULT > 1.0
    assert tw.LOWCOV_SMAX_DEFAULT == got["lowcov_smax"]
    assert not tw.can_accept(forced=False, min_cov=tw.MIN_COVERAGE_DEFAULT,
                             lowcov_bound=tw.LOWCOV_SMAX_DEFAULT)


def _row(verdict, n=131072, cov=1.0, s_max=384):
    return {"n": n, "verdict": verdict, "windowed": {"coverage": cov, "s_max": s_max}}


@pytest.mark.parametrize("rows,ladder,want", [
    # a winning run from the largest N sets MIN_N at its smallest
    ([_row("tie", 8192), _row("windowed", 16384), _row("windowed", 32768)], [],
     (16384, None, 0)),
    # one win below a tie at the largest N sets nothing
    ([_row("windowed", 8192), _row("tie", 16384)], [], (None, None, 0)),
    # a win at coverage 0.98 under a tie at 1.0 sets no bar, and the tie at
    # s_max 384 no straggler window
    ([], [_row("tie"), _row("windowed", cov=0.98), _row("gather", cov=0.9, s_max=768)],
     (None, None, 0)),
    # wins from 1.0 down to 0.95, then a bounded window up to 768 below it
    ([], [_row("windowed"), _row("windowed", cov=0.95), _row("tie", cov=0.9),
          _row("windowed", cov=0.8, s_max=512), _row("windowed", cov=0.6, s_max=768),
          _row("gather", cov=0.4, s_max=1024)],
     (None, 0.95, 0)),
    ([], [_row("windowed"), _row("windowed", cov=0.95),
          _row("windowed", cov=0.8, s_max=512), _row("windowed", cov=0.6, s_max=768),
          _row("gather", cov=0.4, s_max=1024)],
     (None, 0.95, 768)),
])
def test_derive_reads_each_bar_as_min_n(rows, ladder, want):
    """`derive` sets a bar only where windowed wins every rung past it."""
    got = wr.derive(rows, ladder)
    assert (got["min_n"], got["min_coverage"], got["lowcov_smax"]) == want


def test_full_width_admission_cannot_fire_at_768_on_the_h100():
    """PERF.md's reading of the two models at 768 x k8 on the H100's
    memory: the gather settle and U* first chunk near 3.8M rows, and the
    full-width windowed estimate leaves the budget near 1.65M rows, so the
    admission has no N at which to fire there."""
    budget = H100_BYTES - tl._HEADROOM_BYTES

    def gather_chunks(n):
        return tl.auto_col_chunks(n, 768, 8, H100_BYTES, [("settle", 3), ("ustar", 3)])

    assert gather_chunks(3_780_000) == 1 < gather_chunks(3_800_000)
    assert tl.working_set_bytes(1_640_000, 768, 8, "windowed", 2) < budget
    assert tl.working_set_bytes(1_660_000, 768, 8, "windowed", 2) > budget


# -- solve_stationary_donated -----------------------------------------------------


@pytest.mark.parametrize("lowmem", [False, True])
def test_solve_stationary_donated_matches_jax(monkeypatch, lowmem):
    """The donated stationary solve against the JAX package's (its
    `tests/test_orbax_checkpoint.py` case, 48 x 12, k = 4) on the JAX graph:
    U within 1e-5, iterations equal.  On the low-memory route (the
    threshold lowered to 0) the port builds the right-hand side in Y's
    buffer, so the caller's Y changes, and U is the non-donated solve's to
    the bit."""
    if lowmem:
        monkeypatch.setattr(tcoh, "LOWMEM_SOLVE_BYTES", 0)
    rng = np.random.default_rng(1)
    Y_host = rng.standard_normal((48, 12)).astype(np.float32)
    psi = rng.standard_normal(12).astype(np.float32)
    g = jax.jit(lambda Y: jax_build_graph(Y, 4))(jnp.asarray(Y_host))
    U_j, it_j, _ = jcoh.solve_stationary_donated(
        g, None, jnp.asarray(Y_host), jnp.asarray(psi), jnp.ones(48, jnp.float32),
        jcoh.EnergyParams.make(1.0, 0.5, 4.0, 0.0), tol=1e-6, max_iters=200)
    gt = interop.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    lam = tcoh.EnergyParams.make(1.0, 0.5, 4.0, 0.0, device=torch.device("cpu"))
    args = (torch.from_numpy(psi), torch.ones(48), lam)
    Y = torch.from_numpy(Y_host.copy())
    U, it, _ = tcoh.solve_stationary_donated(gt, None, Y, *args, tol=1e-6, max_iters=200)
    np.testing.assert_allclose(U.numpy(), np.asarray(U_j), rtol=1e-5, atol=1e-5)
    assert int(it) == int(it_j)
    ref, it_ref, _ = tcoh.solve_stationary(gt, None, torch.from_numpy(Y_host.copy()), *args,
                                           tol=1e-6, max_iters=200)
    assert torch.equal(U, ref) and int(it) == int(it_ref)
    assert torch.equal(Y, torch.from_numpy(Y_host)) is not lowmem


# -- the halo tier ----------------------------------------------------------------


def _halo_corpus(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((16, d)).astype(np.float32)
    assign = rng.integers(0, 16, size=n)
    return centers[assign] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)


def _stub_halo_solves(monkeypatch, n, taken):
    """Both packages' halo solves replaced by stubs that record the tier."""

    def stub(pkg, tier):
        def solve(mesh, g, plan, *args, **kwargs):
            taken.append((pkg, tier))
            if pkg == "jax":
                return np.zeros((n, 1), np.float32), 0, 0.0
            return [torch.zeros(plan.rows_per, 1) for _ in mesh.devices], 0, 0.0
        return solve

    for pkg, mod in (("jax", jh), ("torch", th)):
        monkeypatch.setattr(mod, "halo_solve", stub(pkg, "halo-exchange"))
        monkeypatch.setattr(mod, "halo_solve_windowed", stub(pkg, "halo-exchange-windowed"))


@pytest.mark.parametrize("mode,min_cov,lowcov,want", [
    (None, "0.92", "0", ("halo-exchange-windowed", None)),
    ("auto", "1.01", "0", ("halo-exchange", "low coverage")),
    ("1", "1.01", "0", ("halo-exchange-windowed", None)),
    ("auto", "1.01", "768", ("halo-exchange-windowed", None)),
    ("auto", "1.01", "1", ("halo-exchange", "low coverage")),
])
def test_solve_auto_windowed_routing_as_jax(monkeypatch, mode, min_cov, lowcov, want):
    """4096 rows on 4 shards, 1024 rows a shard, where both packages consider
    the windowed halo tier: unset at coverage 0.92 both take it on coverage;
    at a bar above 1 with the bounded-straggler rule off both refuse it (the
    port says why, and builds no shard plan: no plan could pass); forced,
    both take it; above the bar, a straggler window of 768 rows bounds the
    shards' (bounded stragglers) and one of 1 row does not.  The halo solves
    are stubbed in both packages (this is the decision;
    tests/test_torch_halo_cg.py holds the solves to the JAX package's)."""
    _env(monkeypatch, OSCILLINK_WINDOWED_MATVEC=mode, OSCILLINK_WINDOWED_MIN_COVERAGE=min_cov,
         OSCILLINK_WINDOWED_LOWCOV_SMAX=lowcov)
    n = 4096
    taken = []
    _stub_halo_solves(monkeypatch, n, taken)
    Y = _halo_corpus(n, 24, seed=3)
    psi = np.random.default_rng(4).standard_normal(24).astype(np.float32)
    _, info = th.solve_auto(lattice_mesh(devices=[torch.device("cpu")] * 4), Y, psi, k=6)
    _, info_j = jh.solve_auto(jax_mesh(4), Y, psi, k=6)
    assert taken == [("torch", want[0]), ("jax", want[0])]
    assert info["tier"] == info_j["tier"] == want[0]
    assert info["window_skipped"] == want[1]
    if lowcov == "0" and mode == "auto":
        assert info["window_coverage"] is None
    else:
        assert info["window_coverage"] == pytest.approx(info_j["window_coverage"], abs=1e-6)


def test_solve_auto_defaults_refuse_without_building_plans(monkeypatch):
    """Under the port's defaults (names unset) no plan can pass the rule, so
    `solve_auto` takes the gather halo tier as low coverage, the JAX rule's
    decision for such constants, without building the shard window plans."""
    for name in ("OSCILLINK_WINDOWED_MATVEC", "OSCILLINK_WINDOWED_MIN_COVERAGE",
                 "OSCILLINK_WINDOWED_LOWCOV_SMAX"):
        monkeypatch.delenv(name, raising=False)
    assert not tw.can_accept(forced=False, min_cov=tw.min_coverage(),
                             lowcov_bound=tw.lowcov_smax_bound())

    def no_plans(*args, **kwargs):
        raise AssertionError("the shard window plans were built")

    monkeypatch.setattr(th, "build_shard_window_plans", no_plans)
    n = 4096
    taken = []
    _stub_halo_solves(monkeypatch, n, taken)
    Y = _halo_corpus(n, 24, seed=3)
    psi = np.random.default_rng(4).standard_normal(24).astype(np.float32)
    _, info = th.solve_auto(lattice_mesh(devices=[torch.device("cpu")] * 4), Y, psi, k=6)
    assert taken == [("torch", "halo-exchange")]
    assert (info["tier"], info["window_skipped"], info["window_coverage"]) == (
        "halo-exchange", "low coverage", None)
    ok, reason = tw.accept_window_plan(1.0, 0, True, 128, float("inf"), forced=False,
                                       min_cov=tw.min_coverage(),
                                       lowcov_bound=tw.lowcov_smax_bound())
    assert (ok, reason) == (False, "low coverage")
