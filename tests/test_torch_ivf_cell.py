"""The ``beir_quora.rerank`` cell's pieces on the CPU at 65536 x 32: the
loose study corpus (spread 0.6) sends ``similarity="auto"`` down the IVF
route once ``OSCILLINK_CLUSTER_SIM_N`` is lowered to N; the system module
(``portbench/systems/lattice_ivf.py``) builds the lattice and runs two
queries; `compare_ivf`'s numbers against `reference_ivf` sit within the
cell's limits (``portbench/checks/beir_quora.rerank.json``), and each
planted fault fails at least one of them; the build's spans nest under
``lattice.graph`` and reach the cell's two span metrics.

768 centres, not the cell's 1024: at 32 columns the clusterability
pre-gate reads 1.21 on 1024 centres (below its 1.25) and 1.27 on 768,
and 65536 rows over 768 centres keep about the cell's rows a bucket."""

from functools import partial

import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu_torch.ops import ivf  # noqa: E402
from oscillink_tpu_torch.utils import profiling  # noqa: E402
from portbench import compare_ivf, harness, reference_ivf  # noqa: E402
from portbench.harness import Run  # noqa: E402
from portbench.run_support import Snapshots  # noqa: E402
from portbench.systems import lattice_ivf  # noqa: E402

N, D, K = 65536, 32, 8
SEED = 2**31 + 5
IVF_SPANS = ("ivf.pregate", "ivf.kmeans", "ivf.scan", "ivf.quality")


@pytest.fixture(scope="module")
def few_threads():
    """Two threads for this module's scans: the suite's workers share the
    CPU, and more threads a worker only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cell(few_threads):
    """The cell at the test size, its system built under the span recorder,
    two queries run with their outputs kept, and the reference's graphs."""
    c = harness.load_cell("beir_quora.rerank")
    c.config["corpus"].update(n=N, d=D, centres=768, topics=768)
    cpu = torch.device("cpu")
    run = Run(config=c.config)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OSCILLINK_CLUSTER_SIM_N", str(N))
        with profiling.recording() as rec:
            system = lattice_ivf.System(c.config, c.traffic, SEED, cpu, run, False)
        spans = rec.spans
        snap = Snapshots(cpu)
        for i in range(2):
            prep = system.prepare(i, "queries", snap)
            system.after(prep, system.call(prep))
    Y = torch.from_numpy(system.Y)
    return {"cell": c, "run": run, "spans": spans, "system": system, "Y": Y,
            "exact": reference_ivf.exact_graph(Y, K)}


def numbers(cell, idx, w, info, queries=None):
    """`compare_ivf`'s numbers for the graph (idx, w) of a build that
    reported ``info``, and, given ``queries``, theirs."""
    c, Y = cell["cell"], cell["Y"]
    on_edges = reference_ivf.graph_on_edges(Y, idx, w)
    out = compare_ivf.graph_numbers(idx, w, info, cell["exact"], on_edges)
    if queries is None:
        return out
    return {**out, **compare_ivf.query_numbers(Y, on_edges, c.config, c.traffic, queries)}


def failed(nums, limits):
    return sorted(k for k in nums if nums[k] > limits[k])


def test_auto_takes_the_ivf_route_and_counts_it(cell):
    system = cell["system"]
    assert system.info["mode"] == "ivf" and system.info["overflow_patched"] == 0
    stats = system.ivf_stats
    assert {key: stats[key] for key in ("ivf_builds", "ivf_fallbacks", "ivf_overflow_rows")} == {
        "ivf_builds": 1, "ivf_fallbacks": 0, "ivf_overflow_rows": 0}
    assert stats["ivf_patched_rows"] > 0  # the spill patch: rows the balance rounds moved
    assert system.lat.stats["ivf_builds"] == 1


def test_the_numbers_are_within_the_cell_limits(cell, monkeypatch):
    system, limits = cell["system"], cell["cell"].limits
    assert set(limits) == {"graph_fallback", "graph_not_mutual", "graph_w_err",
                           "graph_edges_missed", "graph_edges_extra", "ustar_rel_err",
                           "bundle_gap", "bundle_score_err"}
    monkeypatch.setattr(reference_ivf, "exact_graph", lambda Y, k: cell["exact"])
    nums = system.check()  # the system's own check, on the cached exact graph
    assert len(system.samples) == 2 and set(nums) == set(limits)
    assert failed(nums, limits) == [], nums
    assert nums == numbers(cell, *system.graph, system.info, system.samples)


def _one_edge(cell):
    """(i, slot of j in row i, j, slot of i in row j) of row 0's first edge."""
    idx, w = cell["system"].graph
    s = int(torch.nonzero(w[0] > 0)[0, 0])
    j = int(idx[0, s])
    return 0, s, j, int(torch.nonzero(idx[j].long() == 0)[0, 0])


def _ivf_build(cell, **kw):
    """(idx, w, info, None) of a build of the cell's corpus through
    `build_graph_ivf` with ``kw``; a fallback stands the sound graph in for
    its dense build, whose mode the info names all the same."""
    g, info = ivf.build_graph_ivf(cell["Y"], K, fallback_builder=lambda mode: None, **kw)
    idx, w = cell["system"].graph if g is None else (g.idx, g.w)
    return idx, w, info, None


def m_probe_1(cell):
    """m_probe=1 with the sampled quality gate off.  At this size the gate
    (recall 0.88) would send it to the fallback, which ``graph_fallback``
    catches; at the cell's size it passes the gate (recall 0.98-0.99) and
    stays IVF, as here, where the edge shares must catch it."""
    out = _ivf_build(cell, m_probe=1, min_recall=0.0)
    assert out[2]["mode"] == "ivf"
    return out


def no_balance(cell):
    return _ivf_build(cell, balance_rounds=0)


def weight_off_by_1e_3(cell):
    idx, w = cell["system"].graph
    i, s, _, _ = _one_edge(cell)
    w = w.clone()
    w[i, s] += 1e-3
    return idx, w, cell["system"].info, None


def one_sided_edge(cell):
    idx, w = cell["system"].graph
    i, s, _, _ = _one_edge(cell)
    w = w.clone()
    w[i, s] = 0.0
    return idx, w, cell["system"].info, None


def ustar_without_one_edge(cell):
    """The graph reported whole, U* solved (by the reference's CG) on it
    less one edge, both of its slots."""
    from portbench import reference as ref

    system = cell["system"]
    idx, w = system.graph
    i, s, j, t = _one_edge(cell)
    w_less = w.clone()
    w_less[i, s] = w_less[j, t] = 0.0
    g_less = reference_ivf.graph_on_edges(cell["Y"], idx, w_less)
    lam = ref.Lam(*cell["cell"].config["lam"])
    queries = [{**q, "ustar": ref.ustar(g_less, cell["Y"], torch.as_tensor(q["psi"]), lam)}
               for q in system.samples]
    return idx, w, system.info, queries


@pytest.mark.parametrize("fault, fails", [
    (m_probe_1, "graph_edges_missed"),
    (no_balance, "graph_fallback"),
    (weight_off_by_1e_3, "graph_w_err"),
    (one_sided_edge, "graph_not_mutual"),
    (ustar_without_one_edge, "ustar_rel_err"),
])
def test_a_planted_fault_fails_a_limit(cell, fault, fails):
    idx, w, info, queries = fault(cell)
    nums = numbers(cell, idx, w, info, queries)
    assert fails in failed(nums, cell["cell"].limits), nums


def test_the_build_spans_nest_under_lattice_graph_once(cell):
    spans = cell["spans"]
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert set(by) == {"lattice.graph", *IVF_SPANS}
    assert all(len(v) == 1 for v in by.values())
    root = by["lattice.graph"][0]
    assert root.parent is None
    for name in IVF_SPANS:
        s = by[name][0]
        assert s.parent == root.span_id and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    order = sorted(IVF_SPANS, key=lambda name: by[name][0].start_ns)
    assert order == list(IVF_SPANS)


def _small_corpus():
    """2048 x 64 rows about 8 centres, for builds of 8 clusters from 256 rows."""
    from portbench import data

    cpu = torch.device("cpu")
    return data.study_corpus({"n": 2048, "d": 64, "centres": 8, "spread": 0.3}, SEED, cpu)[0]


def test_nothing_is_recorded_outside_recording(monkeypatch):
    opened = []
    enter = profiling._Open.__enter__

    def counted(self):
        opened.append(self.name)
        return enter(self)

    monkeypatch.setattr(profiling._Open, "__enter__", counted)
    Y = _small_corpus()
    g, info = ivf.build_graph_ivf(Y, 6, n_clusters=8, m_probe=4, min_n=256)
    assert info["mode"] == "ivf" and opened == [] and profiling._recorder is None
    with profiling.recording() as rec:
        ivf.build_graph_ivf(Y, 6, n_clusters=8, m_probe=4, min_n=256)
    assert sorted(opened) == sorted(IVF_SPANS) == sorted(s.name for s in rec.spans)


def test_the_span_metrics_read_the_build(cell):
    run, c = cell["run"], cell["cell"]
    by = {s.name: 1e-9 * (s.end_ns - s.start_ns) for s in cell["spans"]}
    for name in ("lattice.graph", *IVF_SPANS):
        assert run.setup_spans[name] == pytest.approx(by[name])
    got = harness.read_metrics(c, run, True)
    assert got["ivf.kmeans_s"]["value"] == pytest.approx(by["ivf.kmeans"])
    assert got["ivf.scan_s"]["value"] == pytest.approx(by["ivf.scan"])
    assert all(got[m]["unit"] == "s" for m in ("ivf.kmeans_s", "ivf.scan_s"))
    # a program that records no build span leaves both metrics out
    assert "ivf.kmeans_s" not in harness.read_metrics(c, Run(config=c.config), True)


def test_a_build_with_stats_counts_its_fallback():
    Y = _small_corpus()
    stats = {"ivf_builds": 2}
    build = partial(ivf.build_graph_ivf, Y, 6, n_clusters=8, m_probe=4, min_n=256, stats=stats)
    assert build()[1]["mode"] == "ivf"
    g, info = build(bucket_factor=0.5, balance_rounds=0)  # buckets too small: overflow
    assert info["mode"] == "fallback-exact" and "bucket-overflow" in info["reason"]
    ovf = int(info["reason"].split()[0])
    assert stats == {"ivf_builds": 3, "ivf_fallbacks": 1, "ivf_overflow_rows": ovf,
                     "ivf_patched_rows": ovf}
    assert build(min_n=4096)[1]["reason"] == "N below IVF threshold"
    assert stats["ivf_fallbacks"] == 2 and stats["ivf_overflow_rows"] == ovf


def test_offer_merges_each_offered_row_into_its_neighbours_lists():
    """`ivf._offer` against a loop over the rows: each row's list is the top
    k, by (similarity desc, id asc), of its own entries and the offered
    rows that list it, each id once."""
    g = torch.Generator().manual_seed(3)
    n, k = 60, 4
    sims = torch.rand(n, n, generator=g)
    sims = (sims + sims.T) / 2
    idx = torch.stack([torch.randperm(n, generator=g)[:k] for _ in range(n)])
    vals = sims.gather(1, idx)
    rows = torch.tensor([3, 17, 42, 5])
    want = {}
    for j in range(n):
        cands = {int(c): float(v) for c, v in zip(idx[j], vals[j])}
        for p in rows.tolist():
            if j in idx[p].tolist():
                cands.setdefault(p, float(sims[p, j]))
        want[j] = sorted(cands.items(), key=lambda cv: (-cv[1], cv[0]))[:k]
    touched = set(idx[rows].reshape(-1).tolist())
    v2, i2 = vals.clone(), idx.clone()
    ivf._offer(v2, i2, rows, k)
    for j in range(n):
        got = list(zip(i2[j].tolist(), v2[j].tolist()))
        if j in touched:
            assert [c for c, _ in got] == [c for c, _ in want[j]], j
            assert [v for _, v in got] == pytest.approx([v for _, v in want[j]])
        else:
            assert torch.equal(i2[j], idx[j]) and torch.equal(v2[j], vals[j])
