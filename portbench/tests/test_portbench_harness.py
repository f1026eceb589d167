"""The harness's arithmetic and discovery: qps and p90 with failures as
misses, K1's bound, the whole-name import check, metrics found by file
name, and a cell added with new files alone."""

import json
import math
import shutil

import pytest

from portbench import harness, peaks
from portbench.harness import Run

from tiny import cell, run


def read(name, run_):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py").read(run_)


def test_qps_counts_completed_queries_over_the_window():
    r = Run(config={}, latencies=[0.1, 0.2, None, 0.1], window_s=2.0)
    assert read("qps", r) == pytest.approx(1.5)


@pytest.mark.parametrize("lat, want", [
    ([0.01 * i for i in range(1, 21)], 180.0),  # ceil(0.9 * 20) = 18th smallest
    ([0.01 * i for i in range(1, 11)], 90.0),
    ([0.1] * 18 + [None, None], 100.0),  # two misses of twenty sit beyond p90
    ([0.1] * 17 + [None] * 3, math.inf),  # three do not
])
def test_p90_takes_failures_as_infinite(lat, want):
    assert read("p90_ms", Run(config={}, latencies=lat, window_s=1.0)) == pytest.approx(want)


def test_k1_bound_at_the_corpus_shape():
    b = peaks.k1_bound(171332, 768, 8)
    assert b["bytes"] == (2 * 171332 * 768 + 2 * 171332 * 8) * 4
    assert b["flops"] == 2 * 171332 * 8 * 768
    assert b["bound_by"] == "bytes"
    assert b["seconds"] == pytest.approx(b["bytes"] / 3.35e12)


def test_k1_roofline_reads_the_trace():
    r = Run(config={"corpus": {"n": 171332, "d": 768}, "kneighbors": 8},
            trace={"k1_s": 0.01, "k1_launches": 10, "busy_s": 1.0, "window_s": 2.0})
    bound = peaks.k1_bound(171332, 768, 8)["seconds"]
    assert read("k1_roofline", r) == pytest.approx(100 * bound / 0.001)
    assert read("device.idle_pct", r) == pytest.approx(50.0)
    r.trace["k1_launches"] = 0
    assert read("k1_roofline", r) is None


@pytest.mark.parametrize("mods, found", [
    (["oscillink_tpu_torch", "oscillink_tpu_torch.core.lattice", "torch"], []),
    (["oscillink_tpu", "oscillink_tpu_torch"], ["oscillink_tpu"]),
    (["oscillink_tpu.ops.graph"], ["oscillink_tpu.ops.graph"]),
    (["jax", "jaxlib.xla_client", "flax.linen", "jaxtyping"], ["flax.linen", "jax",
                                                               "jaxlib.xla_client"]),
])
def test_forbidden_modules_compare_whole_top_level_names(mods, found):
    assert harness.forbidden_modules(mods) == found


def test_every_name_in_benchmark_json_has_its_files():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        c = harness.load_cell(w["name"])
        assert (harness.BENCH_DIR / "systems" / f"{c.config['system']}.py").exists()
        assert c.limits
        for trace in (False, True):
            for m in c.metrics(trace):
                assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        assert {m["name"] for m in c.metrics(False)} >= {"setup_s"}
        assert c.metrics(True)


def test_a_cell_added_by_files_alone(tmp_path):
    """A throwaway configuration, mix, limits and per-layer metric, added as
    new files and a workloads entry, run without an edit to any file."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cfg = harness.load_json(harness.BENCH_DIR / "configs" / "trec_covid.json")
    cfg["kneighbors"] = 5
    (tmp_path / "portbench/configs/throwaway.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/traffic/solo.json").write_text(json.dumps(
        {"steps": [["set_query", {}], ["bundle", {"k": 4}]], "warmup": 1,
         "check": {"sample": 2}}))
    (tmp_path / "portbench/checks/throwaway.solo.json").write_text(json.dumps(
        {"ustar_rel_err": 1e-3, "bundle_gap": 1e-3}))
    (tmp_path / "portbench/metrics/throwaway.queries.py").write_text(
        "def read(run):\n    return len(run.latencies)\n")
    bench["configs"].append({"name": "throwaway", "source": "a test",
                             "file": "portbench/configs/throwaway.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "throwaway.solo", "config": "throwaway",
                               "traffic": "solo", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "throwaway.queries", "unit": "queries",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "qps", "workloads": ["throwaway.solo"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cell("throwaway.solo", n=1500, root=tmp_path)
    rc, res, err = run(c, trace=True)
    assert rc == 0, err
    assert res["correct"], err
    assert res["metrics"]["throwaway.queries"]["value"] == res["attempted"]
    assert list(res["checks"]) == ["ustar_rel_err", "bundle_gap"]
