"""The PyTorch port's lattice, end to end, against the JAX package's.

The verify-skill quickstart (N=120, D=128, k=6, chain [2,5,7,9], lamP=0.2)
runs through both packages on the CPU: deltaH within 1e-5 relative, the same
null-point count, bundle ids, chain verdict, state signature and CG
iteration counts.  Signed receipts verify across the packages.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = [2, 5, 7, 9]


def _inputs(n=120, d=128, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    m = Y[:20].mean(0)
    return Y, (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def _pair(n=120, d=128, k=6, seed=0, chain=True, **kw):
    Y, psi = _inputs(n, d, seed)
    lj = ot.Oscillink(Y, kneighbors=k, **kw)
    lt = pt.Oscillink(Y, kneighbors=k, device="cpu", **kw)
    for lat in (lj, lt):
        lat.set_query(psi)
        if chain:
            lat.add_chain(CHAIN, lamP=0.2)
    return lj, lt


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("seed,chain", [(0, True), (1, False), (2, True)])
def test_quickstart_matches_jax(seed, chain):
    lj, lt = _pair(seed=seed, chain=chain)
    sj, st_ = lj.settle(max_iters=12, tol=1e-3), lt.settle(max_iters=12, tol=1e-3)
    assert int(st_["iters"]) == int(sj["iters"])
    rj, rt = lj.receipt(), lt.receipt()
    assert _rel(rt["deltaH_total"], rj["deltaH_total"]) <= 1e-5
    assert len(rt["null_points"]) == len(rj["null_points"])
    assert [e["edge"] for e in rt["null_points"]] == [e["edge"] for e in rj["null_points"]]
    assert rt["meta"]["state_sig"] == rj["meta"]["state_sig"]
    assert rt["meta"]["ustar_iters"] == rj["meta"]["ustar_iters"]
    assert rt["meta"]["null_points_summary"] == rj["meta"]["null_points_summary"]
    for key in ("coh_drop_sum", "anchor_pen_sum", "query_term_sum"):
        assert _rel(rt[key], rj[key]) <= 1e-4, key
    assert lt.chain_receipt(CHAIN)["verdict"] == lj.chain_receipt(CHAIN)["verdict"]
    assert [b["id"] for b in lt.bundle(k=6)] == [b["id"] for b in lj.bundle(k=6)]
    assert [b["id"] for b in lt.bundle(k=6, diversify=False)] == [
        b["id"] for b in lj.bundle(k=6, diversify=False)
    ]
    np.testing.assert_allclose(lt.U, lj.U, rtol=1e-5, atol=1e-5)


def test_receipt_meta_keys_match_jax():
    lj, lt = _pair()
    rj, rt = lj.receipt(), lt.receipt()
    assert set(rt) == set(rj)
    assert set(rt["meta"]) == set(rj["meta"])
    for key in ("ustar_cached", "ustar_solves", "ustar_cache_hits", "ustar_converged",
                "deltaH_mode", "avg_degree", "edge_density", "similarity",
                "similarity_recall_target", "gates_uniform", "receipt_detail"):
        assert rt["meta"][key] == rj["meta"][key], key


@pytest.mark.parametrize("mode", ["minimal", "extended"])
def test_signed_receipts_cross_verify(mode):
    lj, lt = _pair(chain=False)
    for lat in (lj, lt):
        lat.set_receipt_secret("s3cret", kid="k1")
        lat.set_signature_mode(mode)
        lat.settle()
    rj, rt = lj.receipt(), lt.receipt()
    assert rt["meta"]["signature"]["kid"] == "k1"
    assert rt["meta"]["signature"]["payload"]["mode"] == mode
    for verify in (ot.verify_receipt, pt.verify_receipt):
        assert verify(rt, "s3cret") and verify(rj, "s3cret")
        assert verify(rt, {"k1": "s3cret"}) and not verify(rt, "other")
    ok, payload = ot.verify_receipt_mode(rt, "s3cret", require_mode=mode)
    assert ok and payload["state_sig"] == rj["meta"]["signature"]["payload"]["state_sig"]
    assert lt.verify_current_receipt("s3cret")


def test_light_receipt_and_null_cap_match_jax(monkeypatch):
    lj, lt = _pair(seed=3)
    for lat in (lj, lt):
        lat.settle()
        lat.set_receipt_detail("light")
    rj, rt = lj.receipt(), lt.receipt()
    assert rt["null_points"] == [] and rj["null_points"] == []
    assert _rel(rt["deltaH_total"], rj["deltaH_total"]) <= 1e-5
    monkeypatch.setenv("OSCILLINK_RECEIPT_NULL_CAP", "5")
    for lat in (lj, lt):
        lat.set_receipt_detail("full")
    rj, rt = lj.receipt(), lt.receipt()
    assert rt["meta"]["null_points_summary"] == rj["meta"]["null_points_summary"]
    assert [e["edge"] for e in rt["null_points"]] == [e["edge"] for e in rj["null_points"]]
    assert len(rt["null_points"]) == 5


def test_deterministic_receipt_mode(monkeypatch):
    monkeypatch.setenv("OSCILLINK_DETERMINISTIC_RECEIPTS", "1")
    lj, lt = _pair(seed=4)
    for lat in (lj, lt):
        lat.settle()
    rj, rt = lj.receipt(), lt.receipt()
    assert rt["meta"]["deltaH_mode"] == rj["meta"]["deltaH_mode"] == "deterministic-f64-tree"
    assert _rel(rt["deltaH_total"], rj["deltaH_total"]) <= 1e-5
    assert lt.receipt()["deltaH_total"] == rt["deltaH_total"]  # run-stable


def test_settle_options_match_jax():
    lj, lt = _pair(seed=5)
    for kw in (dict(dt=0.5, max_iters=30, tol=1e-5), dict(warm_start=False),
               dict(inertia=0.4), dict(precond="none", max_iters=20)):
        sj, st_ = lj.settle(**kw), lt.settle(**kw)
        assert int(st_["iters"]) == int(sj["iters"]), kw
        np.testing.assert_allclose(lt.U, lj.U, rtol=1e-5, atol=1e-5)


def test_dynamics_match_jax(monkeypatch):
    monkeypatch.setenv("OSCILLINK_RECEIPT_DYNAMICS", "1")
    lj, lt = _pair(seed=6)
    lj.settle()
    lt.settle()
    dj, dt = lj.receipt()["meta"]["dynamics"], lt.receipt()["meta"]["dynamics"]
    assert dt["radius"] == dj["radius"]
    for key in ("temperature", "step_deltaH", "flow_total", "move2_max"):
        assert _rel(dt[key], dj[key]) <= 1e-4, key
    # each undirected edge appears once per direction with the same flow in
    # the port; XLA's reductions may give the two directions flows one ulp
    # apart, which orders such a pair the other way round
    assert [sorted(f["edge"]) for f in dt["top_flows"]] == [
        sorted(f["edge"]) for f in dj["top_flows"]
    ]


def test_ustar_cache_stats_logger_and_callbacks():
    Y, psi = _inputs(seed=7)
    lat = pt.Oscillink(Y, kneighbors=6, device="cpu")
    events, seen = [], []
    lat.set_logger(lambda ev, payload: events.append(ev))
    lat.add_settle_callback(lambda lattice, stats: seen.append(stats["iters"]))
    lat.set_query(psi)
    lat.settle()
    U1 = lat.solve_Ustar()
    U2 = lat.solve_Ustar()
    assert U1 is U2 and lat.stats == {"ustar_solves": 1, "ustar_cache_hits": 1}
    assert lat.receipt()["meta"]["ustar_cached"] is True
    lat.refresh_Ustar()
    assert lat.stats["ustar_solves"] == 2
    assert seen and {"settle", "ustar_solve", "ustar_cache_hit", "receipt"} <= set(events)
    lat.clear_chain()
    lat.lamQ = 2.0  # a coefficient change must not reuse stale device scalars
    assert float(lat._lam().lamQ) == 2.0


def test_host_arrays_do_not_alias_lattice_state():
    Y, psi = _inputs(n=60, d=16, seed=9)
    lat = pt.Oscillink(Y, kneighbors=5, device="cpu")
    lat.set_query(psi)
    lat.settle()
    U = lat.U
    U[:] = 0.0
    assert not np.allclose(lat.U, 0.0)
    src = np.ones_like(Y)
    lat.U = src
    src[:] = 5.0
    assert np.all(lat.U == 1.0)
    Us = lat.solve_Ustar()
    assert not Us.flags.writeable and lat.solve_Ustar() is Us


def test_json_line_logger_writes_events():
    import io

    buf = io.StringIO()
    Y, psi = _inputs(n=30, d=8, seed=8)
    lat = pt.Oscillink(Y, kneighbors=4, device="cpu")
    lat.set_logger(pt.json_line_logger(buf))
    lat.set_query(psi)
    lat.settle()
    events = [json.loads(line)["event"] for line in buf.getvalue().splitlines()]
    assert "settle" in events and "invalidate_cache" in events


def test_input_guards_match_jax():
    Y, psi = _inputs(n=40, d=8)
    for bad in (dict(kneighbors=0), dict(lamG=0.0), dict(lamC=-1.0), dict(similarity="nope")):
        with pytest.raises(ValueError):
            pt.Oscillink(Y, device="cpu", **bad)
        with pytest.raises(ValueError):
            ot.Oscillink(Y, **bad)
    lat = pt.Oscillink(Y, kneighbors=4, device="cpu")
    with pytest.raises(ValueError):
        lat.set_query(psi[:4])
    with pytest.raises(ValueError):
        lat.add_chain([1, 40])
    with pytest.raises(ValueError):
        lat.chain_receipt([3])
    assert lat.bundle(k=0) == []


def test_unported_features_raise_not_implemented():
    Y, _ = _inputs(n=40, d=8)
    with pytest.raises(NotImplementedError, match="queue A"):
        pt.Oscillink(Y, neighbor_seed=3, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        pt.Oscillink(Y, similarity="fast", device="cpu")
    lat = pt.Oscillink(Y, kneighbors=4, device="cpu")
    for call in (lat.rebuild_graph, lat.export_state, lat.save_state,
                 pt.OscillinkLattice.from_state, pt.OscillinkLattice.from_npz):
        with pytest.raises(NotImplementedError):
            call()


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    Y, _ = _inputs(n=20, d=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.Oscillink(Y)
    from oscillink_tpu_torch import interop

    with pytest.raises(RuntimeError):
        interop.energy_from_numpy(1.0, 0.5, 4.0)
    with pytest.raises(ValueError):
        pt.Oscillink(Y, device="meta")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib, json\n"
        "import oscillink_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'oscillink_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'scripts')\n"
        "import profile_torch_main_path\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m.startswith('jaxlib')"
        " or m == 'oscillink_tpu' or m.startswith('oscillink_tpu.')]\n"
        "ours = sorted(m for m in sys.modules if m.startswith('oscillink_tpu_torch'))\n"
        "print(json.dumps([bad, ours]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    bad, ours = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    # the windowed tier's modules, K5 and its probe, and the multi-query
    # serving modules are among those walked
    assert {"oscillink_tpu_torch.ops.kernels.window_spmv", "oscillink_tpu_torch.ops.kernels.build",
            "oscillink_tpu_torch.models.coherence", "oscillink_tpu_torch.interop",
            "oscillink_tpu_torch.ops.kernels.bucket_gather",
            "oscillink_tpu_torch.benchmarks.probe_bucket_gather",
            "oscillink_tpu_torch.models.batched", "oscillink_tpu_torch.models.ragged",
            "oscillink_tpu_torch.models.oneshot", "oscillink_tpu_torch.preprocess.diffusion",
            "oscillink_tpu_torch.core.perf", "oscillink_tpu_torch.core.provenance"} <= set(ours)


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
