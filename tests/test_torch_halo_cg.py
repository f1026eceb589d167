"""The port's halo-exchange tiers (`parallel.halo_cg`) against the JAX
package's on its 8-virtual-device CPU mesh, the window kernels of both in
their plain forms (the JAX ones in interpret mode), on the corpora of
``tests/test_halo_cg.py``.

* `build_halo_plan`: every array equal to the JAX plan's.
* `halo_solve` (f32 gathers) and `halo_solve_windowed` (on the JAX package's
  own graph and per-shard plans, carried by `interop`), port against JAX:
  U within 1e-5 of max|U|, identical iterations; against the port's
  single-device solve, the JAX test's 3e-4 (``tests/test_halo_cg.py:66``);
  windowed against gather within 5e-4 and one iteration (``:151-153``).
* bf16 gathers: the JAX test's bar against f32 (2e-3 in norm); against
  the JAX bf16 solve within BF16_REL in norm (1.8e-7 measured) and
  iterations equal; and apart from the port's f32 solve by more than
  BF16_REL (1.2e-4 measured), so a bf16 request that reads f32 fails.
* `solve_auto`: the JAX tier choice; and the port's routing divergence,
  pinned at rows_per >= 1024: under ``auto`` the windowed halo tier is
  not taken, with the reason in the info (ROADMAP queue C).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscillink_tpu.models.coherence import EnergyParams as JaxEnergy  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jax_build_graph  # noqa: E402
from oscillink_tpu.parallel import halo_cg as jh  # noqa: E402
from oscillink_tpu.parallel.mesh import lattice_mesh as jax_mesh  # noqa: E402
from oscillink_tpu.parallel.reorder import apply_order, pca_bisection_order as jax_order  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.models.coherence import solve_stationary  # noqa: E402
from oscillink_tpu_torch.parallel import halo_cg as th  # noqa: E402
from oscillink_tpu_torch.parallel.mesh import gather_rows, lattice_mesh  # noqa: E402

CPU8 = [torch.device("cpu")] * 8
REL = 1e-5
BF16_REL = 1e-5


def _clustered(n, d, seed=0):
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((16, d)).astype(np.float32)
    assign = rng.integers(0, 16, size=n)
    return centers[assign] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)


def _case(n, d, seed, psi_seed, levels, k=6):
    """The JAX test's corpus in the JAX package's order, its graph, and
    both packages' copies of it."""
    Y = _clustered(n, d, seed)
    (Y,) = apply_order(jax_order(Y, levels=levels), Y)[:1]
    psi = np.random.default_rng(psi_seed).standard_normal(d).astype(np.float32)
    g = jax.jit(lambda Y: jax_build_graph(Y, k))(jnp.asarray(Y))
    gt = interop.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    return Y, psi, np.ones(n, np.float32), g, gt


LAM = dict(lamG=1.0, lamC=0.5, lamQ=4.0)


def _lams():
    return JaxEnergy.make(1.0, 0.5, 4.0, 0.0), interop.energy_from_numpy(1.0, 0.5, 4.0, device="cpu")


def _hold(U_port, U_jax, rel=REL):
    U_port, U_jax = gather_rows(U_port).numpy(), np.asarray(U_jax)
    assert np.abs(U_port - U_jax).max() <= rel * np.abs(U_jax).max()
    return U_port


@pytest.mark.parametrize("n,d,seed,shards,k", [(256, 16, 0, 8, 4), (512, 24, 1, 8, 6),
                                               (2048, 32, 2, 4, 6), (8192, 24, 3, 8, 6)])
def test_halo_plan_equals_jax(n, d, seed, shards, k):
    _, _, _, g, _ = _case(n, d, seed, 0, 3, k)
    idx, w = np.asarray(g.idx), np.asarray(g.w)
    ours, ref = th.build_halo_plan(idx, w, shards), jh.build_halo_plan(idx, w, shards)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
    carried = interop.halo_plan_from_numpy(*ref)
    for a, b in zip(carried, ours):
        np.testing.assert_array_equal(a, b)
    # every valid edge's remap resolves to its global row
    rp = ours.rows_per
    rows, cols = np.nonzero(w > 0)
    m = ours.remap[rows, cols]
    lo = (rows // rp) * rp
    local = m < rp
    assert (lo[local] + m[local] == idx[rows, cols][local]).all()
    src, slot = np.divmod(m[~local] - rp, ours.r_max)
    dst = rows[~local] // rp
    assert ours.send_valid[src, dst, slot].all()
    assert (src * rp + ours.send_map[src, dst, slot] == idx[rows, cols][~local]).all()


@pytest.mark.parametrize("n,d,seed,psi_seed", [(512, 24, 1, 2), (2048, 32, 5, 6)])
def test_halo_solve_matches_jax_and_single_device(n, d, seed, psi_seed):
    Y, psi, B, g, gt = _case(n, d, seed, psi_seed, 3)
    lj, lt = _lams()
    plan = jh.build_halo_plan(np.asarray(g.idx), np.asarray(g.w), 8)
    Uj, itj, _ = jh.halo_solve(jax_mesh(8), g, plan, jnp.asarray(Y), jnp.asarray(psi),
                               jnp.asarray(B), lj, tol=1e-6, max_iters=200)
    U_l, it, res = th.halo_solve(lattice_mesh(devices=CPU8), gt, interop.halo_plan_from_numpy(*plan),
                                 Y, psi, B, lt, tol=1e-6, max_iters=200)
    U = _hold(U_l, Uj)
    assert it == int(itj) and res <= 1e-5
    U1, it1, _ = solve_stationary(gt, None, torch.from_numpy(Y), torch.from_numpy(psi),
                                  torch.from_numpy(B), lt, tol=1e-6, max_iters=200)
    np.testing.assert_allclose(U, U1.numpy(), rtol=3e-4, atol=3e-4)
    assert abs(it - it1) <= 1
    assert plan.r_max * 8 < n - plan.rows_per


def test_halo_solve_bf16_gathers():
    rng = np.random.default_rng(0)
    n, d, k = 2048, 32, 6
    Y = rng.standard_normal((n, d)).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    B = np.ones(n, np.float32)
    g = jax.jit(lambda Y: jax_build_graph(Y, k))(jnp.asarray(Y))
    gt = interop.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    plan = jh.build_halo_plan(np.asarray(g.idx), np.asarray(g.w), 8)
    lj, lt = _lams()
    mesh = lattice_mesh(devices=CPU8)
    U32, it32, _ = th.halo_solve(mesh, gt, plan, Y, psi, B, lt, tol=1e-4, max_iters=48)
    U16, it16, _ = th.halo_solve(mesh, gt, plan, Y, psi, B, lt, tol=1e-4, max_iters=48,
                                 gather_dtype="bfloat16")
    U32, U16 = gather_rows(U32).numpy(), gather_rows(U16).numpy()
    rel_f32 = np.linalg.norm(U16 - U32) / np.linalg.norm(U32)
    assert BF16_REL < rel_f32 < 2e-3
    Uj, itj, _ = jh.halo_solve(jax_mesh(8), g, plan, jnp.asarray(Y), jnp.asarray(psi),
                               jnp.asarray(B), lj, tol=1e-4, max_iters=48, gather_dtype="bfloat16")
    Uj = np.asarray(Uj)
    assert np.linalg.norm(U16 - Uj) / np.linalg.norm(Uj) < BF16_REL and it16 == int(itj)


@pytest.fixture(scope="module")
def windowed_case():
    """tests/test_halo_cg.py's windowed corpus: 8192 x 24, 8 shards, the
    JAX package's graph, plan and per-shard window plans."""
    Y, psi, B, g, gt = _case(8192, 24, 3, 4, 4)
    plan = jh.build_halo_plan(np.asarray(g.idx), np.asarray(g.w), 8)
    wplan, woh, cov, s_max = jh.build_shard_window_plans(plan, np.asarray(g.wn), 8)
    return dict(Y=Y, psi=psi, B=B, g=g, gt=gt, plan=plan, wplan=wplan, woh=woh, cov=cov,
                s_max=s_max)


def test_shard_window_plans_equal_jax(windowed_case):
    c = windowed_case
    plans, ohs, cov, s_max = th.build_shard_window_plans(c["plan"], np.asarray(c["g"].wn), 8,
                                                         mesh=lattice_mesh(devices=CPU8))
    assert cov == c["cov"] and s_max == c["s_max"] and s_max >= 128
    for s in range(8):
        for f, a in zip(c["wplan"]._fields, c["wplan"]):
            np.testing.assert_array_equal(getattr(plans[s], f).numpy(), np.asarray(a)[s])
        for f, a in zip(c["woh"]._fields, c["woh"]):
            np.testing.assert_array_equal(getattr(ohs[s], f).float().numpy(),
                                          np.asarray(a)[s].astype(np.float32))
        # the shared s_max's straggler read stays inside every shard's arrays
        assert int(plans[s].strag_off[-1]) + s_max <= plans[s].strag_w.shape[0]


def test_halo_solve_windowed_matches_jax_and_gather(windowed_case):
    c = windowed_case
    lj, lt = _lams()
    mesh = lattice_mesh(devices=CPU8)
    plans, ohs = interop.shard_window_plans_from_numpy(c["wplan"], c["woh"], W=384,
                                                       s_max=c["s_max"], devices=CPU8)
    args_j = (jnp.asarray(c["Y"]), jnp.asarray(c["psi"]), jnp.asarray(c["B"]), lj)
    Uj, itj, _ = jh.halo_solve_windowed(jax_mesh(8), c["g"], c["plan"], c["wplan"], c["woh"],
                                        *args_j, tol=1e-6, max_iters=200)
    U_l, it, res = th.halo_solve_windowed(mesh, c["gt"], c["plan"], plans, ohs, c["Y"], c["psi"],
                                          c["B"], lt, tol=1e-6, max_iters=200)
    U = _hold(U_l, Uj)
    assert it == int(itj) and res <= 1e-5
    Ug, itg, _ = th.halo_solve(mesh, c["gt"], c["plan"], c["Y"], c["psi"], c["B"], lt, tol=1e-6,
                               max_iters=200)
    Ug = gather_rows(Ug).numpy()
    assert np.abs(U - Ug).max() / np.abs(Ug).max() < 5e-4 and abs(it - itg) <= 1


def test_halo_solve_windowed_dma16_tier(windowed_case, monkeypatch):
    c = windowed_case
    _, lt = _lams()
    mesh = lattice_mesh(devices=CPU8)
    plans, ohs, _, s_max = th.build_shard_window_plans(c["plan"], np.asarray(c["g"].wn), 8,
                                                       mesh=mesh)
    U_ref, _, _ = th.halo_solve_windowed(mesh, c["gt"], c["plan"], plans, ohs, c["Y"], c["psi"],
                                         c["B"], lt, tol=1e-6, max_iters=200)
    monkeypatch.setenv("OSCILLINK_WINDOW_PRECISION", "dma16")
    plans16, ohs16, _, _ = th.build_shard_window_plans(c["plan"], np.asarray(c["g"].wn), 8,
                                                       mesh=mesh)
    assert ohs16[0].main.dtype == torch.bfloat16
    U16, _, res16 = th.halo_solve_windowed(mesh, c["gt"], c["plan"], plans16, ohs16, c["Y"],
                                           c["psi"], c["B"], lt, tol=1e-6, max_iters=200)
    U_ref, U16 = gather_rows(U_ref).numpy(), gather_rows(U16).numpy()
    assert res16 <= 1e-5 and np.abs(U16 - U_ref).max() / np.abs(U_ref).max() < 5e-3


def test_solve_auto_matches_jax_tiers():
    rng = np.random.default_rng(5)
    Yc = _clustered(512, 24, seed=5)
    psi = rng.standard_normal(24).astype(np.float32)
    mesh = lattice_mesh(devices=CPU8)
    U, info = th.solve_auto(mesh, Yc, psi, k=6, tol=1e-6, max_iters=200)
    Uj, info_j = jh.solve_auto(jax_mesh(8), Yc, psi, k=6, tol=1e-6, max_iters=200)
    assert info["tier"] == info_j["tier"] == "halo-exchange"
    assert info["halo_stats"] == info_j["halo_stats"] and info["iters"] == info_j["iters"]
    assert np.abs(U - Uj).max() <= REL * np.abs(Uj).max() and info["res"] <= 1e-5
    assert set(info["stage_ms"]) == {"reorder", "sharded_build", "plan", "solve"}

    rng2 = np.random.default_rng(6)
    Yr = rng2.standard_normal((512, 128)).astype(np.float32)
    psi_r = rng2.standard_normal(128).astype(np.float32)
    Ur, info_r = th.solve_auto(mesh, Yr, psi_r, k=6, tol=1e-4, max_iters=50)
    Urj, info_rj = jh.solve_auto(jax_mesh(8), Yr, psi_r, k=6, tol=1e-4, max_iters=50)
    s = info_r["halo_stats"]
    assert info_r["tier"] == info_rj["tier"] == (
        "halo-exchange" if s["halo_mean"] < 0.5 * s["allgather_rows"] else "all-gather")
    assert s["halo_fraction_mean"] > 0.5
    assert np.abs(Ur - Urj).max() <= REL * np.abs(Urj).max() and info_r["iters"] == info_rj["iters"]


def test_solve_auto_bf16_tier_label(monkeypatch):
    monkeypatch.setenv("OSCILLINK_GATHER_DTYPE", "bfloat16")
    monkeypatch.setenv("OSCILLINK_WINDOWED_MATVEC", "0")
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((8, 16)).astype(np.float32) * 4
    Y = np.concatenate([c + 0.3 * rng.standard_normal((256, 16)).astype(np.float32)
                        for c in centers])
    psi = rng.standard_normal(16).astype(np.float32)
    U, info = th.solve_auto(lattice_mesh(devices=CPU8), Y, psi, k=6, tol=1e-3, max_iters=24)
    _, info_j = jh.solve_auto(jax_mesh(8), Y, psi, k=6, tol=1e-3, max_iters=24)
    assert info["tier"] == info_j["tier"] == "halo-exchange-bf16gather"
    assert np.isfinite(U).all()


@pytest.mark.parametrize("mode", ["auto", "1"])
def test_solve_auto_windowed_routing_at_1024_rows_a_shard(monkeypatch, mode):
    """8192 rows on 8 shards: 1024 rows a shard, where the JAX package
    considers the windowed halo tier.  Forced, the port takes it too (and
    agrees with the JAX tier); under ``auto`` the port keeps the gather
    halo tier and says why, while the JAX package accepts the plan on its
    coverage (ROADMAP queue C)."""
    monkeypatch.setenv("OSCILLINK_WINDOWED_MATVEC", mode)
    Y = _clustered(8192, 24, seed=3)
    psi = np.random.default_rng(4).standard_normal(24).astype(np.float32)
    U, info = th.solve_auto(lattice_mesh(devices=CPU8), Y, psi, k=6, tol=1e-6, max_iters=200)
    Uj, info_j = jh.solve_auto(jax_mesh(8), Y, psi, k=6, tol=1e-6, max_iters=200)
    assert info_j["tier"] == "halo-exchange-windowed" and info_j["window_coverage"] >= 0.92
    if mode == "1":
        assert info["tier"] == "halo-exchange-windowed"
        assert info["window_coverage"] == info_j["window_coverage"]
        assert info["window_skipped"] is None
    else:
        assert info["tier"] == "halo-exchange" and info["window_coverage"] is None
        assert "OSCILLINK_WINDOWED_MATVEC=1" in info["window_skipped"]
    # the two packages order this corpus with two near-tie swaps
    # (tests/test_torch_reorder.py), so U is held in the original order
    assert np.abs(U - Uj).max() / np.abs(Uj).max() < 5e-4 and abs(info["iters"] - info_j["iters"]) <= 1
