"""The port's native C++ engine (`oscillink_tpu_torch.native`): the JAX
package's 15 engine tests on the port's engine and lattice (CPU), and the
port's engine bit-equal to the JAX package's on the same inputs."""

import hashlib
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from oscillink_tpu.native import NativeEngine as JaxEngine  # noqa: E402
from oscillink_tpu.oracle.reference import DenseOracle, laplacian_dense  # noqa: E402
from oscillink_tpu_torch import OscillinkLattice  # noqa: E402
from oscillink_tpu_torch.native import NativeEngine, engine, native_available  # noqa: E402

pytestmark = pytest.mark.skipif(not native_available(), reason="native build unavailable")


def _data(n=48, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, d)).astype(np.float32),
        rng.standard_normal(d).astype(np.float32),
    )


def _lattice(Y, k, psi=None):
    lat = OscillinkLattice(Y, kneighbors=k, deterministic_k=True, device="cpu")
    if psi is not None:
        lat.set_query(psi)
    return lat


def test_engine_source_is_the_jax_packages_byte_for_byte():
    import oscillink_tpu.native.engine as jax_engine

    ours = engine._SRC.read_bytes()
    assert hashlib.sha256(ours).digest() == hashlib.sha256(jax_engine._SRC.read_bytes()).digest()
    assert engine._SRC.parent.name == "native" and "oscillink_tpu_torch" in str(engine._SRC)


def test_native_graph_matches_oracle():
    Y, _ = _data()
    eng = NativeEngine(Y, kneighbors=5)
    orc = DenseOracle(Y, k=5, deterministic_k=True)
    A_native = eng.dense_adjacency()
    np.testing.assert_allclose(A_native, orc.A, rtol=1e-4, atol=1e-5)
    assert np.array_equal(A_native > 0, orc.A > 0)


def test_native_graph_matches_oracle_blas_path():
    """n > 192 routes through osc_build_graph_from_sims."""
    Y, _ = _data(n=400, d=24, seed=3)
    eng = NativeEngine(Y, kneighbors=6)
    orc = DenseOracle(Y, k=6, deterministic_k=True)
    A_native = eng.dense_adjacency()
    np.testing.assert_allclose(A_native, orc.A, rtol=1e-4, atol=1e-5)
    assert np.array_equal(A_native > 0, orc.A > 0)


def test_native_topk_tie_break_matches_oracle():
    rng = np.random.default_rng(7)
    Y = (rng.integers(-1, 2, size=(300, 8))).astype(np.float32)
    Y[Y.sum(axis=1) == 0, 0] = 1.0
    eng = NativeEngine(Y, kneighbors=4)
    orc = DenseOracle(Y, k=4, deterministic_k=True)
    np.testing.assert_allclose(eng.dense_adjacency(), orc.A, rtol=1e-4, atol=1e-5)


def test_native_ustar_matches_oracle():
    Y, psi = _data(seed=1)
    eng = NativeEngine(Y, kneighbors=5)
    eng.set_query(psi)
    U_native, iters, res = eng.solve_ustar(tol=1e-6, max_iters=200)
    assert res < 1e-5
    orc = DenseOracle(Y, k=5, deterministic_k=True)
    orc.set_query(psi)
    orc.A = eng.dense_adjacency()
    orc.L, orc.sqrt_deg = laplacian_dense(orc.A)
    U_orc, _, _ = orc.solve_ustar(tol=1e-6, max_iters=200)
    np.testing.assert_allclose(U_native, U_orc, rtol=2e-4, atol=2e-4)


def test_native_settle_and_deltaH():
    Y, psi = _data(seed=2)
    eng = NativeEngine(Y, kneighbors=4)
    eng.set_query(psi)
    stats = eng.settle(max_iters=30, tol=1e-5)
    assert stats["res"] <= 1e-5 and stats["iters"] >= 1
    Ustar, _, _ = eng.solve_ustar(tol=1e-6, max_iters=200)
    assert eng.deltaH(eng.U, Ustar) >= -1e-3


def test_native_matches_port_lattice():
    Y, psi = _data(n=40, d=12, seed=3)
    eng = NativeEngine(Y, kneighbors=4)
    eng.set_query(psi)
    lat = _lattice(Y, 4, psi)
    g = lat.graph
    np.testing.assert_array_equal(
        eng.idx * (eng.w > 0), g.idx.numpy() * (g.w.numpy() > 0)
    )
    U_native, _, _ = eng.solve_ustar(tol=1e-6, max_iters=200)
    np.testing.assert_allclose(U_native, lat.solve_Ustar(tol=1e-6, max_iters=200),
                               rtol=3e-4, atol=3e-4)


def test_native_chain_matches_port_lattice():
    Y, psi = _data(n=40, d=12, seed=5)
    chain = [1, 4, 7, 9]
    eng = NativeEngine(Y, kneighbors=4)
    eng.set_query(psi)
    eng.add_chain(chain, lamP=0.3)
    U_native, _, res_n = eng.solve_ustar(tol=1e-6, max_iters=200)
    assert res_n <= 1e-5
    lat = _lattice(Y, 4, psi)
    lat.add_chain(chain, lamP=0.3)
    np.testing.assert_allclose(U_native, lat.solve_Ustar(tol=1e-6, max_iters=200),
                               rtol=3e-4, atol=3e-4)
    eng.clear_chain()
    U_nc, _, _ = eng.solve_ustar(tol=1e-6, max_iters=200)
    lat.clear_chain()
    np.testing.assert_allclose(U_nc, lat.solve_Ustar(tol=1e-6, max_iters=200),
                               rtol=3e-4, atol=3e-4)


def test_native_speed_small_n():
    Y, psi = _data(n=128, d=64, seed=4)
    NativeEngine(Y, kneighbors=6)
    t0 = time.perf_counter()
    eng2 = NativeEngine(Y, kneighbors=6)
    eng2.set_query(psi)
    eng2.settle(max_iters=12, tol=1e-3)
    assert 1000 * (time.perf_counter() - t0) < 250.0


def test_ustar_cache_and_invalidation():
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((80, 16)).astype(np.float32)
    psi = (Y[:8].mean(0) / np.linalg.norm(Y[:8].mean(0))).astype(np.float32)
    eng = NativeEngine(Y, kneighbors=4)
    eng.set_query(psi)
    U1, i1, r1 = eng.solve_ustar()
    U2, i2, r2 = eng.solve_ustar()
    assert U2 is U1 and (i2, r2) == (i1, r1)
    pn1 = eng.per_node(U1)
    assert eng.per_node(U2)[0] is pn1[0]
    psi2 = (Y[-8:].mean(0) / np.linalg.norm(Y[-8:].mean(0))).astype(np.float32)
    eng.set_query(psi2)
    U3, _, _ = eng.solve_ustar()
    assert U3 is not U1 and not np.allclose(U3, U1)
    eng.add_chain([0, 1, 2], lamP=0.2)
    U4, _, _ = eng.solve_ustar()
    assert U4 is not U3
    eng.clear_chain()
    U5, _, _ = eng.solve_ustar()
    assert U5 is not U4
    np.testing.assert_allclose(U5, U3, rtol=1e-5, atol=1e-6)
    U6, _, _ = eng.solve_ustar(use_cache=False)
    np.testing.assert_allclose(U6, U5, rtol=1e-6)


def test_cached_ustar_is_frozen():
    rng = np.random.default_rng(4)
    Y = rng.standard_normal((40, 8)).astype(np.float32)
    eng = NativeEngine(Y, kneighbors=3)
    eng.set_query((Y[0] / np.linalg.norm(Y[0])).astype(np.float32))
    U, _, _ = eng.solve_ustar()
    with pytest.raises(ValueError):
        U[0, 0] = 99.0
    U2, _, _ = eng.solve_ustar(use_cache=False)
    U2[0, 0] = 99.0


def test_native_diffusion_gates_match_port_lattice():
    for seed, (n, d, k) in enumerate(((60, 16, 4), (200, 24, 6))):
        Y, psi = _data(n=n, d=d, seed=seed)
        psi = (psi / (np.linalg.norm(psi) + 1e-12)).astype(np.float32)
        eng = NativeEngine(Y, kneighbors=k)
        eng.set_query(psi)
        h_native = eng.diffusion_gates(beta=1.3, gamma=0.15, tol=1e-5, max_iters=512)
        h_port = _lattice(Y, k, psi).diffusion_gates(beta=1.3, gamma=0.15, tol=1e-5,
                                                      max_iters=512)
        assert h_native.shape == (n,)
        assert float(np.abs(h_native - h_port).max()) < 5e-4
        assert h_native.min() >= 0.0 and h_native.max() <= 1.0
        eng.diffusion_gates(beta=1.3, gamma=0.15, tol=1e-5, max_iters=512, apply=True)
        assert np.allclose(eng.B, h_native, atol=1e-6)


def test_native_diffusion_gates_validation():
    Y, psi = _data(n=30, d=8, seed=9)
    eng = NativeEngine(Y, kneighbors=3)
    eng.set_query(psi)
    with pytest.raises(ValueError):
        eng.diffusion_gates(gamma=0.0)
    with pytest.raises(ValueError):
        eng.diffusion_gates(psi=np.zeros(5, np.float32))


def _walk_chain(eng, length=4):
    deg = (eng.w > 0).sum(1)
    chain = [int(np.argmax(deg))]
    for _ in range(length - 1):
        i = chain[-1]
        js = [int(j) for a, j in enumerate(eng.idx[i]) if eng.w[i, a] > 0 and int(j) not in chain]
        if not js:
            break
        chain.append(js[0])
    return chain


def test_native_chain_receipt_matches_port_lattice():
    rng = np.random.default_rng(0)
    n, d, k = 80, 16, 5
    centers = rng.standard_normal((4, d)).astype(np.float32)
    Y = (centers[np.arange(n) % 4] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    psi = (Y[0] / np.linalg.norm(Y[0])).astype(np.float32)
    eng = NativeEngine(Y, kneighbors=k)
    eng.set_query(psi)
    chain = _walk_chain(eng)
    assert len(chain) >= 2
    cr_n = eng.chain_receipt(chain)
    cr_d = _lattice(Y, k, psi).chain_receipt(chain)
    assert cr_n["verdict"] == cr_d["verdict"]
    assert cr_n["weakest_link"]["edge"] == cr_d["weakest_link"]["edge"]
    for en, ed in zip(cr_n["edges"], cr_d["edges"]):
        for f in ("z_struct", "z_path", "r_struct", "r_path"):
            assert abs(en[f] - ed[f]) <= max(2e-3, 2e-3 * abs(ed[f])), (f, en, ed)
    assert cr_d["coherence_gain"] != 0.0
    rel = abs(cr_n["coherence_gain"] - cr_d["coherence_gain"]) / (abs(cr_d["coherence_gain"]) + 1e-9)
    assert rel < 5e-3


def test_native_chain_receipt_validation():
    Y, psi = _data(n=30, d=8, seed=2)
    eng = NativeEngine(Y, kneighbors=3)
    eng.set_query(psi)
    with pytest.raises(ValueError):
        eng.chain_receipt([1])
    with pytest.raises(ValueError):
        eng.chain_receipt([0, 99])


def test_native_chain_receipt_mismatched_chain_matches_port_lattice():
    rng = np.random.default_rng(4)
    n, d, k = 60, 12, 5
    Y = rng.standard_normal((n, d)).astype(np.float32)
    psi = (Y[0] / np.linalg.norm(Y[0])).astype(np.float32)
    installed, queried = [0, 3, 7, 11], [2, 5, 9]
    eng = NativeEngine(Y, kneighbors=k)
    eng.set_query(psi)
    eng.add_chain(installed, lamP=0.2)
    cr_n = eng.chain_receipt(queried)
    lat = _lattice(Y, k, psi)
    lat.add_chain(installed, lamP=0.2)
    cr_d = lat.chain_receipt(queried)
    assert cr_n["verdict"] == cr_d["verdict"]
    for en, ed in zip(cr_n["edges"], cr_d["edges"]):
        for f in ("z_struct", "z_path", "r_struct", "r_path"):
            assert abs(en[f] - ed[f]) <= max(3e-3, 3e-3 * abs(ed[f])), (f, en, ed)


# -- the port's engine against the JAX package's, bit for bit ----------------


def _drive(cls, Y, psi, *, chain=None, diffusion=False, gates=None):
    """Every output of one engine on one input, as bytes-comparable arrays."""
    eng = cls(Y, kneighbors=5)
    eng.set_query(psi, gates=gates)
    if diffusion:
        eng.diffusion_gates(beta=1.2, gamma=0.1, apply=True)
    if chain:
        eng.add_chain(chain, lamP=0.25)
    out = {"idx": eng.idx, "w": eng.w, "sqrt_deg": eng.sqrt_deg, "B": eng.B}
    stats = eng.settle(max_iters=12, tol=1e-3)
    out["U"] = eng.U
    out["settle"] = np.array([stats["iters"], stats["res"]])
    Ustar, iters, res = eng.solve_ustar()
    out["Ustar"] = Ustar
    out["ustar"] = np.array([iters, res])
    out["deltaH"] = np.array([eng.deltaH(eng.U, Ustar)])
    out.update(zip(("coh", "anchor", "query"), eng.per_node(Ustar)))
    out["nulls"] = np.array([[*e["edge"], e["z"], e["residual"]] for e in eng.null_points(Ustar)])
    for mode in (True, False):
        out[f"bundle_{mode}"] = np.array(
            [[e["id"], e["score"], e["align"]] for e in eng.bundle(k=6, diversify=mode)])
    cr = eng.chain_receipt(chain or [0, 1, 2])
    out["chain"] = np.array([[e["z_struct"], e["z_path"], e["r_struct"], e["r_path"]]
                             for e in cr["edges"]] + [[cr["coherence_gain"], 0, 0, 0]])
    out["batch"] = np.array([[e["score"] for e in q] for q in eng.bundle_batch(
        np.stack([psi, -psi]), k=4)])
    return out


@pytest.mark.parametrize("n,d,kw", [
    (40, 12, {}),
    (300, 24, {}),  # the BLAS similarity path
    (120, 16, {"chain": [3, 9, 27, 81]}),
    (150, 16, {"diffusion": True}),
    (90, 10, {"gates": "random"}),
])
def test_port_engine_is_bit_equal_to_the_jax_engine(n, d, kw):
    Y, psi = _data(n=n, d=d, seed=n)
    if kw.get("gates") == "random":
        kw = {"gates": np.random.default_rng(1).uniform(0.2, 1.0, n).astype(np.float32)}
    ours, theirs = _drive(NativeEngine, Y, psi, **kw), _drive(JaxEngine, Y, psi, **kw)
    assert ours.keys() == theirs.keys()
    for key in ours:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), key


def test_a_failed_build_raises_with_the_compilers_message(monkeypatch, tmp_path):
    """Where the JAX binding returns None, the port's raises, and remembers
    the failure for that library path and compiler."""
    monkeypatch.setenv("OSCILLINK_NATIVE_CACHE", str(tmp_path / "empty"))
    monkeypatch.setenv("CXX", "/bin/false")
    monkeypatch.setattr(engine, "_FAILED", {})
    with pytest.raises(engine.NativeBuildError, match="native engine build failed.*/bin/false"):
        engine.load_engine()
    assert not native_available()
    calls = []
    monkeypatch.setattr(engine.subprocess, "run", lambda *a, **k: calls.append(a))
    with pytest.raises(engine.NativeBuildError):
        NativeEngine(np.eye(3, dtype=np.float32))
    assert calls == []  # the failure is remembered: no second compile


def test_a_missing_source_is_a_build_error(monkeypatch, tmp_path):
    monkeypatch.setattr(engine, "_SRC", tmp_path / "engine.cpp")
    with pytest.raises(engine.NativeBuildError, match="source .* is missing"):
        engine.load_engine()
    assert not native_available()


def test_the_library_lands_in_the_cache_dir_keyed_by_source_and_flags(monkeypatch, tmp_path):
    monkeypatch.setenv("OSCILLINK_NATIVE_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("OSCILLINK_NATIVE_MARCH", "")
    monkeypatch.setattr(engine, "_LIBS", {})
    lib = engine.load_engine()
    built = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert len(built) == 1 and built[0].startswith("oscnative_") and built[0].endswith(".so")
    assert built[0] == engine._lib_path(engine._base_flags()).name
    assert lib.osc_settle is not None
    monkeypatch.delenv("OSCILLINK_NATIVE_CACHE")
    assert engine._lib_path(engine._base_flags()).parent == engine._kbuild.BUILD_DIR
