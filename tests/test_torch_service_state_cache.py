"""The port's lattice as the service's caches use it: state export/import
roundtrips, U* caching, chain handling and signatures, the cases of
``tests/test_state_and_cache.py`` on ``oscillink_tpu_torch`` with
``device="cpu"``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu_torch import OscillinkLattice  # noqa: E402


def _lat(seed=0, n=30, d=10):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    lat = OscillinkLattice(Y, kneighbors=4, deterministic_k=True, device="cpu")
    lat.set_query(rng.standard_normal(d).astype(np.float32))
    return lat


def test_json_roundtrip(tmp_path):
    lat = _lat()
    lat.add_chain([1, 2, 3], lamP=0.3)
    p = str(tmp_path / "state.json")
    lat.save_state(p, format="json")
    lat2 = OscillinkLattice.from_state(__import__("json").load(open(p)), device="cpu")
    assert lat2.N == lat.N and lat2.D == lat.D
    assert lat2.adjacency_fingerprint() == lat.adjacency_fingerprint()
    np.testing.assert_allclose(lat2.psi, lat.psi)
    np.testing.assert_allclose(lat2.B_diag, lat.B_diag)
    assert lat2.lamP == lat.lamP


def test_npz_roundtrip(tmp_path):
    lat = _lat(1)
    p = str(tmp_path / "state.npz")
    lat.save_state(p, format="npz")
    lat2 = OscillinkLattice.from_npz(p, device="cpu")
    assert lat2.N == lat.N
    assert lat2.adjacency_fingerprint() == lat.adjacency_fingerprint()


def test_invalid_format_raises(tmp_path):
    lat = _lat(2)
    with pytest.raises(ValueError):
        lat.save_state(str(tmp_path / "x"), format="yaml")


def test_ustar_cache_hit_and_invalidation():
    lat = _lat(3)
    lat.solve_Ustar()
    assert lat.stats["ustar_solves"] == 1
    lat.solve_Ustar()
    assert lat.stats["ustar_cache_hits"] >= 1
    assert lat.stats["ustar_solves"] == 1
    # changing the query invalidates
    lat.set_query(np.zeros(lat.D, dtype=np.float32))
    lat.solve_Ustar()
    assert lat.stats["ustar_solves"] == 2


def test_refresh_ustar_forces_solve():
    lat = _lat(4)
    lat.solve_Ustar()
    lat.refresh_Ustar()
    assert lat.stats["ustar_solves"] == 2


def test_chain_validation():
    lat = _lat(5)
    with pytest.raises(ValueError):
        lat.add_chain([0], lamP=0.1)
    with pytest.raises(ValueError):
        lat.add_chain([0, 99999], lamP=0.1)
    with pytest.raises(ValueError):
        lat.add_chain([0, 1], lamP=-1.0)
    with pytest.raises(ValueError):
        lat.add_chain([0, 1, 2], lamP=0.1, weights=[1.0])
    lat.add_chain([0, 1, 2], lamP=0.1)
    assert lat.lamP == 0.1
    lat.clear_chain()
    assert lat.lamP == 0.0 and lat._chain_nodes is None


def test_signature_changes_with_state():
    lat = _lat(6)
    s0 = lat._signature()
    lat.set_query(np.ones(lat.D, dtype=np.float32))
    assert lat._signature() != s0
    lat.add_chain([0, 1], lamP=0.2)
    assert lat._signature() != s0


def test_provenance_compare():
    from oscillink_tpu_torch import compare_provenance

    a = _lat(7)
    b = _lat(7)
    out = compare_provenance(a, b)
    assert out["same"]
    b.set_query(np.ones(b.D, dtype=np.float32))
    out2 = compare_provenance(a, b)
    assert not out2["same"] and not out2["psi_equal"]
