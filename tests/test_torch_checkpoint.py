"""The port's checkpoint (`OscillinkLattice.save_checkpoint` /
`from_checkpoint`, the counterpart of the JAX lattice's ``save_orbax`` /
``from_orbax``; ``tests/test_orbax_checkpoint.py::test_orbax_roundtrip``).

The port's round trip is held to the JAX package's round trip on the same
lattice: adjacency fingerprint, ``state_sig``, ΔH within 1e-5 relative,
null points, bundle ids and the chain verdict; and to the lattice it was
saved from, bit for bit (anchors, query, gates, the four graph tensors),
with no graph build on restore."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("orbax.checkpoint")

import oscillink_tpu as ot  # noqa: E402
from oscillink_tpu_torch import OscillinkLattice  # noqa: E402
from oscillink_tpu_torch.core import lattice as tlattice  # noqa: E402
from oscillink_tpu_torch.ops import ivf as tivf  # noqa: E402

DH_REL = 1e-5
CHAIN = [0, 1, 2]

CASES = {
    # test_orbax_roundtrip's lattice
    "chain": dict(n=30, d=10, seed=0, kw=dict(kneighbors=4, deterministic_k=True, lamQ=2.0),
                  chain=0.3),
    "neighbor_seed": dict(n=60, d=12, seed=1, kw=dict(kneighbors=5, neighbor_seed=7), chain=None),
    "col_chunks": dict(n=40, d=12, seed=5, kw=dict(kneighbors=4, deterministic_k=True),
                       chain=0.2, env={"OSCILLINK_COL_CHUNKS": "4"}),
    "default_k": dict(n=50, d=16, seed=2, kw=dict(kneighbors=6, lamC=0.7), chain=None),
}


def _inputs(case):
    rng = np.random.default_rng(case["seed"])
    Y = rng.standard_normal((case["n"], case["d"])).astype(np.float32)
    psi = rng.standard_normal(case["d"]).astype(np.float32)
    gates = rng.uniform(0.3, 1.0, case["n"]).astype(np.float32)
    return Y, psi, gates


def _build(cls, case, **dev):
    Y, psi, gates = _inputs(case)
    lat = cls(Y, **case["kw"], **dev)
    lat.set_query(psi, gates=gates)
    if case["chain"]:
        lat.add_chain(CHAIN, lamP=case["chain"])
    return lat


def _flow(lat):
    lat.settle(max_iters=12, tol=1e-3)
    rec = lat.receipt()
    return {
        "fingerprint": lat.adjacency_fingerprint(),
        "state_sig": rec["meta"]["state_sig"],
        "deltaH": rec["deltaH_total"],
        "nulls": [tuple(e["edge"]) for e in rec["null_points"]],
        "iters": (lat.last["iters"], rec["meta"]["ustar_iters"]),
        "bundle": [e["id"] for e in lat.bundle(k=5)],
        "verdict": lat.chain_receipt(CHAIN)["verdict"],
    }


def _same(port, ref):
    for key in ("fingerprint", "state_sig", "nulls", "iters", "bundle", "verdict"):
        assert port[key] == ref[key], (key, port[key], ref[key])
    assert abs(port["deltaH"] - ref["deltaH"]) <= DH_REL * abs(ref["deltaH"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_checkpoint_roundtrip_matches_the_jax_orbax_roundtrip(name, tmp_path, monkeypatch):
    case = CASES[name]
    for key, val in case.get("env", {}).items():
        monkeypatch.setenv(key, val)
    jax_lat = _build(ot.OscillinkLattice, case)
    jax_lat.save_orbax(str(tmp_path / "orbax"))
    jax_ref = _flow(ot.OscillinkLattice.from_orbax(str(tmp_path / "orbax")))

    lat = _build(OscillinkLattice, case, device="cpu")
    path = str(tmp_path / "lattice.pt")
    lat.save_checkpoint(path)
    back = OscillinkLattice.from_checkpoint(path, device="cpu")
    if "env" in case:
        assert back._auto_col_chunks() == int(case["env"]["OSCILLINK_COL_CHUNKS"])
    assert (back.N, back.D, back.lamQ, back.lamP) == (lat.N, lat.D, lat.lamQ, lat.lamP)
    assert back._signature() == lat._signature()
    _same(_flow(back), jax_ref)
    _same(_flow(lat), jax_ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_restore_is_bit_equal_and_builds_no_graph(name, tmp_path, monkeypatch):
    case = CASES[name]
    lat = _build(OscillinkLattice, case, device="cpu")
    path = str(tmp_path / "lattice.pt")
    lat.save_checkpoint(path)

    def no_build(*a, **k):
        raise AssertionError("a graph was built on restore")

    monkeypatch.setattr(tlattice, "build_graph", no_build)
    monkeypatch.setattr(tivf, "build_graph_ivf", no_build)
    monkeypatch.setattr(OscillinkLattice, "_build_graph_seeded_host", no_build)
    back = OscillinkLattice.from_checkpoint(path, device="cpu")
    for attr in ("Y", "psi", "B_diag"):
        assert getattr(back, attr).tobytes() == getattr(lat, attr).tobytes(), attr
    for a, b in zip(back.graph, lat.graph):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back._graph_token == lat._graph_token and back._n_edges == lat._n_edges
    assert back._chain_nodes == lat._chain_nodes
    assert back.adjacency_fingerprint() == lat.adjacency_fingerprint()


def test_fast_similarity_lattice_keeps_its_mode_and_token(tmp_path):
    """A "fast" build's token folds in the mode; the restored lattice keeps
    it (the JAX ``from_orbax`` re-runs an exact build instead)."""
    Y, psi, _ = _inputs(dict(n=300, d=16, seed=3))
    lat = OscillinkLattice(Y, kneighbors=6, similarity="fast", device="cpu")
    lat.set_query(psi)
    lat.save_checkpoint(str(tmp_path / "fast.pt"))
    back = OscillinkLattice.from_checkpoint(str(tmp_path / "fast.pt"), device="cpu")
    assert back._similarity == "fast" and back._signature() == lat._signature()
    assert _flow(back) == _flow(lat)


def test_checkpoint_holds_tensors_and_json_only(tmp_path):
    lat = _build(OscillinkLattice, CASES["chain"], device="cpu")
    lat.save_checkpoint(str(tmp_path / "c.pt"))
    ckpt = torch.load(str(tmp_path / "c.pt"), weights_only=True)
    assert set(ckpt) == {"Y", "psi", "B_diag", "idx", "w", "wn", "sqrt_deg", "meta"}
    assert all(isinstance(ckpt[k], torch.Tensor) for k in ckpt if k != "meta")
    assert isinstance(ckpt["meta"], str)
    torch.save({"meta": "{}"}, str(tmp_path / "other.pt"))
    with pytest.raises(ValueError, match="not an oscillink_tpu_torch checkpoint"):
        OscillinkLattice.from_checkpoint(str(tmp_path / "other.pt"), device="cpu")
