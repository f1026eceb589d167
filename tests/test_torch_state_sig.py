"""The state signature (`core/lattice.py`): `compute_state_sig`, hashed as a
gate prefix and a finish, against the JAX package's one-pass
`compute_state_sig` byte for byte; and the lattice's cached prefix, which
is rehashed only when the gates' bits change, through a run of state
changes beside the JAX lattice (the same signatures and U* counters)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.core.lattice import compute_state_sig as jax_state_sig  # noqa: E402
from oscillink_tpu_torch.core.lattice import (  # noqa: E402
    compute_state_sig,
    finish_state_sig,
    state_sig_prefix,
)

TOKEN = "3f" * 32
CHAIN = [2, 5, 7, 9]
# values whose rounding to 6 places is at an edge, or whose text differs
# from their float equality's: -0.0 == 0.0 and NaN != NaN
SPECIAL = [-0.0, 0.0, float("nan"), float("inf"), -float("inf"), 5e-7, -5e-7, 4.999999e-7,
           5.000001e-7, -4e-7, 1.5e-6, 2.5e-6, 0.9999995, 1e-45, 3.4e38]


def _gates(n: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "ones":
        return np.ones(n, dtype=np.float32)
    B = (rng.random(n) * rng.choice([1e-6, 1e-3, 1.0, 1e3], n)).astype(np.float32)
    if kind == "special":
        m = min(n, len(SPECIAL))
        B[:m] = np.asarray(SPECIAL[:m], dtype=np.float32)
        B[m::7] = np.asarray(SPECIAL, dtype=np.float32)[np.arange(len(B[m::7])) % len(SPECIAL)]
    return B


@pytest.mark.parametrize("chain_present,detk", [(False, False), (False, True), (True, False),
                                                (True, True)])
@pytest.mark.parametrize("kind", ["ones", "random", "special"])
@pytest.mark.parametrize("n", [1, 7, 200_003])
def test_state_sig_bit_identical_to_jax(n, kind, chain_present, detk):
    B = _gates(n, kind)
    psi = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    psi[:3] = [-0.0, 5e-7, float("nan")]
    args = ([1.25, 0.3, 4.0, 0.2 if chain_present else 0.0], chain_present,
            4 if chain_present else 0, 6, detk, TOKEN)
    with np.errstate(over="ignore"):  # 3.4e38 overflows as it rounds, in both
        want = jax_state_sig(psi, B, *args)
        _assert_split_matches(psi, B, args, want)


def _assert_split_matches(psi, B, args, want):
    assert compute_state_sig(psi, B, *args) == want
    # one prefix serves many finishes: each copies it
    prefix = state_sig_prefix(B)
    assert finish_state_sig(prefix, psi, *args) == want
    assert finish_state_sig(prefix, psi, *args) == want
    psi2 = psi + np.float32(0.5)
    assert finish_state_sig(prefix, psi2, *args) == jax_state_sig(psi2, B, *args)


def _fresh(lat) -> str:
    """The signature of the lattice's fields, computed whole."""
    fields = (lat.psi, lat.B_diag, [lat.lamG, lat.lamC, lat.lamQ, lat.lamP],
              lat._path is not None, len(lat._chain_nodes) if lat._chain_nodes else 0,
              lat._kneighbors, lat._deterministic_k, lat._graph_token)
    sig = compute_state_sig(*fields)
    assert sig == jax_state_sig(*fields)
    return sig


def test_lattice_prefix_cache_follows_the_gates_bits():
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((120, 32)).astype(np.float32)
    psis = [rng.standard_normal(32).astype(np.float32) for _ in range(4)]
    g_a = rng.random(120).astype(np.float32)
    g_zero = g_a.copy()
    g_zero[3] = 0.0
    g_negzero = g_zero.copy()
    g_negzero[3] = -0.0
    assert np.array_equal(g_zero, g_negzero)  # equal as floats, not as bits
    g_b = rng.random(120).astype(np.float32)

    def assign(lat):
        lat.B_diag = g_b.copy()
        lat.set_query(psis[3])

    def edit_in_place(lat):
        lat.B_diag[5] = 0.25
        lat.set_query(psis[3])

    # (step, prefix hits, prefix builds) after the step and a bundle
    steps = [
        (lambda lat: lat.set_query(psis[0]), 0, 1),
        (lambda lat: lat.set_query(psis[1]), 1, 1),
        (lambda lat: None, 1, 1),  # memoized: neither counter moves
        (lambda lat: lat.set_gates(g_a), 1, 2),
        (lambda lat: lat.set_query(psis[2], gates=g_a.copy()), 2, 2),
        (lambda lat: lat.set_gates(g_zero), 2, 3),
        (lambda lat: lat.set_gates(g_negzero), 2, 4),
        (assign, 2, 5),
        (edit_in_place, 2, 6),
        (lambda lat: lat.add_chain(CHAIN, lamP=0.2), 3, 6),
        (lambda lat: lat.clear_chain(), 4, 6),
    ]
    lt = pt.Oscillink(Y, kneighbors=6, device="cpu")
    lj = ot.Oscillink(Y, kneighbors=6)
    sigs = []
    for step, hits, builds in steps:
        for lat in (lt, lj):
            step(lat)
            lat.bundle(k=3)
        sig = lt._signature()
        assert sig == _fresh(lt) == lj._signature()
        assert (lt.stats["sig_prefix_hits"], lt.stats["sig_prefix_builds"]) == (hits, builds)
        for key in ("ustar_solves", "ustar_cache_hits"):
            assert lt.stats[key] == lj.stats[key], key
        sigs.append(sig)
    assert lt.stats["ustar_solves"] == len(steps) - 1
    assert lt.stats["ustar_cache_hits"] == 1
    assert sigs[6] != sigs[5]  # -0.0 serialises apart from 0.0
    assert sigs[8] != sigs[7]  # the in-place edit reached the prefix
    assert sigs[10] == sigs[8] and sigs[9] != sigs[8]
    assert "sig_prefix_hits" not in lt.receipt()["meta"]


def test_lattice_prefix_cache_hits_on_equal_nan_bits():
    lat = pt.Oscillink(np.eye(16, 8, dtype=np.float32), kneighbors=3, device="cpu")
    g = np.full(16, np.nan, dtype=np.float32)
    lat.set_gates(g)
    first = lat._signature()
    lat.set_query(np.ones(8, dtype=np.float32), gates=g.copy())
    assert lat._signature() == _fresh(lat) != first
    assert (lat.stats["sig_prefix_hits"], lat.stats["sig_prefix_builds"]) == (1, 1)
    lat.B_diag = lat.B_diag.astype(np.float64)  # same values, other bits
    lat.set_query(np.ones(8, dtype=np.float32))
    assert lat._signature() == _fresh(lat)
    assert lat.stats["sig_prefix_builds"] == 2
