"""Receipt diagnostics and signing of the PyTorch port against the JAX package.

Same graph (carried across with ``interop``), same numpy state.  Float32
reductions are compared at 1e-5 relative; the fixed-order f64 deltaH must be
bit-identical to the NumPy specification; HMAC blocks must verify across the
two packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscillink_tpu.core import receipts as jsign  # noqa: E402
from oscillink_tpu.models.coherence import EnergyParams as JEnergy  # noqa: E402
from oscillink_tpu.ops import receipts as jrec  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jbuild_graph  # noqa: E402
from oscillink_tpu.ops.path import build_path_graph as jbuild_path  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.core import receipts as tsign  # noqa: E402
from oscillink_tpu_torch.ops import receipts as trec  # noqa: E402

LAMS = (1.0, 0.5, 4.0, 0.3)


def _state(n=500, d=32, k=6, seed=0, chain=(4, 9, 1, 30)):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    U = (Y + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    Us = (Y + 0.05 * rng.standard_normal((n, d))).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    B = rng.random(n).astype(np.float32)
    gj = jax.jit(lambda Y: jbuild_graph(Y, k))(jnp.asarray(Y))
    gt = interop.graph_from_numpy(
        *(np.asarray(a) for a in (gj.idx, gj.w, gj.wn, gj.sqrt_deg)), device="cpu"
    )
    pj = jbuild_path(n, list(chain))
    pt = interop.path_from_numpy(
        *(np.asarray(a) for a in (pj.src, pj.dst, pj.w, pj.wn, pj.sqrt_deg)), device="cpu"
    )
    return dict(
        gj=gj, gt=gt, pj=pj, pt=pt, lam_j=JEnergy.make(*LAMS),
        lam_t=interop.energy_from_numpy(*LAMS, device="cpu"),
        Y=Y, U=U, Us=Us, psi=psi, B=B,
    )


@pytest.fixture(scope="module")
def st():
    return _state()


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(t, j, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("with_path", [False, True])
def test_deltaH_trace_matches_jax(st, with_path):
    pj, pt = (st["pj"], st["pt"]) if with_path else (None, None)
    dj = jrec.deltaH_trace(st["gj"], pj, _j(st["U"]), _j(st["Us"]), st["lam_j"], _j(st["B"]))
    dt = trec.deltaH_trace(st["gt"], pt, _t(st["U"]), _t(st["Us"]), st["lam_t"], _t(st["B"]))
    _close(float(dt), float(dj), rtol=1e-5, atol=0)


def test_per_node_components_match_jax(st):
    cj = jrec.per_node_components(
        st["gj"], _j(st["Y"]), _j(st["Us"]), st["lam_j"], _j(st["B"]), _j(st["psi"])
    )
    ct = trec.per_node_components(
        st["gt"], _t(st["Y"]), _t(st["Us"]), st["lam_t"], _t(st["B"]), _t(st["psi"])
    )
    for a, b in zip(ct, cj):
        _close(a.numpy(), b, rtol=1e-5, atol=1e-4)


def test_null_points_match_jax(st):
    fj, jj, zj, rj = jrec.null_points_sparse(st["gj"], _j(st["Us"]), st["lam_j"].lamC, z_th=3.0)
    ft, jt, zt, rt = trec.null_points_sparse(st["gt"], _t(st["Us"]), st["lam_t"].lamC, z_th=3.0)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(jt.numpy(), np.asarray(jj))
    _close(zt.numpy(), zj, rtol=1e-4, atol=1e-4)
    _close(rt.numpy(), rj)
    assert ft.any()  # the fixture must exercise flagged rows


def test_chain_edge_stats_match_jax(st):
    ci = np.array([4, 9, 1, 0], dtype=np.int32)
    cj = np.array([9, 1, 30, 3], dtype=np.int32)
    oj = jrec.chain_edge_stats(
        st["gj"], st["pj"], _j(st["Us"]), _j(st["Y"]), st["lam_j"].lamC, _j(ci), _j(cj)
    )
    ot = trec.chain_edge_stats(
        st["gt"], st["pt"], _t(st["Us"]), _t(st["Y"]), st["lam_t"].lamC,
        _t(ci.astype(np.int64)), _t(cj.astype(np.int64)),
    )
    for a, b in zip(ot, oj):
        _close(a.numpy(), b, rtol=1e-4, atol=1e-5)


def test_bundle_scores_match_jax(st):
    sj, aj = jrec.bundle_scores(
        st["gj"], _j(st["Y"]), _j(st["Us"]), _j(st["psi"]), st["lam_j"].lamC, jnp.float32(0.5)
    )
    s_t, a_t = trec.bundle_scores(
        st["gt"], _t(st["Y"]), _t(st["Us"]), _t(st["psi"]), st["lam_t"].lamC, 0.5
    )
    _close(s_t.numpy(), sj, rtol=1e-4, atol=1e-5)
    _close(a_t.numpy(), aj)


def test_dynamics_core_matches_jax(st):
    oj = jrec.dynamics_core(
        st["gj"], st["pj"], _j(st["U"]), _j(st["Us"]), st["lam_j"], _j(st["B"])
    )
    ot = trec.dynamics_core(
        st["gt"], st["pt"], _t(st["U"]), _t(st["Us"]), st["lam_t"], _t(st["B"])
    )
    move2, dH, ftot, vals, fi, fj = ot
    _close(move2.numpy(), oj[0])
    _close(float(dH), float(oj[1]))
    _close(float(ftot), float(oj[2]), rtol=1e-4)
    _close(vals.numpy(), oj[3], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(fi.numpy(), np.asarray(oj[4]))
    np.testing.assert_array_equal(fj.numpy(), np.asarray(oj[5]))


@pytest.mark.parametrize("scaled", [False, True])
def test_edge_sq_dists_blocked_equals_direct(st, monkeypatch, scaled):
    X = _t(st["Us"])
    inv = trec._inv_sqrt_deg(st["gt"]) if scaled else None
    direct = trec._edge_sq_dists(st["gt"], X, inv)
    monkeypatch.setattr(trec, "_EDGE_TEMP_BUDGET_BYTES", 1024)
    monkeypatch.setattr(trec, "_EDGE_BLOCK_ROWS", 64)  # 500 rows: 8 blocks, ragged tail
    blocked = trec._edge_sq_dists(st["gt"], X, inv)
    np.testing.assert_array_equal(blocked.numpy(), direct.numpy())
    dj = jrec._edge_sq_dists(st["gj"], _j(st["Us"]), None if inv is None else _j(inv.numpy()))
    _close(direct.numpy(), dj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_path", [False, True])
def test_deterministic_deltaH_bit_identical_to_numpy_spec(st, with_path):
    pt = st["pt"] if with_path else None
    dev = float(
        trec.deltaH_trace_deterministic(
            st["gt"], pt, _t(st["U"]), _t(st["Us"]), st["lam_t"], _t(st["B"])
        )
    )
    path = {}
    if with_path:
        path = dict(
            path_src=np.asarray(st["pj"].src), path_dst=np.asarray(st["pj"].dst),
            path_wn=np.asarray(st["pj"].wn), lamP=LAMS[3],
        )
    args = (np.asarray(st["gj"].idx), np.asarray(st["gj"].wn), st["U"], st["Us"], *LAMS[:3], st["B"])
    spec_j = float(jrec.deltaH_tree_np(*args, **path))
    spec_t = float(trec.deltaH_tree_np(*args, **path))
    assert dev.hex() == spec_j.hex() == spec_t.hex()


@pytest.mark.parametrize("mode", ["minimal", "extended"])
def test_signatures_cross_verify(mode):
    payload = {"sig_v": 1, "mode": mode, "state_sig": "ab" * 32, "deltaH_total": 12.5}
    if mode == "extended":
        payload.update(ustar_iters=7, ustar_res=1e-5, ustar_converged=True,
                       params={"lamG": 1.0, "lamC": 0.5, "lamQ": 4.0, "lamP": 0.0})
    assert tsign.canonical_json(payload) == jsign.canonical_json(payload)
    assert tsign.sign_payload(payload, "k") == jsign.sign_payload(payload, b"k")
    rec = {"meta": {"signature": {"algorithm": "HMAC-SHA256", "payload": payload,
                                  "signature": tsign.sign_payload(payload, "k"), "kid": "a"}}}
    for verify in (jsign.verify_receipt, tsign.verify_receipt):
        assert verify(rec, "k") and verify(rec, {"a": "k", "b": "x"})
        assert not verify(rec, "wrong") and not verify(rec, {"b": "k"})
    ok_j, pay_j = jsign.verify_receipt_mode(rec, "k", minimal_subset=True)
    ok_t, pay_t = tsign.verify_receipt_mode(rec, "k", minimal_subset=True)
    assert ok_j and ok_t and pay_j == pay_t == payload


def test_minimal_subset_and_component_signatures_match():
    ext = {"sig_v": 1, "mode": "extended", "state_sig": "cd" * 32, "deltaH_total": 3.0,
           "ustar_iters": 4}
    minimal = {"sig_v": 1, "mode": "minimal", "state_sig": ext["state_sig"], "deltaH_total": 3.0}
    rec = {"meta": {"signature": {"algorithm": "HMAC-SHA256", "payload": ext,
                                  "signature": jsign.sign_payload(minimal, "s")}}}
    for mod in (jsign, tsign):
        assert mod.verify_receipt_mode(rec, "s", minimal_subset=True) == (True, minimal)
        assert mod.verify_receipt_mode(rec, "s", require_mode="extended", minimal_subset=True) == (
            False, None
        )
        assert mod.verify_receipt_mode(rec, "s", required_sig_v=2) == (False, None)
    comp = {"shard": 3, "deltaH": 1.5}
    signed_t = dict(comp, signature=tsign.sign_component(comp, "z"))
    signed_j = dict(comp, signature=jsign.sign_component(comp, "z"))
    assert signed_t == signed_j
    assert jsign.verify_component(signed_t, "z") and tsign.verify_component(signed_j, "z")
    assert not tsign.verify_component(dict(signed_j, deltaH=2.0), "z")
