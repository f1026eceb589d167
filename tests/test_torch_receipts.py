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
from oscillink_tpu_torch.ops.kernels import edge_dists  # noqa: E402

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


@pytest.fixture(scope="module")
def st_ragged():
    # D not a multiple of 4, N not a multiple of the block, padded slots
    return _state(n=333, d=37, k=5, seed=1, chain=(3, 8, 2))


@pytest.mark.parametrize("state", ["st", "st_ragged"])
@pytest.mark.parametrize("scaled", [False, True])
def test_edge_sq_dists_blocked_equals_direct(request, monkeypatch, scaled, state):
    st = request.getfixturevalue(state)
    X = _t(st["Us"])
    inv = trec._inv_sqrt_deg(st["gt"]) if scaled else None
    direct = trec._edge_sq_dists(st["gt"], X, inv)
    monkeypatch.setattr(edge_dists, "TEMP_BUDGET_BYTES", 1024)
    monkeypatch.setattr(edge_dists, "BLOCK_ROWS", 64)  # 500 / 333 rows: ragged tail
    blocked = trec._edge_sq_dists(st["gt"], X, inv)
    np.testing.assert_array_equal(blocked.numpy(), direct.numpy())
    assert bool((st["gt"].w == 0).any())  # zero-weight padded slots are measured too
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


# -- the receipt's key order, route by route ---------------------------------

_ORDER_ENV = ("OSCILLINK_API_KEYS", "OSCILLINK_NATIVE_SMALL_N", "OSCILLINK_SHARDED_MIN_N",
              "OSCILLINK_RECEIPT_NULL_CAP", "OSCILLINK_ADAPTIVE_PROFILES",
              "OSCILLINK_RECEIPT_DYNAMICS")
_ROUTE_ENV = {"device": {}, "native": {"OSCILLINK_NATIVE_SMALL_N": "2048"},
              "mesh": {"OSCILLINK_SHARDED_MIN_N": "64"}}


def _key_orders(x, path="", out=None):
    """The key order of every dict in ``x`` by its path, list positions
    merged (``[]``), so two bodies whose lists differ in length compare."""
    out = {} if out is None else out
    if isinstance(x, dict):
        out.setdefault(path, set()).add(tuple(x))
        for k, v in x.items():
            _key_orders(v, f"{path}.{k}", out)
    elif isinstance(x, list):
        for v in x:
            _key_orders(v, f"{path}[]", out)
    return out


def _served(route, endpoint, monkeypatch):
    """The same seeded request through the JAX service and the port's, on
    ``route``, with a receipt secret; returns (port body, JAX body)."""
    import random

    from oscillink_tpu.service import LocalClient as JaxClient
    from oscillink_tpu.service import config as jax_config
    from oscillink_tpu.service.api import create_state as jax_create_state
    from oscillink_tpu_torch.native import native_available
    from oscillink_tpu_torch.service import LocalClient
    from oscillink_tpu_torch.service import config as port_config
    from oscillink_tpu_torch.service.api import create_state

    if route == "native" and not native_available():
        pytest.skip("native build unavailable")
    for var in _ORDER_ENV:
        monkeypatch.delenv(var, raising=False)
    for var, val in {**_ROUTE_ENV[route], "OSCILLINK_RECEIPT_SECRET": "order",
                     "OSCILLINK_DISABLE_ST": "1"}.items():
        monkeypatch.setenv(var, val)
    port_config.get_settings.cache_clear()
    jax_config.get_settings.cache_clear()
    mesh = [torch.device("cpu")] * 8 if route == "mesh" else None
    rng = np.random.default_rng(21)
    body = {"Y": rng.standard_normal((64, 8)).astype(np.float32).tolist(),
            "psi": rng.standard_normal(8).astype(np.float32).tolist(),
            "options": {"max_iters": 8, "tol": 1e-3, "include_receipt": True}}
    if endpoint == "/v1/chain/receipt":
        body.update(chain=[0, 3, 5, 9], z_th=1.5)
    out = []
    for client in (LocalClient(create_state(device="cpu", mesh=mesh)),
                   JaxClient(jax_create_state())):
        random.seed(0)
        r = client.post(endpoint, json_body=body)
        assert r.status_code == 200, r.json()
        out.append(r.json())
    port_config.get_settings.cache_clear()
    jax_config.get_settings.cache_clear()
    want = {"device": (None, "device"), "native": ("native",), "mesh": ("sharded",)}[route]
    assert out[0]["meta"].get("backend") in want and out[1]["meta"].get("backend") in want
    return out


@pytest.mark.parametrize(
    "route,endpoint",
    [("device", "/v1/receipt"), ("device", "/v1/settle"), ("device", "extended"),
     ("native", "/v1/settle"), ("mesh", "/v1/settle"),
     ("device", "/v1/chain/receipt"), ("native", "/v1/chain/receipt"),
     ("mesh", "/v1/chain/receipt")],
)
def test_receipt_key_order_matches_jax(route, endpoint, monkeypatch):
    """Every dict of the receipt (its ``meta``, signature block and signed
    payload, null points and summary) and of the chain receipt (its edges
    and weakest link) keeps the JAX package's key order, on each route."""
    if endpoint == "extended":
        # the lattice's extended payload, stamped with a key id, and its
        # dynamics block: the service signs the minimal payload only
        import oscillink_tpu as ot

        import oscillink_tpu_torch as pt

        monkeypatch.setenv("OSCILLINK_RECEIPT_DYNAMICS", "1")
        rng = np.random.default_rng(22)
        Y = rng.standard_normal((60, 8)).astype(np.float32)
        psi = rng.standard_normal(8).astype(np.float32)
        got = []
        for lat in (pt.Oscillink(Y, kneighbors=5, device="cpu"), ot.Oscillink(Y, kneighbors=5)):
            lat.set_query(psi)
            lat.set_receipt_secret("order", kid="k1")
            lat.set_signature_mode("extended")
            lat.settle(max_iters=8, tol=1e-3)
            got.append(lat.receipt())
        port, jax_ = got
        assert port["meta"]["signature"]["payload"]["mode"] == "extended"
        assert list(port["meta"]["signature"]) == ["algorithm", "payload", "signature", "kid"]
        assert list(port["meta"])[-2:] == ["signature", "dynamics"]
    else:
        port_body, jax_body = _served(route, endpoint, monkeypatch)
        key = "chain_receipt" if endpoint == "/v1/chain/receipt" else "receipt"
        port, jax_ = port_body[key], jax_body[key]
    if "edges" in port:
        assert list(port["edges"][0]) == ["k", "edge", "z_struct", "z_path", "r_struct", "r_path"]
    else:
        assert "signature" in port["meta"] and port["null_points"]
    assert _key_orders(port) == _key_orders(jax_)
