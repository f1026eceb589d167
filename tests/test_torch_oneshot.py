"""The port's one-shot settle + light receipt (``models/oneshot.py``)
against the JAX package's: ΔH within 1e-5 relative, identical iterations
and edge count, residuals close; and against the port's own lattice."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.models.oneshot import settle_receipt_light as jlight  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jbuild_graph  # noqa: E402
from oscillink_tpu_torch.models.oneshot import settle_receipt_light as tlight  # noqa: E402
from oscillink_tpu_torch.ops.graph import build_graph as tbuild_graph  # noqa: E402


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    return Y, Y[:16].mean(0).astype(np.float32), rng.random(n).astype(np.float32)


@pytest.mark.parametrize("n,d,kw", [
    (300, 32, {}),
    (200, 64, dict(kneighbors=4, lamC=0.8, dt=0.5, row_cap=0.7)),
    (150, 16, dict(gates=True, settle_tol=1e-5, settle_max_iters=40, ustar_tol=1e-6)),
    (5, 8, dict(kneighbors=10)),  # k clamps to N - 1
])
def test_settle_receipt_light_matches_jax(n, d, kw):
    Y, psi, gates = _data(n, d, n)
    kw = dict(kw)
    if kw.pop("gates", False):
        kw["gates"] = 1.5 * gates - 0.2  # clipped to [0, 1] by both
    k = min(kw.get("kneighbors", 6), n - 1)
    np.testing.assert_array_equal(tbuild_graph(torch.from_numpy(Y), k).idx.numpy(),
                                  np.asarray(jbuild_graph(jnp.asarray(Y), k).idx))
    rj, rt = jlight(Y, psi, **kw), tlight(Y, psi, device="cpu", **kw)
    assert set(rt) == set(rj)
    assert rt["deltaH_total"] == pytest.approx(rj["deltaH_total"], rel=1e-5)
    for key in ("settle_iters", "ustar_iters", "edge_count"):
        assert rt[key] == rj[key], key
    for key in ("settle_res", "ustar_res"):
        assert rt[key] == pytest.approx(rj[key], rel=1e-3, abs=1e-7), key


def test_settle_receipt_light_matches_the_ports_lattice():
    Y, psi, _ = _data(250, 32, 9)
    rt = tlight(Y, psi, device="cpu")
    lat = pt.Oscillink(Y, kneighbors=6, device="cpu")
    lat.set_query(psi)
    lat.set_receipt_detail("light")
    st = lat.settle()
    rec = lat.receipt()
    assert rt["deltaH_total"] == pytest.approx(rec["deltaH_total"], rel=1e-6)
    assert (rt["settle_iters"], rt["ustar_iters"]) == (st["iters"], rec["meta"]["ustar_iters"])
    assert rt["edge_count"] == lat._n_edges // 2
