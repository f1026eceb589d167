"""The fast and fastest similarity scans: oscillink_tpu_torch against oscillink_tpu.

Both packages get the same numpy inputs (made from a seed) on the CPU.  The
port's two-pass scan (bf16 scan with f32 sums, 4k candidates, exact f32
rescore) must select the same neighbours in the same slots as the JAX
package's ``_topk_blocked_fast`` (whose ``approx_max_k`` is an exact top-k
off the TPU) and give the weights to 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.ops import graph as jgraph  # noqa: E402
from oscillink_tpu_torch.ops import graph as tgraph  # noqa: E402

BLOCKED = dict(dense_limit=64, block_rows=128)  # the blocked path at test size


def _Y(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("mode", ["fast", "fastest"])
@pytest.mark.parametrize("n,d,k,seed", [(1000, 32, 8, 0), (1037, 48, 6, 1), (513, 16, 8, 2)])
def test_build_graph_fast_matches_jax(mode, n, d, k, seed):
    Y = _Y(n, d, seed)
    gj = jax.jit(lambda Y: jgraph.build_graph(Y, k, similarity=mode, **BLOCKED))(jnp.asarray(Y))
    gt = tgraph.build_graph(torch.from_numpy(Y), k, similarity=mode, **BLOCKED)
    np.testing.assert_array_equal(gt.idx.numpy(), np.asarray(gj.idx))  # identical idx
    for name in ("w", "wn", "sqrt_deg"):  # 1e-6
        np.testing.assert_allclose(
            getattr(gt, name).numpy(), np.asarray(getattr(gj, name)), rtol=0, atol=1e-6,
            err_msg=name,
        )


@pytest.mark.parametrize("recall", [0.99, 0.95])
def test_topk_blocked_fast_matches_jax(recall):
    # the candidate stage and the rescore on their own: identical ids, vals
    # within 1e-6 (exact f32 similarities in both)
    Y = _Y(700, 24, 3)
    Yn = np.array(jgraph.normalize_rows(jnp.asarray(Y)))
    vj, ij = jgraph._topk_blocked_fast(
        jnp.asarray(Yn), jnp.asarray(Yn), 8, 128, recall_target=recall)
    vt, it = tgraph._topk_blocked_fast(torch.from_numpy(Yn), 8, 128)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-6)


def test_fast_agrees_with_exact_on_most_rows():
    # the recall contract: at least 0.99 of rows keep every exact neighbour
    Y = _Y(1500, 32, 4)
    ge = tgraph.build_graph(torch.from_numpy(Y), 8, **BLOCKED)
    gf = tgraph.build_graph(torch.from_numpy(Y), 8, similarity="fast", **BLOCKED)
    rows_equal = (ge.idx == gf.idx).all(dim=1).double().mean().item()
    assert rows_equal >= 0.99
    both = (ge.w > 0) & (gf.w > 0) & (ge.idx == gf.idx)
    torch.testing.assert_close(gf.w[both], ge.w[both], rtol=1e-5, atol=1e-6)


def test_scan_bf16_on_cpu_is_the_jax_bf16_dot():
    # exact products of bf16 values summed in f32; a bf16 output would not do
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((64, 96)).astype(np.float32), rng.standard_normal((80, 96)).astype(np.float32)
    ab = torch.from_numpy(a).to(torch.bfloat16)
    bb = torch.from_numpy(b).to(torch.bfloat16)
    out = tgraph.scan_bf16(ab, bb)
    assert out.dtype == torch.float32
    ref = jnp.dot(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16).T,
                  preferred_element_type=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "n,env",
    [
        (65536, {}), (65537, {}), (499_999, {}), (500_000, {}),
        (300, {"OSCILLINK_FAST_SIM_N": "100"}),
        (300, {"OSCILLINK_FAST_SIM_N": "bad"}),
        (600_000, {"OSCILLINK_CLUSTER_SIM_N": "0"}),
        (2000, {"OSCILLINK_CLUSTER_SIM_N": "1000", "OSCILLINK_FAST_SIM_N": "5000"}),
        (2000, {"OSCILLINK_CLUSTER_SIM_N": "bad"}),
    ],
)
def test_resolve_similarity_thresholds(monkeypatch, n, env):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    for allow in (False, True):
        assert tgraph.resolve_similarity(n, "auto", allow_cluster=allow) == (
            jgraph.resolve_similarity(n, "auto", allow_cluster=allow)
        )
    for mode in ("exact", "fast", "fastest", "cluster"):
        assert tgraph.resolve_similarity(n, mode, allow_cluster=True) == mode


def test_exports_match_jax():
    assert {"FAST_SIMILARITY_N", "CLUSTER_SIMILARITY_N"} <= set(tgraph.__all__)
    assert set(tgraph.__all__) <= set(jgraph.__all__) | {"stable_topk"}
    assert tgraph.FAST_SIMILARITY_N == jgraph.FAST_SIMILARITY_N
    assert tgraph.CLUSTER_SIMILARITY_N == jgraph.CLUSTER_SIMILARITY_N
    assert tgraph.SIMILARITY_RECALL == jgraph.SIMILARITY_RECALL


@pytest.mark.parametrize("mode,target", [("auto", 0.99), ("fast", 0.99), ("fastest", 0.95)])
def test_lattice_fast_meta_and_signature_match_jax(monkeypatch, mode, target):
    # OSCILLINK_FAST_SIM_N=100 makes auto resolve to fast at N = 300; both
    # lattices then build on their dense path (N <= 4096), as the JAX one does
    monkeypatch.setenv("OSCILLINK_FAST_SIM_N", "100")
    Y = _Y(300, 32, 6)
    psi = Y[:16].mean(0) / np.linalg.norm(Y[:16].mean(0))
    lj = ot.Oscillink(Y, kneighbors=6, similarity=mode)
    lt = pt.Oscillink(Y, kneighbors=6, similarity=mode, device="cpu")
    le = pt.Oscillink(Y, kneighbors=6, device="cpu")
    for lat in (lj, lt, le):
        lat.set_query(psi.astype(np.float32))
        lat.settle(max_iters=12, tol=1e-3)
    rj, rt, re = lj.receipt(), lt.receipt(), le.receipt()
    resolved = "fast" if mode == "auto" else mode
    assert rt["meta"]["similarity"] == rj["meta"]["similarity"] == resolved
    assert rt["meta"]["similarity_recall_target"] == rj["meta"]["similarity_recall_target"] == target
    assert "similarity_info" not in rt["meta"]
    assert rt["meta"]["state_sig"] == rj["meta"]["state_sig"]
    assert rt["meta"]["state_sig"] != re["meta"]["state_sig"]  # the mode keys the graph token
    assert abs(rt["deltaH_total"] - rj["deltaH_total"]) <= 1e-5 * abs(rj["deltaH_total"])
    assert [b["id"] for b in lt.bundle(k=6)] == [b["id"] for b in lj.bundle(k=6)]


def test_lattice_blocked_fast_build_matches_jax():
    # N above the lattice's dense limit: the blocked fast scan, end to end
    Y = _Y(4200, 16, 7)
    psi = (Y[:32].mean(0) / np.linalg.norm(Y[:32].mean(0))).astype(np.float32)
    lj = ot.Oscillink(Y, kneighbors=6, similarity="fast")
    lt = pt.Oscillink(Y, kneighbors=6, similarity="fast", device="cpu")
    np.testing.assert_array_equal(lt.graph.idx.numpy(), np.asarray(lj._graph.idx))
    for lat in (lj, lt):
        lat.set_query(psi)
        lat.settle(max_iters=12, tol=1e-3)
    rj, rt = lj.receipt(), lt.receipt()
    assert rt["meta"]["state_sig"] == rj["meta"]["state_sig"]
    assert abs(rt["deltaH_total"] - rj["deltaH_total"]) <= 1e-5 * abs(rj["deltaH_total"])
    assert rt["meta"]["ustar_iters"] == rj["meta"]["ustar_iters"]
    assert len(rt["null_points"]) == len(rj["null_points"])
