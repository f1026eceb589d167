"""Graph build parity: oscillink_tpu_torch.ops.graph against oscillink_tpu.ops.graph.

Both packages get the same numpy inputs (made from a seed) on the CPU.  The
port must select the same neighbours in the same slots (ties broken by the
lowest index, as ``lax.top_k`` does) and reproduce the weights to 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscillink_tpu.ops import graph as jgraph  # noqa: E402
from oscillink_tpu_torch.ops import graph as tgraph  # noqa: E402

CPU = torch.device("cpu")


def _jax_graph(Y, k):
    return jax.jit(lambda Y: jgraph.build_graph(Y, k))(jnp.asarray(Y))


def _assert_same_graph(gj, gt, atol=1e-6):
    np.testing.assert_array_equal(gt.idx.numpy(), np.asarray(gj.idx))
    for name in ("w", "wn", "sqrt_deg"):
        np.testing.assert_allclose(
            getattr(gt, name).numpy(), np.asarray(getattr(gj, name)), rtol=0, atol=atol,
            err_msg=name,
        )


@pytest.mark.parametrize(
    "n,d,k,seed",
    [
        (300, 32, 6, 0),  # dense path (N <= 4096)
        (57, 20, 5, 1),
        (5000, 16, 6, 2),  # blocked path, ragged last block
    ],
)
def test_build_graph_matches_jax(n, d, k, seed):
    Y = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    gj = _jax_graph(Y, k)
    gt = tgraph.build_graph(torch.from_numpy(Y), k)
    assert gt.idx.dtype == torch.int32
    _assert_same_graph(gj, gt)


def test_build_graph_duplicate_rows_tie_order():
    # exact duplicates give exactly tied similarities: the lowest index wins
    rng = np.random.default_rng(3)
    base = rng.standard_normal((25, 12)).astype(np.float32)
    Y = base[rng.integers(0, 25, size=160)]
    gj = _jax_graph(Y, 7)
    gt = tgraph.build_graph(torch.from_numpy(Y), 7)
    _assert_same_graph(gj, gt)


def test_blocked_and_dense_paths_agree():
    Y = np.random.default_rng(4).standard_normal((700, 24)).astype(np.float32)
    Yt = torch.from_numpy(Y)
    dense = tgraph.build_graph(Yt, 5)
    blocked = tgraph.build_graph(Yt, 5, dense_limit=100, block_rows=128)
    np.testing.assert_array_equal(dense.idx.numpy(), blocked.idx.numpy())
    np.testing.assert_allclose(dense.w.numpy(), blocked.w.numpy(), atol=1e-6)


@pytest.mark.parametrize("levels,k", [(3, 5), (2, 9), (50, 4)])
def test_stable_topk_matches_lax_top_k(levels, k):
    # small integer ranges force long runs of ties, including rows whose
    # ties reach past the candidate slack (the full stable-sort fallback)
    S = np.random.default_rng(levels).integers(0, levels, size=(40, 300)).astype(np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(S), k)
    vt, it = tgraph.stable_topk(torch.from_numpy(S), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_graph_from_topk_matches_jax_on_shared_topk():
    rng = np.random.default_rng(5)
    Y = rng.standard_normal((200, 16)).astype(np.float32)
    Yn = Y / (np.linalg.norm(Y, axis=1, keepdims=True) + 1e-12)
    S = Yn @ Yn.T
    np.fill_diagonal(S, -np.inf)
    idx = np.argsort(-S, axis=1, kind="stable")[:, :6].astype(np.int32)
    vals = np.take_along_axis(S, idx, axis=1).astype(np.float32)
    gj = jgraph.graph_from_topk(jnp.asarray(vals), jnp.asarray(idx), row_cap=0.7)
    gt = tgraph.graph_from_topk(torch.from_numpy(vals), torch.from_numpy(idx), row_cap=0.7)
    _assert_same_graph(gj, gt)


def test_normalize_rows_matches_jax():
    Y = np.random.default_rng(6).standard_normal((64, 33)).astype(np.float32)
    Y[3] = 0.0  # the epsilon guard keeps a zero row finite
    np.testing.assert_allclose(
        tgraph.normalize_rows(torch.from_numpy(Y)).numpy(),
        np.asarray(jgraph.normalize_rows(jnp.asarray(Y))),
        rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("lam", [0.5, 0.0, 0.9])
def test_mmr_select_matches_jax_and_numpy(lam):
    rng = np.random.default_rng(7)
    Y = rng.standard_normal((90, 20)).astype(np.float32)
    Yn = Y / (np.linalg.norm(Y, axis=1, keepdims=True) + 1e-12)
    scores = rng.standard_normal(90).astype(np.float32)
    pj = np.asarray(jgraph.mmr_select(jnp.asarray(Yn), jnp.asarray(scores), 8, lambda_div=lam))
    pt = tgraph.mmr_select(torch.from_numpy(Yn), torch.from_numpy(scores), 8, lambda_div=lam)
    assert pt.tolist() == pj.tolist()
    assert tgraph.mmr_select_np(Yn, scores, 8, lam) == pj.tolist()


@pytest.mark.parametrize("n", [100, 65536, 65537, 600_000])
def test_resolve_similarity_matches_jax(n):
    for allow in (False, True):
        assert tgraph.resolve_similarity(n, "auto", allow_cluster=allow) == (
            jgraph.resolve_similarity(n, "auto", allow_cluster=allow)
        )


def _jax_graph_mode(Y, k, mode, **kw):
    return jax.jit(lambda Y: jgraph.build_graph(Y, k, similarity=mode, **kw))(jnp.asarray(Y))


@pytest.mark.parametrize("mode", ["fast", "fastest", "cluster"])
def test_approximate_modes_build_as_jax(mode):
    # fast and fastest take the two-pass scan on the blocked path; cluster is
    # the lattice's IVF route, which build_graph refuses in both packages
    Y = np.random.default_rng(11).standard_normal((300, 16)).astype(np.float32)
    kw = dict(dense_limit=64, block_rows=128)
    if mode == "cluster":
        with pytest.raises(ValueError, match="build_graph_ivf"):
            tgraph.build_graph(torch.from_numpy(Y), 6, similarity=mode, **kw)
        with pytest.raises(ValueError, match="build_graph_ivf"):
            jgraph.build_graph(jnp.asarray(Y), 6, similarity=mode, **kw)
        return
    gt = tgraph.build_graph(torch.from_numpy(Y), 6, similarity=mode, **kw)
    _assert_same_graph(_jax_graph_mode(Y, 6, mode, **kw), gt)  # idx identical, w 1e-6


def test_auto_above_fast_threshold_builds_fast(monkeypatch):
    monkeypatch.setenv("OSCILLINK_FAST_SIM_N", "10")
    Y = np.random.default_rng(12).standard_normal((300, 16)).astype(np.float32)
    kw = dict(dense_limit=64, block_rows=128)
    assert tgraph.resolve_similarity(300, "auto") == "fast"
    ga = tgraph.build_graph(torch.from_numpy(Y), 5, similarity="auto", **kw)
    gf = tgraph.build_graph(torch.from_numpy(Y), 5, similarity="fast", **kw)
    for name in ("idx", "w", "wn", "sqrt_deg"):
        assert torch.equal(getattr(ga, name), getattr(gf, name)), name
    _assert_same_graph(_jax_graph_mode(Y, 5, "auto", **kw), ga)
    with pytest.raises(ValueError, match="unknown similarity"):
        tgraph.build_graph(torch.randn(20, 8), 3, similarity="exactt")


def test_auto_below_threshold_runs_exact():
    Y = np.random.default_rng(8).standard_normal((50, 8)).astype(np.float32)
    ga = tgraph.build_graph(torch.from_numpy(Y), 4, similarity="auto")
    ge = tgraph.build_graph(torch.from_numpy(Y), 4)
    np.testing.assert_array_equal(ga.idx.numpy(), ge.idx.numpy())
