"""The port's `parallel.reorder` (PCA bisection, `apply_order`,
`halo_stats`) against the JAX package's on the JAX tests' corpora
(``tests/test_reorder_halo.py``, ``tests/test_halo_cg.py``).

The permutations are identical on every corpus but three, where torch's
and XLA's roundings of the power iteration swap adjacent rows of a leaf
segment (`SWAPS`: ``_clustered(8192, 24)`` with seeds 1 and 3 twice each,
the offset clusters once).  There each swapped pair's projections
(recomputed in float64 on the leaf) must lie within 32 float32 ulps of the
leaf's largest projection, the near-tie rule of ROADMAP queue C.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu.parallel import reorder as jreorder  # noqa: E402
from oscillink_tpu_torch.ops.graph import build_graph  # noqa: E402
from oscillink_tpu_torch.parallel.reorder import (  # noqa: E402
    apply_order,
    halo_stats,
    pca_bisection_order,
)

NEAR_TIE_ULPS = 32
# adjacent-row swaps between the two packages' orders, by corpus
SWAPS = {"clustered_8192x24_s1": 2, "clustered_8192x24_s3": 2, "offset_clusters_2048x32": 1}


def _clustered(n, d, seed=0):
    """tests/test_halo_cg.py's generator."""
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((16, d)).astype(np.float32)
    assign = rng.integers(0, 16, size=n)
    return centers[assign] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)


def _shard_clusters(n, d, seed, offset=0.0, spread=4.0):
    """tests/test_reorder_halo.py's clustered corpora (16 centres)."""
    rng = np.random.default_rng(seed)
    centers = spread * rng.standard_normal((16, d)).astype(np.float32)
    assign = rng.integers(0, len(centers), size=n)
    return (offset + centers[assign] + 0.3 * rng.standard_normal((n, d)).astype(np.float32))


def _random(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


CORPORA = {
    "random_257x16": (lambda: _random(257, 16, 0), 3),
    "random_64x8": (lambda: _random(64, 8, 1), 3),
    "clusters_2048x32": (lambda: _shard_clusters(2048, 32, 2), 4),
    "random_1024x64": (lambda: _random(1024, 64, 3), 4),
    "offset_clusters_2048x32": (lambda: _shard_clusters(2048, 32, 7, 20.0, 3.0), 4),
    "clustered_256x16": (lambda: _clustered(256, 16), 3),
    "clustered_512x24_s1": (lambda: _clustered(512, 24, 1), 3),
    "clustered_512x24_s5": (lambda: _clustered(512, 24, 5), 4),
    "clustered_8192x24_s3": (lambda: _clustered(8192, 24, 3), 4),
    "clustered_8192x24_s1": (lambda: _clustered(8192, 24, 1), 4),
}


def _leaves(n, levels):
    segs = [(0, n)]
    for _ in range(levels - 1):
        segs = [s for a, b in segs for s in ((a, a + (b - a) // 2), (a + (b - a) // 2, b))]
    return segs


def _proj64(Y):
    """The segment projection in float64 (the same 8 power iterations)."""
    Yc = Y.astype(np.float64)
    Yc = Yc - Yc.mean(0)
    v = np.ones(Y.shape[1]) / np.sqrt(Y.shape[1])
    for _ in range(8):
        w = Yc.T @ (Yc @ v)
        v = w / (np.linalg.norm(w) + 1e-12)
    return Yc @ v


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_pca_bisection_order_matches_jax(name):
    make, levels = CORPORA[name]
    Y = make()
    ours = pca_bisection_order(Y, levels=levels, device="cpu")
    ref = jreorder.pca_bisection_order(Y, levels=levels)
    assert sorted(ours.tolist()) == list(range(len(Y)))
    diff = np.flatnonzero(ours != ref)
    assert len(diff) == 2 * SWAPS.get(name, 0), diff
    for a, b in _leaves(len(Y), levels):
        hit = diff[(diff >= a) & (diff < b)]
        if not len(hit):
            continue
        assert set(ours[a:b]) == set(ref[a:b])  # the swaps never cross a split
        p = _proj64(Y[ours[a:b]])
        pos = {int(r): i for i, r in enumerate(ours[a:b])}
        ulp = np.spacing(np.float32(np.abs(p).max()))
        for i in hit:
            assert ours[i] in (ref[i - 1], ref[(i + 1) % len(Y)])  # adjacent swaps
            gap = abs(p[pos[int(ours[i])]] - p[pos[int(ref[i])]])
            assert gap <= NEAR_TIE_ULPS * ulp, (i, gap / ulp)


def test_apply_order_and_halo_stats_match_jax():
    Y = _shard_clusters(2048, 32, 2)
    order = jreorder.pca_bisection_order(Y, levels=4)
    B = np.linspace(0, 1, len(Y)).astype(np.float32)
    for a, b in zip(apply_order(order, Y, B), jreorder.apply_order(order, Y, B)):
        np.testing.assert_array_equal(a, b)
    Y2, inv = apply_order(order, Y)
    np.testing.assert_array_equal(Y2[inv], Y)
    g = build_graph(torch.from_numpy(Y2), 6)
    idx, w = g.idx.numpy(), g.w.numpy()
    for shards in (1, 2, 8):
        assert halo_stats(idx, w, shards) == jreorder.halo_stats(idx, w, shards)
    with pytest.raises(ValueError):
        halo_stats(idx[:2047], w[:2047], 8)


def _halo(Y, k, shards=8, levels=4, reorder=True):
    if reorder:
        (Y,) = apply_order(pca_bisection_order(Y, levels=levels, device="cpu"), Y)[:1]
    g = build_graph(torch.from_numpy(np.ascontiguousarray(Y)), k)
    return halo_stats(g.idx.numpy(), g.w.numpy(), shards)


@pytest.mark.parametrize("offset,spread,seed", [(0.0, 4.0, 2), (20.0, 3.0, 7)])
def test_halo_shrinks_on_clustered_data(offset, spread, seed):
    """The JAX tests' bars on the port's own order and graph."""
    Y = _shard_clusters(2048, 32, seed, offset, spread)
    before, after = _halo(Y, 6, reorder=False), _halo(Y, 6)
    assert after["halo_mean"] < 0.5 * before["halo_mean"]
    if offset == 0.0:
        assert after["halo_fraction_mean"] < 0.6


def test_halo_random_data_stays_global():
    Y = _random(1024, 64, 3)
    stats, stats_s = _halo(Y, 6, reorder=False), _halo(Y, 6)
    assert stats["halo_mean"] > 0.3 * stats["allgather_rows"] * 0.1
    assert stats_s["halo_mean"] > 0.5 * stats["halo_mean"]


def test_projection_runs_on_the_callers_device_in_f32(monkeypatch):
    """The power iteration takes float32 tensors on the given device."""
    from oscillink_tpu_torch.parallel import reorder

    seen = []
    real = reorder._segment_projection

    def spy(Ys):
        seen.append((Ys.dtype, Ys.device.type))
        return real(Ys)

    monkeypatch.setattr(reorder, "_segment_projection", spy)
    pca_bisection_order(_random(64, 8, 1), levels=2, device="cpu")
    assert seen and set(seen) == {(torch.float32, "cpu")}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pca_bisection_order(_random(8, 4, 0))
