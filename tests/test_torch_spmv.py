"""Kernel K1 (gather-SpMV) of the PyTorch port.

On the CPU: the plain version `lap_matvec_ref` is held against the TPU
kernel itself, `lap_matvec_pallas` run in interpret mode as the JAX
package's own tests run it, at rtol/atol 1e-5 (the same K order; the gap is
rounding only), ragged N included.  The kernel's column-slab plan
(`slab_plan`) is pure Python and is checked here: its slabs cover the
columns once, and the plain version taken slab by slab equals the
whole-width call bit for bit.  The CUDA kernel itself has no CPU mode:
`chip_smoke.py` holds it against the plain version on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscillink_tpu.ops.graph import build_graph as jbuild_graph  # noqa: E402
from oscillink_tpu.ops.graph import lap_matvec as jlap_matvec  # noqa: E402
from oscillink_tpu.ops.pallas.spmv import lap_matvec_pallas  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.ops import graph as tgraph  # noqa: E402
from oscillink_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from oscillink_tpu_torch.ops.kernels import spmv  # noqa: E402


def _shared(n, d, k, seed):
    """A JAX-built graph carried into the port, plus one X block."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    gj = jax.jit(lambda Y: jbuild_graph(Y, k))(jnp.asarray(Y))
    gt = interop.graph_from_numpy(
        np.asarray(gj.idx), np.asarray(gj.w), np.asarray(gj.wn), np.asarray(gj.sqrt_deg),
        device="cpu",
    )
    X = rng.standard_normal((n, d)).astype(np.float32)
    return gj, gt, X


@pytest.mark.parametrize(
    "n,d,k,block",
    [
        (96, 64, 4, 32),
        (50, 48, 3, 16),  # ragged: N is not a multiple of the row block
        (77, 20, 6, 32),  # ragged N and D % 128 != 0
    ],
)
def test_plain_version_matches_pallas_kernel(n, d, k, block):
    gj, gt, X = _shared(n, d, k, seed=n)
    ref = lap_matvec_pallas(gj.idx, gj.wn, jnp.asarray(X), block_rows=block, interpret=True)
    out = spmv.lap_matvec_ref(gt.idx, gt.wn, torch.from_numpy(X))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,k", [(300, 64, 6), (4099, 9, 5), (31, 3, 1)])
def test_lap_matvec_cpu_matches_jax_gather(n, d, k):
    gj, gt, X = _shared(n, d, k, seed=k)
    ref = np.asarray(jlap_matvec(gj, jnp.asarray(X)))
    out = tgraph.lap_matvec(gt, torch.from_numpy(X))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_cpu_dispatch_is_the_plain_version_and_launches_nothing():
    _, gt, X = _shared(40, 8, 3, seed=1)
    before = spmv.launches
    Xt = torch.from_numpy(X)
    assert torch.equal(tgraph.lap_matvec(gt, Xt), spmv.lap_matvec_ref(gt.idx, gt.wn, Xt))
    assert spmv.launches == before


def test_wrapper_refuses_cpu_tensors():
    _, gt, X = _shared(40, 8, 3, seed=2)
    before = spmv.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmv.lap_matvec_cuda(gt.idx, gt.wn, torch.from_numpy(X))
    assert spmv.launches == before


def test_build_target_is_content_addressed():
    src, lib = kbuild._target("spmv")
    assert src == kbuild.CSRC_DIR / "spmv.cu" and src.exists()
    assert lib.parent == kbuild.BUILD_DIR
    assert lib.name.startswith("spmv-") and lib.suffix == ".so"
    text = src.read_text()
    assert "oscillink_tpu/ops/pallas/spmv.py:_spmv_kernel" in text
    assert 'extern "C"' in text and "oscillink_spmv_gather" in text


def test_build_dir_is_the_checkout_or_the_user_cache(tmp_path, monkeypatch):
    assert kbuild.BUILD_DIR == kbuild.PACKAGE_DIR.parent / "build" / "oscillink_tpu_torch"
    site = tmp_path / "site-packages"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert kbuild._build_dir(site / "oscillink_tpu_torch") == tmp_path / "cache" / "oscillink_tpu_torch"
    (tmp_path / "checkout").mkdir()
    (tmp_path / "checkout" / "pyproject.toml").write_text("")
    assert (
        kbuild._build_dir(tmp_path / "checkout" / "oscillink_tpu_torch")
        == tmp_path / "checkout" / "build" / "oscillink_tpu_torch"
    )


def test_interop_rejects_out_of_range_ids():
    idx = np.array([[1], [2], [3]], dtype=np.int32)
    w = np.ones((3, 1), np.float32)
    with pytest.raises(ValueError, match=r"\[0, N\)"):
        interop.graph_from_numpy(idx, w, w, np.ones(3, np.float32), device="cpu")


H100_L2 = 50 * 2**20  # torch.cuda.get_device_properties(...).L2_cache_size on an H100


def _slabs(d, width):
    return [(c0, min(c0 + width, d)) for c0 in range(0, d, width)]


@pytest.mark.parametrize(
    "n,d,k,l2",
    [
        (131072, 768, 8, H100_L2),  # the corpus: 24 slabs of 32
        (5000, 128, 6, H100_L2),  # the headline: X fits, one slab
        (131072, 97, 8, H100_L2),  # D % 4 != 0: the scalar path
        (131072, 130, 8, H100_L2),
        (4099, 3, 5, 4099 * 3 * 4 + 4099 * 5 * 8),  # D = 3 past a forced budget
        (4099, 3, 5, 2 * (4099 * 3 * 4 + 4099 * 5 * 8)),  # D = 3 just fitting
        (1000, 768, 1, 2 * 2**20),  # K = 1, forced small budget
        (1000, 768, 40, 2 * 2**20),  # K = 40: idx and wn take most of it
        (1000, 768, 40, 0),  # nothing fits: the narrowest slab
        (1000, 97, 40, 0),
        (262144, 768, 8, H100_L2),
    ],
)
def test_slab_plan_covers_the_columns_once_and_fits_the_budget(n, d, k, l2):
    width = spmv.slab_plan(n, d, k, l2)
    budget = spmv.l2_budget(l2)
    assert 1 <= width <= d
    cols = [c for c0, c1 in _slabs(d, width) for c in range(c0, c1)]
    assert cols == list(range(d))
    if d % 4 == 0:
        assert width % 4 == 0 and width >= 4
    if n * d * 4 + n * k * 8 <= budget:
        assert width == d
    else:
        narrowest = 4 if d % 4 == 0 else 1
        assert width < d
        assert width == narrowest or n * width * 4 + n * k * 8 <= budget
        # the widest such slab: one more step would not fit
        assert n * (width + narrowest) * 4 + n * k * 8 > budget


def test_slab_plan_at_the_h100_shapes():
    assert spmv.slab_plan(131072, 768, 8, H100_L2) == 32
    assert spmv.slab_plan(5000, 128, 6, H100_L2) == 128
    assert spmv.l2_budget(H100_L2) == 25 * 2**20


@pytest.mark.parametrize("d,k", [(768, 8), (97, 8), (130, 1), (3, 40)])
def test_slab_width_shrinks_as_n_grows_and_is_never_zero(d, k):
    widths = [spmv.slab_plan(n, d, k, H100_L2) for n in (1, 1000, 8192, 65536, 131072, 1 << 20)]
    assert all(w >= 1 for w in widths)
    assert widths == sorted(widths, reverse=True)
    assert widths[0] == d


@pytest.mark.parametrize(
    "n,d,k,l2",
    [
        (300, 64, 6, 2 * (300 * 16 * 4 + 300 * 6 * 8)),  # 4 slabs of 16
        (4099, 97, 5, 2 * (4099 * 10 * 4 + 4099 * 5 * 8)),  # 10 columns, ragged last slab
        (333, 130, 1, 0),  # D % 4 != 0 and nothing fits: slabs of one column
        (1000, 64, 40, 0),  # K past a warp's lanes, narrowest float4 slab
        (200, 48, 3, H100_L2),  # fits: one slab
    ],
)
def test_plain_version_slab_by_slab_equals_the_whole_width(n, d, k, l2):
    _, gt, X = _shared(n, d, k, seed=d)
    Xt = torch.from_numpy(X)
    whole = spmv.lap_matvec_ref(gt.idx, gt.wn, Xt)
    width = spmv.slab_plan(n, d, k, l2)
    parts = [spmv.lap_matvec_ref(gt.idx, gt.wn, Xt[:, c0:c1]) for c0, c1 in _slabs(d, width)]
    assert len(parts) == -(-d // width)
    assert torch.equal(torch.cat(parts, dim=1), whole)
