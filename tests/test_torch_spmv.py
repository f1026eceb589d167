"""Kernel K1 (gather-SpMV) of the PyTorch port.

On the CPU: the plain version `lap_matvec_ref` is held against the TPU
kernel itself, `lap_matvec_pallas` run in interpret mode as the JAX
package's own tests run it, at rtol/atol 1e-5 (the same K order; the gap is
rounding only), ragged N included.  The CUDA kernel itself has no CPU mode:
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
