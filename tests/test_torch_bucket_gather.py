"""Kernel K5 (bucket gather) of the PyTorch port and the probe that drives it.

On the CPU: the plain version `bucket_gather_ref` and the entry point
`bucket_gather` on a CPU tensor are held exactly (`np.array_equal`) to the
TPU kernel itself, the JAX probe's `bucket_gather` run in interpret mode as
the probe's own check runs it: each element is one multiply on both sides.
The CUDA kernel has no CPU mode: `chip_smoke.py` holds it bit-equal to the
plain version on a card.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscillink_tpu_torch.benchmarks import probe_bucket_gather as probe  # noqa: E402
from oscillink_tpu_torch.ops.kernels import bucket_gather as bg  # noqa: E402
from oscillink_tpu_torch.ops.kernels import build as kbuild  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX probe's output keys (benchmarks/probe_bucket_gather.py:217-231) and
# the port's names for those it keeps; "device" and "method" keep theirs.
KEPT_KEYS = {
    "config": "config",
    "device": "device",
    "bucket_gather_pallas_ms": "bucket_gather_ms",
    "bucket_gather_effective_gbps": "bucket_gather_effective_gbps",
    "xla_flat_gather_ms": "flat_gather_ms",
    "xla_sorted_gather_ms": "sorted_gather_ms",
    "xla_segment_sum_ms": "segment_sum_ms",
    "traffic_model_gb": "traffic_model_gb",
    "decision_rule": "decision_rule",
    "method": "method",
}


@functools.cache
def _jax_probe():
    """The JAX package's probe, loaded from its file (``benchmarks/`` is not
    a package)."""
    path = os.path.join(ROOT, "benchmarks", "probe_bucket_gather.py")
    spec = importlib.util.spec_from_file_location("jax_probe_bucket_gather", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tensors(X, li, w):
    return tuple(torch.from_numpy(a) for a in (X, li, w))


@pytest.mark.parametrize(
    "n_buckets,d,e_pad",
    [
        (2, 128, 2 * bg.ETILE),  # the probe's own check shape
        (3, 97, bg.ETILE),  # D % 4 != 0: the kernel's scalar path
    ],
)
def test_plain_version_equals_pallas_kernel(n_buckets, d, e_pad):
    jp = _jax_probe()
    assert (jp.S, jp.ETILE) == (bg.S, bg.ETILE)
    X, li, w = probe.random_case(n_buckets, d, e_pad, seed=d)
    want = np.asarray(jp.bucket_gather(jnp.asarray(X), jnp.asarray(li), jnp.asarray(w),
                                       n_buckets, interpret=True))
    before = bg.launches
    ref = bg.bucket_gather_ref(*_tensors(X, li, w), n_buckets).numpy()
    entry = bg.bucket_gather(*_tensors(X, li, w), n_buckets).numpy()
    assert bg.launches == before
    assert ref.shape == (n_buckets * e_pad, d) and ref.dtype == np.float32
    assert np.array_equal(ref, want)
    assert np.array_equal(entry, want)


def _broken(case):
    X, li, w = probe.random_case(2, 8, bg.ETILE)
    if case == "rows":  # N != n_buckets * S
        X = X[:-1]
    elif case == "buckets":  # E % n_buckets != 0
        li, w = li[:-1], w[:-1]
    elif case == "etile":  # e_pad % ETILE != 0
        li, w = li[:-2], w[:-2]
    return _tensors(np.ascontiguousarray(X), np.ascontiguousarray(li), np.ascontiguousarray(w))


@pytest.mark.parametrize(
    "case,match",
    [
        ("cpu", "CUDA tensor"),
        ("rows", "n_buckets \\* S"),
        ("buckets", "equal buckets"),
        ("etile", "multiple of ETILE"),
    ],
)
def test_wrapper_refuses_cpu_tensors_and_broken_contracts(case, match):
    X, li, w = _broken(case)
    before = bg.launches
    with pytest.raises(ValueError, match=match):
        bg.bucket_gather_cuda(X, li, w, 2)
    assert bg.launches == before


def test_wrapper_refuses_wrong_dtypes():
    X, li, w = _broken("cpu")
    with pytest.raises(ValueError, match="int32"):
        bg.bucket_gather_cuda(X, li.long(), w, 2)
    with pytest.raises(ValueError, match="float32"):
        bg.bucket_gather_cuda(X.double(), li, w, 2)


def test_entry_point_refuses_other_devices():
    X, li, w = _broken("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        bg.bucket_gather(X.to("meta"), li, w, 2)


def test_probe_check_correct_on_cpu():
    assert probe.check_correct("cpu") == 0.0


def test_probe_draw_is_the_jax_probes():
    """`iso_case` draws what the JAX probe's main() draws (:130-138), so the
    card runs on the JAX probe's inputs."""
    case = probe.iso_case(d=4, n_buckets=2)
    n, e = 2 * bg.S, 2 * bg.S * probe.K
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    order = np.argsort(src // bg.S, kind="stable")
    assert np.array_equal(case["X"], X)
    assert np.array_equal(case["local_idx"][:, 0], src[order] % bg.S)
    assert np.array_equal(case["w"], rng.random((e, 1)).astype(np.float32))
    assert np.array_equal(case["dst"], order // probe.K)
    assert np.array_equal(case["src_asc"], np.sort(src))


def test_probe_measure_keeps_the_jax_probes_keys():
    out = probe.measure("cpu", d=16, n_buckets=2)
    assert set(KEPT_KEYS.values()) <= set(out)
    assert out["device"] == "cpu" and out["method"].startswith("host-clock")
    assert set(out["traffic_model_gb"]) >= {"staged_out", "x_stream"}
    assert out["decision"] == ("build" if out["speedup_vs_flat_gather"] >= 2.0 else "do not build")
    assert out["embedding_bag_max_abs_diff"] == 0.0
    assert out["bound_by"] == "bytes"
    # the H100's bytes bound at this shape: E*D*4 out, N*D*4 X, 8 bytes an edge
    e, n, d = 2 * bg.S * probe.K, 2 * bg.S, 16
    assert out["bound_ms"] == pytest.approx(1e3 * (e * d + n * d + 2 * e) * 4 / 3.35e12)
    for key in ("bucket_gather_ms", "flat_gather_ms", "sorted_gather_ms", "segment_sum_ms",
                "embedding_bag_ms", "bucket_gather_plain_ms"):
        assert out[key] > 0


def test_probe_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.main([])


def test_build_target_is_content_addressed():
    src, lib = kbuild._target("bucket_gather")
    assert src == kbuild.CSRC_DIR / "bucket_gather.cu" and src.exists()
    assert lib.parent == kbuild.BUILD_DIR and lib.name.startswith("bucket_gather-")
    text = src.read_text()
    assert "benchmarks/probe_bucket_gather.py:_bucket_gather_kernel" in text
    assert 'extern "C"' in text and "oscillink_bucket_gather" in text
    assert "__stcs" in text and "__fmul_rn" in text
