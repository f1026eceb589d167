"""The port's service outside the compute routes: what it imports, how it
starts (the refusal of the JAX service's unported routes, the kernel build
directory as the persistent compile cache), and the host modules the
handlers reach (autocorrect, the text embeddings of /v1/bench/competitor),
each against the JAX package's own on the same inputs."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu.adapters.text import simple_text_embed as jax_embed  # noqa: E402
from oscillink_tpu.preprocess.autocorrect import smart_correct as jax_correct  # noqa: E402
from oscillink_tpu_torch.adapters.text import embed_texts, simple_text_embed  # noqa: E402
from oscillink_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from oscillink_tpu_torch.preprocess.autocorrect import smart_correct  # noqa: E402
from oscillink_tpu_torch.service import LocalClient  # noqa: E402
from oscillink_tpu_torch.service import api  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVICE_MODULES = [
    "oscillink_tpu_torch.service",
    "oscillink_tpu_torch.service.api",
    "oscillink_tpu_torch.service.http",
    "oscillink_tpu_torch.service.warmup",
    "oscillink_tpu_torch.service.openapi",
    "oscillink_tpu_torch.service.redis_backend",
    "oscillink_tpu_torch.service.alerts",
    "oscillink_tpu_torch.service._firestore",
    "oscillink_tpu_torch.service._firestore_stores",
    "oscillink_tpu_torch.service.__main__",
    "oscillink_tpu_torch.utils.compile_cache",
    "oscillink_tpu_torch.adapters.text",
    "oscillink_tpu_torch.preprocess.autocorrect",
]


def test_service_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SERVICE_MODULES!r}: importlib.import_module(m)\n"
        "from oscillink_tpu_torch.service import create_state, LocalClient\n"
        "c = LocalClient(create_state(device='cpu'))\n"
        "r = c.post('/v1/settle', json_body={'Y': [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]})\n"
        "assert r.status_code == 200, r.json()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'oscillink_tpu' or m.startswith('oscillink_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("OSCILLINK_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("name,item", [
    ("OSCILLINK_NATIVE_SMALL_N", "queue A item 12"),
    ("OSCILLINK_SHARDED_MIN_N", "queue A item 11"),
])
def test_unported_routes_refuse_to_start(monkeypatch, name, item):
    monkeypatch.setenv(name, "64")
    with pytest.raises(RuntimeError, match=item):
        api.create_state(device="cpu")
    with pytest.raises(RuntimeError, match=name):
        LocalClient()


@pytest.mark.parametrize("value", ["0", "-5", "garbage", ""])
def test_route_thresholds_at_or_below_zero_start(monkeypatch, value):
    """The JAX service reads an unset, zero, negative or non-integer
    threshold as off; so does the port, and it serves from the lattice."""
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", value)
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", value)
    client = LocalClient(api.create_state(device="cpu"))
    r = client.post("/v1/settle", json_body={"Y": [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]})
    assert r.status_code == 200 and r.json()["meta"]["backend"] == "device"


@pytest.mark.parametrize("path", ["/v1/settle", "/v1/receipt", "/v1/bundle", "/v1/chain/receipt",
                                  "/v1/settle/batch", "/v1/jobs/settle"])
def test_a_threshold_set_after_start_refuses_each_request(monkeypatch, path):
    client = LocalClient(api.create_state(device="cpu"))
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "1")
    r = client.post(path, json_body={"Y": [[1.0, 0.0], [0.0, 1.0]], "chain": [0, 1],
                                     "psis": [[1.0, 0.0]]})
    assert r.status_code == 503 and "queue A item 11" in r.json()["detail"]


def test_default_device_is_the_card(monkeypatch):
    assert api.ServiceState(device="cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.create_state()


# -- the kernel build directory as the persistent compile cache ---------------


@pytest.fixture()
def cc(monkeypatch):
    """A fresh `utils.compile_cache` (its idempotency latch reset), the
    build directory restored afterwards."""
    from oscillink_tpu_torch.utils import compile_cache

    monkeypatch.setattr(kbuild, "BUILD_DIR", kbuild.BUILD_DIR)
    monkeypatch.delenv("OSCILLINK_COMPILE_CACHE_DIR", raising=False)
    return importlib.reload(compile_cache)


def test_compile_cache_disabled_by_default(cc):
    before = kbuild.BUILD_DIR
    assert cc.configure_compile_cache() is None
    assert kbuild.BUILD_DIR == before


def test_compile_cache_env_points_the_build_dir(cc, monkeypatch, tmp_path):
    cache = tmp_path / "kernels"
    monkeypatch.setenv("OSCILLINK_COMPILE_CACHE_DIR", str(cache))
    assert cc.configure_compile_cache() == str(cache)
    assert kbuild.BUILD_DIR == cache and cache.is_dir()
    assert cc.configure_compile_cache() == str(cache)  # idempotent
    assert kbuild._target("spmv")[1].parent == cache


def test_compile_cache_explicit_arg_beats_env(cc, monkeypatch, tmp_path):
    monkeypatch.setenv("OSCILLINK_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert cc.configure_compile_cache(str(tmp_path / "arg")) == str(tmp_path / "arg")
    assert kbuild.BUILD_DIR == tmp_path / "arg"


def test_service_startup_configures_the_build_dir(cc, monkeypatch, tmp_path):
    monkeypatch.setenv("OSCILLINK_COMPILE_CACHE_DIR", str(tmp_path / "svc"))
    api.create_state(device="cpu")
    assert kbuild.BUILD_DIR == tmp_path / "svc"


def test_a_built_library_in_the_cache_is_loaded_not_rebuilt(cc, monkeypatch, tmp_path):
    """A fresh process finds the library a previous one built under the
    cache directory (same source and flags, same hash) and runs no nvcc."""
    monkeypatch.setenv("OSCILLINK_COMPILE_CACHE_DIR", str(tmp_path / "persist"))
    cc.configure_compile_cache()
    lib = kbuild._target("spmv")[1]
    lib.write_bytes(b"built by an earlier process")

    def no_nvcc(*args, **kwargs):
        raise AssertionError("nvcc ran although the cache holds the library")

    monkeypatch.setattr(kbuild.subprocess, "Popen", no_nvcc)
    kbuild.build(["spmv"])
    assert lib.read_bytes() == b"built by an earlier process"


def test_compile_cache_unwritable_dir_degrades_to_disabled(cc, monkeypatch):
    before = kbuild.BUILD_DIR
    monkeypatch.setenv("OSCILLINK_COMPILE_CACHE_DIR", "/proc/definitely/unwritable/kernels")
    assert cc.configure_compile_cache() is None
    assert kbuild.BUILD_DIR == before


def test_warmup_primes_on_the_given_device(cc, monkeypatch):
    from oscillink_tpu_torch.service.warmup import run_warmup, warm_shapes

    monkeypatch.setenv("OSCILLINK_WARM_SHAPES", "64x16x3, bad, 128x32x6")
    assert warm_shapes() == [(64, 16, 3), (128, 32, 6)]
    monkeypatch.setenv("OSCILLINK_WARM_SHAPES", "64x16x3")
    assert run_warmup(verbose=False, device="cpu") == 1
    monkeypatch.setenv("OSCILLINK_WARM_SHAPES", "")
    assert run_warmup(verbose=False, device="cpu") == 0


# -- host modules the handlers reach, against the JAX package's ---------------


@pytest.mark.parametrize("text,kw", [
    ("teh cat", {}),
    ("Teh cat", {}),
    ("TEH CAT", {}),
    ("lamG teh API", {}),
    ("snake_case teh", {}),
    ("recieve2", {}),
    ("teh start\n```\nteh inside\n```\nteh end", {}),
    ("teh", {"custom_preserve": ["teh"]}),
    ("Recieve teh adress, (teh) https://teh.example seperate camelCase teh.", {}),
])
def test_autocorrect_matches_jax(text, kw):
    assert smart_correct(text, **kw) == jax_correct(text, **kw)


def test_autocorrect_cases():
    assert smart_correct("teh cat") == "the cat"
    assert smart_correct("TEH CAT") == "TEH CAT"
    out = smart_correct("teh start\n```\nteh inside\n```\nteh end").splitlines()
    assert out[0] == "the start" and out[2] == "teh inside" and out[4] == "the end"


def test_hash_embeddings_are_byte_compatible(monkeypatch):
    texts = ["hello", "world", "paris is the capital of france", ""]
    a = simple_text_embed(texts, d=384)
    assert a.tobytes() == jax_embed(texts, d=384).tobytes()
    np.testing.assert_allclose(np.linalg.norm(a[:3], axis=1), 1.0, atol=1e-5)
    monkeypatch.setenv("OSCILLINK_DISABLE_ST", "1")
    assert embed_texts(texts).tobytes() == a.tobytes()
    assert embed_texts([], fallback_dim=16).shape == (0, 16)
