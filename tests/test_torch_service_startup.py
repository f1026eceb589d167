"""The port's service outside the compute routes: what it imports, how it
starts (with the sharded route's threshold set, the refusal of a native
route whose engine does not build, the kernel build directory as the
persistent compile cache), which route a threshold set after startup
selects, and the host modules the handlers reach (autocorrect, the text
embeddings of /v1/bench/competitor), each against the JAX package's own on
the same inputs."""

import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu.adapters.text import simple_text_embed as jax_embed  # noqa: E402
from oscillink_tpu.preprocess.autocorrect import smart_correct as jax_correct  # noqa: E402
from oscillink_tpu.service import LocalClient as JaxClient  # noqa: E402
from oscillink_tpu.service import config as jax_config  # noqa: E402
from oscillink_tpu.service.api import create_state as jax_create_state  # noqa: E402
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
    "oscillink_tpu_torch.service.native_path",
    "oscillink_tpu_torch.service.sharded_path",
    "oscillink_tpu_torch.parallel",
    "oscillink_tpu_torch.parallel.serve",
    "oscillink_tpu_torch.parallel.halo_cg",
    "oscillink_tpu_torch.cli",
    "oscillink_tpu_torch.native",
    "oscillink_tpu_torch.native.engine",
    "oscillink_tpu_torch.tools",
    "oscillink_tpu_torch.tools.license",
    "oscillink_tpu_torch.tools.license_service",
    "oscillink_tpu_torch.tools.usage_flush",
    "oscillink_tpu_torch.adapters",
    "oscillink_tpu_torch.adapters.registry",
    "oscillink_tpu_torch.adapters.lsa",
    "oscillink_tpu_torch.utils",
    "oscillink_tpu_torch.utils.device",
    "oscillink_tpu_torch.utils.profiling",
    "oscillink_tpu_torch.utils.debug_report",
]
TOOLS = ("license", "license_service", "usage_flush")


def test_service_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Every module of the service, the CLI, the native engine, the tools,
    the adapters, the mesh tiers and the utilities, then a request on each
    route (the lattice's, the native engine's and the sharded route's on a
    2-shard CPU mesh) and a CLI settle: no module of JAX or of the JAX
    package is loaded."""
    np.save(tmp_path / "Y.npy", np.random.default_rng(0).standard_normal((12, 4)).astype(np.float32))
    code = (
        "import contextlib, importlib, io, json, os, sys\n"
        f"for m in {SERVICE_MODULES!r}: importlib.import_module(m)\n"
        "from oscillink_tpu_torch.service import create_state, LocalClient\n"
        "from oscillink_tpu_torch import cli\n"
        "body = {'Y': [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]}\n"
        "c = LocalClient(create_state(device='cpu'))\n"
        "r = c.post('/v1/settle', json_body=body)\n"
        "assert r.status_code == 200 and r.json()['meta']['backend'] == 'device', r.json()\n"
        "os.environ['OSCILLINK_NATIVE_SMALL_N'] = '64'\n"
        "c = LocalClient(create_state(device='cpu'))\n"
        "r = c.post('/v1/settle', json_body=body)\n"
        "assert r.status_code == 200 and r.json()['meta']['backend'] == 'native', r.json()\n"
        "os.environ['OSCILLINK_NATIVE_SMALL_N'] = '0'\n"
        "os.environ['OSCILLINK_SHARDED_MIN_N'] = '2'\n"
        "c = LocalClient(create_state(device='cpu', mesh=['cpu', 'cpu']))\n"
        "r = c.post('/v1/settle', json_body={'Y': [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.5, 1.0]]})\n"
        "assert r.status_code == 200 and r.json()['meta']['backend'] == 'sharded', r.json()\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        f"    assert cli.main(['settle', {str(tmp_path / 'Y.npy')!r}, '--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'oscillink_tpu' or m.startswith('oscillink_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("OSCILLINK_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_tools_import_neither_torch_nor_jax():
    """The licence and usage tools are host-only: loaded from their files,
    they bring in neither torch nor JAX (nor the port's package, whose
    ``__init__`` imports torch)."""
    code = (
        "import importlib.util, json, sys\n"
        f"for name in {TOOLS!r}:\n"
        "    path = f'oscillink_tpu_torch/tools/{name}.py'\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('torch', 'jax', 'oscillink_tpu', 'oscillink_tpu_torch'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sharded_route_starts(monkeypatch):
    """``OSCILLINK_SHARDED_MIN_N`` > 0 starts the service, on the CPU with
    one shard by default or over a given mesh, and its requests at or
    above the threshold take the sharded route."""
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "4")
    body = {"Y": [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.5, 1.0]]}
    for mesh, shards in ((None, 1), ([torch.device("cpu")] * 4, 4)):
        state = api.create_state(device="cpu", mesh=mesh)
        assert state.mesh.size == shards
        r = LocalClient(state).post("/v1/receipt", json_body=body)
        assert r.status_code == 200 and r.json()["meta"]["backend"] == "sharded"
        assert r.json()["receipt"]["meta"]["mesh_devices"] == shards
    r = LocalClient(api.create_state(device="cpu")).post("/v1/settle", json_body={"Y": body["Y"][:3]})
    assert r.status_code == 200 and r.json()["meta"]["backend"] == "device"


@pytest.mark.parametrize("value", ["0", "-5", "garbage", ""])
def test_route_thresholds_at_or_below_zero_start(monkeypatch, value):
    """The JAX service reads an unset, zero, negative or non-integer
    threshold as off; so does the port, and it serves from the lattice."""
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", value)
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", value)
    client = LocalClient(api.create_state(device="cpu"))
    r = client.post("/v1/settle", json_body={"Y": [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]})
    assert r.status_code == 200 and r.json()["meta"]["backend"] == "device"


def _backend(client, path, body):
    r = client.post(path, json_body=body)
    if path == "/v1/jobs/settle":
        job = r.json()["job_id"]
        for _ in range(400):
            jr = client.get(f"/v1/jobs/{job}").json()
            if jr["status"] in {"done", "error"}:
                return r.status_code, jr["status"], jr.get("result", {}).get("backend")
            time.sleep(0.05)
        raise AssertionError(f"job {job} did not finish")
    return r.status_code, None, r.json().get("meta", {}).get("backend")


@pytest.mark.parametrize("path", ["/v1/settle", "/v1/receipt", "/v1/bundle", "/v1/chain/receipt",
                                  "/v1/settle/batch", "/v1/jobs/settle"])
def test_a_threshold_set_after_start_routes_as_the_jax_service(monkeypatch, path):
    """A threshold set after startup is read per request, as the JAX
    service reads it: each path's status and ``meta.backend`` are the JAX
    service's on the same request (the batch has no sharded route)."""
    for var in ("OSCILLINK_API_KEYS", "OSCILLINK_NATIVE_SMALL_N", "OSCILLINK_RATE_LIMIT"):
        monkeypatch.delenv(var, raising=False)
    jax_config.get_settings.cache_clear()
    clients = (LocalClient(api.create_state(device="cpu", mesh=[torch.device("cpu")] * 2)),
               JaxClient(jax_create_state()))
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "1")
    body = {"Y": [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.5, 1.0]], "chain": [0, 1, 3],
            "psis": [[1.0, 0.0]], "bundle_k": 2}
    port, jax = (_backend(c, path, body) for c in clients)
    assert port == jax
    # the batch's device route names no backend; every other path is sharded
    assert port[2] == (None if path == "/v1/settle/batch" else "sharded")


@pytest.fixture()
def broken_compiler(monkeypatch, tmp_path):
    """A compiler that fails and an empty engine build directory."""
    monkeypatch.setenv("CXX", "/bin/false")
    monkeypatch.setenv("OSCILLINK_NATIVE_CACHE", str(tmp_path / "empty-build"))


def test_native_route_starts_when_its_engine_builds(monkeypatch):
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "2048")
    client = LocalClient(api.create_state(device="cpu"))
    r = client.post("/v1/settle", json_body={"Y": [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]})
    assert r.status_code == 200 and r.json()["meta"]["backend"] == "native"


def test_native_route_refuses_to_start_when_its_engine_does_not_build(monkeypatch,
                                                                      broken_compiler):
    """The JAX service would serve these requests from the device without a
    word; the port refuses to start, naming the threshold and the failure."""
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "2048")
    with pytest.raises(RuntimeError, match=r"OSCILLINK_NATIVE_SMALL_N=2048.*/bin/false"):
        api.create_state(device="cpu")
    with pytest.raises(RuntimeError, match="native engine"):
        LocalClient()


@pytest.mark.parametrize("path", ["/v1/settle", "/v1/receipt", "/v1/bundle", "/v1/chain/receipt",
                                  "/v1/settle/batch", "/v1/jobs/settle"])
def test_a_native_threshold_set_after_start_with_no_engine_answers_503(monkeypatch, path,
                                                                       broken_compiler):
    client = LocalClient(api.create_state(device="cpu"))
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "64")
    r = client.post(path, json_body={"Y": [[1.0, 0.0], [0.0, 1.0]], "chain": [0, 1],
                                     "psis": [[1.0, 0.0]]})
    assert r.status_code == 503, r.json()
    assert "native engine" in r.json()["detail"] and "/bin/false" in r.json()["detail"]
    # above the threshold the card's route serves, engine or not
    monkeypatch.setenv("OSCILLINK_NATIVE_SMALL_N", "1")
    r = client.post("/v1/settle", json_body={"Y": [[1.0, 0.0], [0.0, 1.0]]})
    assert r.status_code == 200 and r.json()["meta"]["backend"] == "device"


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
