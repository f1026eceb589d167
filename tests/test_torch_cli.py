"""The port's CLI (`oscillink_tpu_torch.cli`) and tools: the JAX package's
CLI and tools tests (``tests/test_cli_tools.py``) on the port, and
``settle`` on the same ``.npy`` / ``.npz`` files through both CLIs, whose
JSON must agree: ΔH within 1e-5 relative, the CG residual within 1e-4
relative (its last bits follow the reduction order), everything else
equal.  Under ``--diffusion`` the state signature hashes the derived gates
rounded to 1e-6, and the two packages' gates agree only to f32 rounding, so
the signatures are held equal exactly when every gate rounds alike
(ROADMAP.md queue C)."""

import json
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from oscillink_tpu import cli as jax_cli  # noqa: E402
from oscillink_tpu_torch import cli  # noqa: E402
from oscillink_tpu_torch.tools.license import (  # noqa: E402
    LicenseError,
    entitlement_env_lines,
    verify_license_token,
)
from oscillink_tpu_torch.tools.license_service import LicenseIssuer  # noqa: E402
from oscillink_tpu_torch.tools.usage_flush import read_new_lines  # noqa: E402

DH_REL, RES_REL = 1e-5, 1e-4


@pytest.fixture()
def config_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("OSCILLINK_CONFIG_DIR", str(tmp_path / "cfg"))
    return tmp_path


def _stub_http(monkeypatch, responses):
    calls = []

    def fake_http(method, url, data=None, headers=None):
        calls.append((method, url, data, headers))
        for frag, resp in responses.items():
            if frag in url:
                return resp
        raise RuntimeError(f"unexpected url {url}")

    monkeypatch.setattr(cli, "_http", fake_http)
    return calls


def test_cli_login_and_whoami(config_dir, monkeypatch, capsys):
    _stub_http(monkeypatch, {"/billing/cli/poll/abc": {"status": "complete", "api_key": "key123",
                                                       "tier": "pro"}})
    assert cli.main(["login", "--code", "abc"]) == 0
    assert cli.main(["whoami"]) == 0
    assert "key123" in capsys.readouterr().out
    assert cli.main(["logout"]) == 0
    assert cli.main(["whoami"]) == 1


def test_cli_login_pending(config_dir, monkeypatch):
    _stub_http(monkeypatch, {"/billing/cli/poll/p": {"status": "pending"}})
    assert cli.main(["login", "--code", "p"]) == 1


def test_cli_signup_no_wait(config_dir, monkeypatch, capsys):
    calls = _stub_http(monkeypatch, {"/billing/cli/start": {"code": "xyz", "status": "pending",
                                                            "checkout_url": "http://x"}})
    assert cli.main(["signup", "--tier", "pro", "--email", "a@b.c"]) == 0
    out = capsys.readouterr().out
    assert "xyz" in out and "oscillink-tpu-torch login --code xyz" in out
    assert calls[0][0] == "POST" and calls[0][2] == {"tier": "pro", "email": "a@b.c"}


def test_cli_portal_requires_login(config_dir, monkeypatch):
    assert cli.main(["portal"]) == 1


def test_cli_portal_after_login(config_dir, monkeypatch, capsys):
    calls = _stub_http(monkeypatch, {
        "/billing/cli/poll/abc": {"status": "complete", "api_key": "k", "tier": "pro"},
        "/billing/portal": {"url": "http://portal"},
    })
    assert cli.main(["login", "--code", "abc", "--base", "http://svc/prefix"]) == 0
    assert cli.main(["portal"]) == 0
    assert "http://portal" in capsys.readouterr().out
    assert calls[-1][1] == "http://svc/prefix/billing/portal"
    assert calls[-1][3] == {"X-API-Key": "k"}


def test_config_file_is_the_jax_clis(config_dir, monkeypatch):
    """Both CLIs keep the same config file: a login through one is seen by
    the other."""
    _stub_http(monkeypatch, {"/billing/cli/poll/abc": {"status": "complete", "api_key": "kk",
                                                       "tier": "free"}})
    assert cli.main(["login", "--code", "abc"]) == 0
    assert cli._config_file() == jax_cli._config_file()
    assert jax_cli._load_config()["api_key"] == "kk"


def test_cli_settle_local(config_dir, tmp_path, capsys):
    rng = np.random.default_rng(0)
    p = tmp_path / "emb.npz"
    np.savez(p, Y=rng.standard_normal((20, 8)).astype(np.float32),
             psi=rng.standard_normal(8).astype(np.float32))
    assert cli.main(["settle", str(p), "--kneighbors", "3", "--light", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert "deltaH_total" in out and out["settle"]["iters"] >= 1


def test_cli_settle_diffusion_and_rerank(config_dir, tmp_path, capsys):
    rng = np.random.default_rng(1)
    p = tmp_path / "emb.npz"
    np.savez(p, Y=rng.standard_normal((20, 8)).astype(np.float32),
             psi=rng.standard_normal(8).astype(np.float32))
    assert cli.main(["settle", str(p), "--kneighbors", "3", "--light", "--diffusion",
                     "--bundle-k", "5", "--rerank", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["bundle"]) == 5 and len(set(out["bundle"])) == 5


def _write(tmp_path, kind, n, d, seed):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    if kind == "npy":
        path = tmp_path / "emb.npy"
        np.save(path, Y)
    else:
        path = tmp_path / "emb.npz"
        np.savez(path, Y=Y, psi=Y[:4].mean(0))
    return str(path)


def _gates_round_alike(path, flags):
    """Whether the two packages' diffusion gates for this file round alike
    at 1e-6 (what `compute_state_sig` hashes)."""
    import oscillink_tpu as ot
    from oscillink_tpu_torch import OscillinkLattice

    data = np.load(path)
    Y, psi = data["Y"], data["psi"]
    opts = dict(zip(flags[::2], flags[1::2]))
    beta = float(opts.get("--diffusion-beta", 1.0))
    gamma = float(opts.get("--diffusion-gamma", 0.1))
    k = int(opts.get("--kneighbors", 6))
    gates = []
    for lat in (OscillinkLattice(Y, kneighbors=k, device="cpu"), ot.OscillinkLattice(Y, kneighbors=k)):
        lat.set_query(psi)
        gates.append(np.round(lat.diffusion_gates(beta=beta, gamma=gamma), 6))
    return bool(np.array_equal(*gates))


def _same_json(port, jax, sig_equal=True):
    assert port.keys() == jax.keys()
    for key in port:
        if key == "state_sig" and not sig_equal:
            continue
        if key == "deltaH_total":
            assert abs(port[key] - jax[key]) <= DH_REL * abs(jax[key])
        elif key == "settle":
            assert port[key]["iters"] == jax[key]["iters"]
            assert abs(port[key]["res"] - jax[key]["res"]) <= RES_REL * abs(jax[key]["res"])
        elif key != "debug_report":
            assert port[key] == jax[key], key


@pytest.mark.parametrize("kind,flags", [
    ("npy", []),
    ("npz", ["--bundle-k", "6"]),
    ("npz", ["--light", "--bundle-k", "4", "--kneighbors", "5"]),
    ("npz", ["--diffusion", "--bundle-k", "5"]),
    ("npz", ["--diffusion", "--diffusion-beta", "2.0", "--diffusion-gamma", "0.3", "--rerank",
             "--bundle-k", "5"]),
    ("npz", ["--rerank", "--bundle-k", "7", "--max-iters", "20", "--tol", "1e-4"]),
    ("npz", ["--debug-report", "REPORT", "--bundle-k", "3"]),
    ("npy", ["--light", "--debug-report", "REPORT"]),
])
def test_settle_prints_the_jax_clis_json(kind, flags, tmp_path, capsys):
    path = _write(tmp_path, kind, 60, 12, seed=len(flags))
    outs = []
    for fn, extra, tag in ((cli.main, ["--device", "cpu"], "port"), (jax_cli.main, [], "jax")):
        argv = [f.replace("REPORT", str(tmp_path / f"{tag}.html")) for f in flags]
        assert fn(["settle", path, *argv, *extra]) == 0
        outs.append(json.loads(capsys.readouterr().out))
    diffusion = "--diffusion" in flags
    _same_json(*outs, sig_equal=not diffusion or _gates_round_alike(
        path, [f for f in flags if f not in ("--diffusion", "--rerank")]))
    if "--debug-report" in flags:
        assert outs[0]["debug_report"] == str(tmp_path / "port.html")
        assert (tmp_path / "port.html").read_text().startswith("<!DOCTYPE html>")


def test_settle_runs_as_a_module(tmp_path):
    path = _write(tmp_path, "npz", 30, 8, seed=3)
    out = subprocess.run(
        [sys.executable, "-m", "oscillink_tpu_torch.cli", "settle", path, "--bundle-k", "3",
         "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(json.loads(out.stdout)["bundle"]) == 3


def test_the_card_is_the_default_device(tmp_path, capsys):
    """Without ``--device`` the command runs on ``cuda``: where there is no
    card it fails naming CUDA (no quiet fallback to the CPU)."""
    import torch

    path = _write(tmp_path, "npy", 20, 8, seed=4)
    rc = cli.main(["settle", path])
    if torch.cuda.is_available():
        assert rc == 0
    else:
        assert rc == 1 and "CUDA" in capsys.readouterr().err


def test_license_roundtrip():
    iss = LicenseIssuer()
    token = iss.issue(
        sub="lic-42",
        tier="enterprise",
        limits={"max_nodes": 10000, "quota_units": 1000, "monthly_cap": 99},
        features={"diffusion_gates": True, "priority_queue": False},
    )
    payload = verify_license_token(token, jwks=iss.jwks(), iss="oscillink-license")
    assert payload["tier"] == "enterprise"
    lines = entitlement_env_lines(payload)
    assert "OSCILLINK_MAX_NODES=10000" in lines
    assert "OSCILLINK_FEAT_DIFFUSION_GATES=1" in lines
    assert "OSCILLINK_FEAT_PRIORITY_QUEUE=0" in lines
    assert "OSCILLINK_MONTHLY_CAP=99" in lines
    assert "OSCILLINK_KEY_TIERS=lic-42:enterprise" in lines


def test_license_tokens_verify_across_packages():
    from oscillink_tpu.tools.license import verify_license_token as jax_verify
    from oscillink_tpu.tools.license_service import LicenseIssuer as JaxIssuer

    ours, theirs = LicenseIssuer(), JaxIssuer()
    assert jax_verify(ours.issue(sub="a", tier="pro"), jwks=ours.jwks())["tier"] == "pro"
    assert verify_license_token(theirs.issue(sub="b"), jwks=theirs.jwks())["sub"] == "b"


def test_license_rejects_tamper_and_claims():
    import base64

    iss = LicenseIssuer()
    token = iss.issue(sub="x", tier="pro")
    h, p, s = token.split(".")
    payload = json.loads(base64.urlsafe_b64decode(p + "=="))
    payload["tier"] = "enterprise"
    p_bad = base64.urlsafe_b64encode(json.dumps(payload).encode()).rstrip(b"=").decode()
    with pytest.raises(LicenseError):
        verify_license_token(f"{h}.{p_bad}.{s}", jwks=iss.jwks())
    with pytest.raises(LicenseError):
        verify_license_token(token, jwks=iss.jwks(), iss="wrong-issuer")
    with pytest.raises(LicenseError):
        verify_license_token(token, jwks=iss.jwks(), aud="nobody")
    with pytest.raises(LicenseError):
        verify_license_token(iss.issue(sub="x", ttl=-10_000), jwks=iss.jwks())


def test_license_wrong_key_fails():
    iss_a, iss_b = LicenseIssuer(), LicenseIssuer()
    with pytest.raises(LicenseError):
        verify_license_token(iss_a.issue(sub="x"), jwks=iss_b.jwks())


def test_usage_flush_offsets(tmp_path):
    log = tmp_path / "usage.jsonl"
    offset = str(log) + ".offset"
    log.write_text('{"a": 1}\n{"a": 2}\n')
    recs, new_off = read_new_lines(str(log), offset)
    assert [r["a"] for r in recs] == [1, 2]
    with open(offset, "w") as f:
        f.write(str(new_off))
    with open(log, "a") as f:
        f.write('{"a": 3}\n')
    recs2, _ = read_new_lines(str(log), offset)
    assert [r["a"] for r in recs2] == [3]
