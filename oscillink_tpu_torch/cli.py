"""User CLI of the PyTorch port (port of ``oscillink_tpu/cli.py``; reference
oscillink/cli.py:57-199): signup / login / whoami / logout / portal against
the cloud API, plus local conveniences (settle a saved embedding file, run
the service).

    oscillink-tpu-torch settle emb.npz --bundle-k 8 --debug-report out.html
    python -m oscillink_tpu_torch.cli serve --port 8000

``settle`` and ``serve`` take ``--device`` (``cuda``, the default, or
``cpu``); there is no other option the JAX CLI lacks.  Config lives in
~/.oscillink-tpu/config.json (OSCILLINK_CONFIG_DIR override), shared with
the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Any, Optional

DEFAULT_API_BASE = os.environ.get("OSCILLINK_API_BASE", "http://localhost:8000")


def _config_file() -> Path:
    cfg_dir = Path(os.environ.get("OSCILLINK_CONFIG_DIR", Path.home() / ".oscillink-tpu"))
    return cfg_dir / "config.json"


class CliHttpError(RuntimeError):
    """Raised for any transport or non-2xx failure of a CLI API call."""


def _api_url(base: str, path: str) -> str:
    """Join preserving any path prefix in the base URL — urljoin with a
    leading-slash path discards e.g. the /oscillink of
    https://example.com/oscillink (reverse-proxy deployments)."""
    return base.rstrip("/") + path


def _http(method: str, url: str, data: Optional[dict] = None, headers: Optional[dict] = None):
    """Minimal JSON-over-HTTP round trip for the CLI (stdlib only).

    Decodes JSON bodies when the server declares them, returns raw text
    otherwise; all failures surface as CliHttpError with the response body
    (when one exists) so `oscillink login` errors are actionable."""
    payload = None if data is None else json.dumps(data).encode()
    req = urllib.request.Request(
        url,
        data=payload,
        method=method.upper(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )

    def decode(body: bytes, content_type: str):
        text = body.decode("utf-8", errors="replace")
        if "json" in content_type.lower():
            try:
                return json.loads(text)
            except Exception:
                raise CliHttpError(
                    f"server sent invalid JSON: {text[:200]!r}"
                ) from None
        # a proxy / wrong --base answering 200 text/html must be an
        # actionable error, not an AttributeError on resp.get() downstream
        raise CliHttpError(
            f"expected a JSON response, got {content_type or 'no content type'}: "
            f"{text[:200]!r}"
        )

    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return decode(resp.read(), resp.headers.get("Content-Type") or "")
    except urllib.error.HTTPError as exc:
        body = b""
        try:
            body = exc.read()
        except Exception:
            pass
        raise CliHttpError(
            f"server responded {exc.code}: "
            f"{body.decode('utf-8', errors='replace') or exc.reason}"
        ) from None
    except urllib.error.URLError as exc:
        raise CliHttpError(f"could not reach {url}: {exc.reason}") from exc


def _load_config() -> dict:
    f = _config_file()
    if f.exists():
        try:
            return json.loads(f.read_text(encoding="utf-8"))
        except Exception:
            return {}
    return {}


def _save_config(cfg: dict) -> None:
    f = _config_file()
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(json.dumps(cfg, indent=2), encoding="utf-8")
    try:
        # the config stores the API key: keep it out of other users' reach
        os.chmod(f.parent, 0o700)
        os.chmod(f, 0o600)
    except OSError:
        pass


def _store_key(base: str, poll: dict) -> None:
    cfg = _load_config()
    cfg.update(
        {"api_key": poll.get("api_key"), "tier": poll.get("tier"), "api_base": base}
    )
    _save_config(cfg)


def cmd_signup(args: argparse.Namespace) -> int:
    base = args.base or DEFAULT_API_BASE
    resp = _http(
        "POST",
        _api_url(base, "/billing/cli/start"),
        {"tier": args.tier, **({"email": args.email} if args.email else {})},
    )
    code = resp.get("code")
    print(f"Checkout URL: {resp.get('checkout_url')}")
    print(f"Code: {code}")
    if not args.wait:
        print(f"Complete checkout in your browser, then run: oscillink-tpu-torch login --code {code}")
        return 0
    t0 = time.time()
    while True:
        try:
            poll = _http("GET", _api_url(base, f"/billing/cli/poll/{code}"))
        except CliHttpError as exc:
            # a transient 502/reset mid-checkout must not abort the wait —
            # the timeout budget governs, not one flaky poll
            if time.time() - t0 > args.timeout:
                print(f"Timed out waiting for key (last error: {exc}).")
                return 3
            time.sleep(2)
            continue
        status = poll.get("status")
        if status in ("ready", "complete"):
            _store_key(base, poll)
            print("Your API key:", poll.get("api_key"))
            return 0
        if status == "expired":
            print("Session expired. Please run signup again.")
            return 2
        if time.time() - t0 > args.timeout:
            print("Timed out waiting for key.")
            return 3
        time.sleep(2)


def cmd_login(args: argparse.Namespace) -> int:
    base = args.base or DEFAULT_API_BASE
    poll = _http("GET", _api_url(base, f"/billing/cli/poll/{args.code}"))
    status = poll.get("status")
    if status in ("ready", "complete"):
        _store_key(base, poll)
        print("Logged in. Key stored in", _config_file())
        return 0
    if status == "expired":
        print("Code expired. Run signup again.")
        return 2
    print("Not ready yet. Complete checkout and try again.")
    return 1


def cmd_whoami(_: argparse.Namespace) -> int:
    cfg = _load_config()
    if not cfg.get("api_key"):
        print("Not logged in. Run 'oscillink-tpu-torch signup' or "
              "'oscillink-tpu-torch login --code CODE'.")
        return 1
    print(json.dumps({k: cfg.get(k) for k in ("api_key", "tier", "api_base")}, indent=2))
    return 0


def cmd_logout(_: argparse.Namespace) -> int:
    cfg = _load_config()
    cfg.pop("api_key", None)
    cfg.pop("tier", None)
    _save_config(cfg)
    print("Logged out (key removed from local config).")
    return 0


def cmd_portal(args: argparse.Namespace) -> int:
    cfg = _load_config()
    base = args.base or cfg.get("api_base") or DEFAULT_API_BASE
    api_key = cfg.get("api_key")
    if not api_key:
        print("Not logged in.")
        return 1
    resp = _http(
        "POST",
        _api_url(base, "/billing/portal"),
        {},
        headers={"X-API-Key": api_key},
    )
    print("Portal URL:", resp.get("url"))
    return 0


def cmd_settle(args: argparse.Namespace) -> int:
    """Settle a local .npy / .npz embedding file and print the receipt."""
    import numpy as np

    from .core.lattice import OscillinkLattice

    path = args.file
    if path.endswith(".npz"):
        data = np.load(path)
        Y = data["Y"].astype(np.float32)
        psi = data["psi"].astype(np.float32) if "psi" in data.files else None
    else:
        Y = np.load(path).astype(np.float32)
        psi = None
    lat = OscillinkLattice(Y, kneighbors=args.kneighbors, device=args.device)
    if psi is not None:
        lat.set_query(psi)
    if args.diffusion:
        if psi is None:
            print("warning: --diffusion without psi yields uniform gates",
                  file=sys.stderr)
        lat.diffusion_gates(
            beta=args.diffusion_beta, gamma=args.diffusion_gamma, apply=True
        )
    lat.set_receipt_detail("light" if args.light else "full")
    stats = lat.settle(max_iters=args.max_iters, tol=args.tol)
    rec = lat.receipt()
    out: dict[str, Any] = {
        "settle": {"iters": stats["iters"], "res": stats["res"]},
        "deltaH_total": rec["deltaH_total"],
        "state_sig": rec["meta"]["state_sig"],
        "null_points": len(rec["null_points"]),
    }
    if args.bundle_k:
        out["bundle"] = [
            e["id"]
            for e in lat.bundle(k=args.bundle_k, diversify=not args.rerank)
        ]
    if args.debug_report:
        if args.light:
            print("warning: --debug-report forces full receipt detail",
                  file=sys.stderr)
            lat.set_receipt_detail("full")
        from .utils.debug_report import generate_debug_report

        generate_debug_report(lat, args.debug_report)
        out["debug_report"] = args.debug_report
    print(json.dumps(out, indent=2))
    return 0


def cmd_serve(args: argparse.Namespace) -> int:  # pragma: no cover
    from .service.http import run

    run(host=args.host, port=args.port, device=args.device)
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="oscillink-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("signup", help="start checkout + obtain an API key")
    p.add_argument("--tier", default="free")
    p.add_argument("--email", default=None)
    p.add_argument("--base", default=None)
    p.add_argument("--wait", action="store_true")
    p.add_argument("--timeout", type=float, default=300.0)
    p.set_defaults(fn=cmd_signup)

    p = sub.add_parser("login", help="complete pairing with a signup code")
    p.add_argument("--code", required=True)
    p.add_argument("--base", default=None)
    p.set_defaults(fn=cmd_login)

    p = sub.add_parser("whoami", help="show stored identity")
    p.set_defaults(fn=cmd_whoami)

    p = sub.add_parser("logout", help="remove stored API key")
    p.set_defaults(fn=cmd_logout)

    p = sub.add_parser("portal", help="open the billing portal")
    p.add_argument("--base", default=None)
    p.set_defaults(fn=cmd_portal)

    p = sub.add_parser("settle", help="settle a local embedding file")
    p.add_argument("file")
    p.add_argument("--kneighbors", type=int, default=6)
    p.add_argument("--max-iters", type=int, default=12)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--light", action="store_true")
    p.add_argument("--bundle-k", type=int, default=0,
                   help="also print the top-k bundle ids")
    p.add_argument("--rerank", action="store_true",
                   help="bundle in rerank mode (pure score order, no MMR)")
    p.add_argument("--diffusion", action="store_true",
                   help="derive gates by screened diffusion before settling")
    p.add_argument("--diffusion-beta", type=float, default=1.0)
    p.add_argument("--diffusion-gamma", type=float, default=0.1)
    p.add_argument("--debug-report", default=None, metavar="OUT.html",
                   help="write the self-contained HTML debug report")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.set_defaults(fn=cmd_settle)

    p = sub.add_parser("serve", help="run the cloud service")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
