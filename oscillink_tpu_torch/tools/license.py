"""Licensed-container verification: Ed25519 JWT + JWKS with offline grace.

Behavioral contract (reference tools/license_verify.py:122-255): verify an
EdDSA-signed license JWT against a JWKS endpoint (ETag-cached, offline grace
window), check exp/nbf/iat with leeway and iss/aud claims, then export an
entitlements JSON + env lines (OSCILLINK_MAX_NODES, OSCILLINK_FEAT_*, tier and
key seeding) for the service to source at startup.

The port's own copy of ``oscillink_tpu/tools/license.py``: host-only, it
imports neither torch nor JAX.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import time
import urllib.request
from typing import Any, Optional

__all__ = [
    "LicenseError",
    "parse_jwt",
    "verify_license_token",
    "entitlement_env_lines",
    "main",
]


class LicenseError(Exception):
    pass


def _b64url(data: str) -> bytes:
    return base64.urlsafe_b64decode(data + "=" * (-len(data) % 4))


def parse_jwt(token: str) -> tuple[str, str, str, dict, dict]:
    parts = token.split(".")
    if len(parts) != 3:
        raise LicenseError("invalid JWT format (expected 3 segments)")
    h64, p64, s64 = parts
    try:
        header = json.loads(_b64url(h64))
        payload = json.loads(_b64url(p64))
    except Exception as e:
        raise LicenseError(f"invalid token encoding: {e}") from e
    return h64, p64, s64, header, payload


def _check_times(payload: dict, leeway: int) -> None:
    now = int(time.time())
    nbf, exp, iat = (int(payload.get(k, 0)) for k in ("nbf", "exp", "iat"))
    if nbf and now + leeway < nbf:
        raise LicenseError("token not yet valid (nbf)")
    if exp and now - leeway > exp:
        raise LicenseError("token expired (exp)")
    if iat and iat - leeway > now:
        raise LicenseError("token issued in the future (iat)")


def _check_claims(payload: dict, iss: Optional[str], aud: Optional[str]) -> None:
    if iss is not None and payload.get("iss") != iss:
        raise LicenseError("issuer mismatch (iss)")
    if aud is not None:
        claim = payload.get("aud")
        ok = (
            aud in claim
            if isinstance(claim, list)
            else claim == aud
            if isinstance(claim, str)
            else False
        )
        if not ok:
            raise LicenseError("audience mismatch (aud)")


def _verify_ed25519(h64: str, p64: str, s64: str, jwk: dict) -> None:
    try:
        from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey
    except Exception as e:  # pragma: no cover
        raise LicenseError("cryptography package required for Ed25519") from e
    if jwk.get("kty") != "OKP" or jwk.get("crv") != "Ed25519" or not jwk.get("x"):
        raise LicenseError("JWKS key is not Ed25519 (OKP/Ed25519)")
    try:
        pub = Ed25519PublicKey.from_public_bytes(_b64url(jwk["x"]))
        pub.verify(_b64url(s64), f"{h64}.{p64}".encode("ascii"))
    except LicenseError:
        raise
    except Exception as e:
        raise LicenseError("invalid signature (Ed25519 verification failed)") from e


def _fetch_jwks(url: str, cache_path: str, ttl: int, grace: int) -> dict:
    """JWKS with ETag-aware cache; serve stale within ``grace`` when the
    endpoint is unreachable (offline resilience)."""
    cached: dict[str, Any] = {}
    try:
        with open(cache_path, encoding="utf-8") as f:
            cached = json.load(f)
    except Exception:
        cached = {}
    now = int(time.time())
    if cached.get("jwks") and now - int(cached.get("fetched_at", 0)) < ttl:
        return cached["jwks"]
    headers = {}
    if cached.get("etag"):
        headers["If-None-Match"] = cached["etag"]
    try:
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=15) as resp:
            jwks = json.loads(resp.read().decode("utf-8"))
            etag = resp.headers.get("ETag")
        try:
            with open(cache_path, "w", encoding="utf-8") as f:
                json.dump({"jwks": jwks, "etag": etag, "fetched_at": now}, f)
        except Exception:
            pass
        return jwks
    except urllib.error.HTTPError as e:  # type: ignore[attr-defined]
        if e.code == 304 and cached.get("jwks"):
            # the server confirmed the cached keys are current — refresh
            # fetched_at so the ttl fast path and the grace window restart
            # (otherwise every verify re-hits the network after first ttl)
            try:
                cached["fetched_at"] = now
                with open(cache_path, "w", encoding="utf-8") as f:
                    json.dump(cached, f)
            except Exception:
                pass
            return cached["jwks"]
        # a 5xx endpoint is as unreachable as a refused connection for
        # grace purposes — fall through to the stale-cache window
        if cached.get("jwks") and now - int(cached.get("fetched_at", 0)) < ttl + grace:
            return cached["jwks"]
        raise LicenseError(f"JWKS fetch failed: HTTP {e.code}") from e
    except Exception as e:
        if cached.get("jwks") and now - int(cached.get("fetched_at", 0)) < ttl + grace:
            return cached["jwks"]  # offline grace
        raise LicenseError(f"JWKS unreachable and no usable cache: {e}") from e


def verify_license_token(
    token: str,
    jwks: Optional[dict] = None,
    *,
    jwks_url: Optional[str] = None,
    jwks_cache: str = "/tmp/oscillink_jwks_cache.json",
    ttl: int = 3600,
    grace: int = 86400,
    leeway: int = 300,
    iss: Optional[str] = None,
    aud: Optional[str] = None,
) -> dict:
    """Verify the token and return its payload (raises LicenseError)."""
    h64, p64, s64, header, payload = parse_jwt(token)
    if (header.get("alg") or "").upper() != "EDDSA":
        raise LicenseError(f"unsupported alg: {header.get('alg')}")
    typ = (header.get("typ") or "").upper()
    if typ and typ != "JWT":
        raise LicenseError(f"unsupported typ: {typ}")
    _check_times(payload, leeway)
    _check_claims(payload, iss, aud)
    if jwks is None:
        if not jwks_url:
            raise LicenseError("no JWKS source provided")
        jwks = _fetch_jwks(jwks_url, jwks_cache, ttl, grace)
    kid = header.get("kid")
    keys = jwks.get("keys", [])
    if kid is not None:
        candidates = [k for k in keys if k.get("kid") == kid]
    else:
        # no kid: try EVERY key — during rotation the JWKS carries old+new
        # and trying only keys[0] rejects tokens signed with the new key
        candidates = list(keys)
    if not candidates:
        raise LicenseError("no matching JWKS key")
    last_err: Optional[Exception] = None
    for jwk in candidates:
        try:
            _verify_ed25519(h64, p64, s64, jwk)
            return payload
        except Exception as e:
            last_err = e
    raise LicenseError(f"signature verification failed: {last_err}")


def entitlement_env_lines(payload: dict) -> list[str]:
    """Env exports the service honors (reference license_verify.py:145-180)."""
    lines: list[str] = []
    sub = payload.get("sub") or payload.get("license_id")
    tier = payload.get("tier")
    limits = payload.get("limits") or {}
    features = payload.get("features") or {}
    if tier:
        lines.append(f"OSCILLINK_TIER={tier}")
    if sub:
        lines.append(f"OSCILLINK_API_KEYS={sub}")
        if tier:
            lines.append(f"OSCILLINK_KEY_TIERS={sub}:{tier}")
    for claim, env in (("max_nodes", "OSCILLINK_MAX_NODES"), ("max_dim", "OSCILLINK_MAX_DIM")):
        v = limits.get(claim)
        if isinstance(v, int):
            lines.append(f"{env}={v}")
    qps = limits.get("qps")
    if isinstance(qps, int) and qps > 0:
        lines.append(f"OSCILLINK_RATE_LIMIT={qps}")
        lines.append(f"OSCILLINK_RATE_WINDOW={int(limits.get('qps_window') or 60)}")
    qu = limits.get("quota_units")
    if isinstance(qu, int) and qu > 0:
        lines.append(f"OSCILLINK_KEY_NODE_UNITS_LIMIT={qu}")
        lines.append(
            f"OSCILLINK_KEY_NODE_UNITS_WINDOW={int(limits.get('quota_window') or 3600)}"
        )
    mc = limits.get("monthly_cap") or limits.get("monthly_units")
    if isinstance(mc, int) and mc > 0:
        lines.append(f"OSCILLINK_MONTHLY_CAP={mc}")
    for fname, on in features.items():
        lines.append(f"OSCILLINK_FEAT_{str(fname).upper()}={'1' if on else '0'}")
    return lines


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="verify license JWT, export entitlements")
    parser.add_argument("--license-file", default=os.getenv("OSCILLINK_LICENSE_FILE"))
    parser.add_argument("--jwks-url", default=os.getenv("OSCILLINK_JWKS_URL"))
    parser.add_argument(
        "--out", default=os.getenv("OSCILLINK_ENTITLEMENTS_PATH", "/run/oscillink_entitlements.json")
    )
    parser.add_argument("--env-out", default=os.getenv("OSCILLINK_ENTITLEMENTS_ENV"))
    parser.add_argument("--iss", default=os.getenv("OSCILLINK_LICENSE_ISS"))
    parser.add_argument("--aud", default=os.getenv("OSCILLINK_LICENSE_AUD"))
    parser.add_argument("--leeway", type=int, default=int(os.getenv("OSCILLINK_JWT_LEEWAY", "300")))
    args = parser.parse_args(argv)

    if not args.license_file or not args.jwks_url:
        print("license file and JWKS URL are required", file=sys.stderr)
        return 2
    try:
        token = open(args.license_file, encoding="utf-8").read().strip()
        payload = verify_license_token(
            token, jwks_url=args.jwks_url, leeway=args.leeway, iss=args.iss, aud=args.aud
        )
    except (LicenseError, OSError) as e:
        print(f"license verification failed: {e}", file=sys.stderr)
        return 1
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    lines = entitlement_env_lines(payload)
    if args.env_out:
        with open(args.env_out, "w", encoding="utf-8") as f:
            f.write("\n".join(f"export {line}" for line in lines) + "\n")
    else:
        print("\n".join(lines))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
