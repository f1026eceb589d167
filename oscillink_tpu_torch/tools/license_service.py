"""License service stub (reference license_svc/main.py:27-76): JWKS endpoint,
fake renewal, HMAC-verified usage report sink.  Framework-free handlers +
aiohttp binding, with an Ed25519 keypair generated at startup so issued
tokens actually verify against the served JWKS.

The port's own copy of ``oscillink_tpu/tools/license_service.py``: host-only, it
imports neither torch nor JAX.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import Optional


def _b64url(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode("ascii")


class LicenseIssuer:
    """Holds an Ed25519 keypair; issues EdDSA JWTs and serves the JWKS."""

    def __init__(self, kid: str = "lic-key-1", issuer: str = "oscillink-license"):
        from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
        from cryptography.hazmat.primitives.serialization import (
            Encoding,
            PublicFormat,
        )

        self.kid = kid
        self.issuer = issuer
        self._priv = Ed25519PrivateKey.generate()
        self._pub_raw = self._priv.public_key().public_bytes(
            Encoding.Raw, PublicFormat.Raw
        )

    def jwks(self) -> dict:
        return {
            "keys": [
                {
                    "kty": "OKP",
                    "crv": "Ed25519",
                    "kid": self.kid,
                    "x": _b64url(self._pub_raw),
                    "use": "sig",
                    "alg": "EdDSA",
                }
            ]
        }

    def issue(
        self,
        sub: str,
        tier: str = "pro",
        ttl: int = 86400,
        limits: Optional[dict] = None,
        features: Optional[dict] = None,
    ) -> str:
        now = int(time.time())
        header = {"alg": "EdDSA", "typ": "JWT", "kid": self.kid}
        payload = {
            "iss": self.issuer,
            "sub": sub,
            "tier": tier,
            "iat": now,
            "nbf": now,
            "exp": now + ttl,
            "limits": limits or {},
            "features": features or {},
        }
        h64 = _b64url(json.dumps(header, separators=(",", ":")).encode())
        p64 = _b64url(json.dumps(payload, separators=(",", ":")).encode())
        sig = self._priv.sign(f"{h64}.{p64}".encode("ascii"))
        return f"{h64}.{p64}.{_b64url(sig)}"


def verify_usage_report(body: bytes, signature: Optional[str], secret: str) -> bool:
    if not signature:
        return False
    expected = hmac.new(secret.encode(), body, hashlib.sha256).hexdigest()
    return hmac.compare_digest(expected, signature)


def create_app(issuer: Optional[LicenseIssuer] = None):  # pragma: no cover
    """aiohttp app: /.well-known/jwks.json, /v1/license/renew, /v1/usage/report."""
    from aiohttp import web

    iss = issuer or LicenseIssuer()
    reports: list[dict] = []

    async def jwks(request):
        return web.json_response(iss.jwks())

    async def renew(request):
        body = await request.json()
        token = iss.issue(
            sub=str(body.get("license_id", "lic-dev")),
            tier=str(body.get("tier", "pro")),
        )
        return web.json_response({"token": token})

    async def usage_report(request):
        raw = await request.read()
        secret = os.getenv("OSCILLINK_USAGE_SIGNING_SECRET", "")
        if secret and not verify_usage_report(
            raw, request.headers.get("X-Usage-Signature"), secret
        ):
            return web.json_response({"detail": "bad signature"}, status=401)
        try:
            reports.append(json.loads(raw))
        except Exception:
            return web.json_response({"detail": "invalid body"}, status=400)
        return web.json_response({"status": "accepted"})

    app = web.Application()
    app.router.add_get("/.well-known/jwks.json", jwks)
    app.router.add_post("/v1/license/renew", renew)
    app.router.add_post("/v1/usage/report", usage_report)
    app["reports"] = reports
    return app


if __name__ == "__main__":  # pragma: no cover
    from aiohttp import web

    web.run_app(create_app(), host="127.0.0.1", port=8088)
