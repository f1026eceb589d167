"""aiohttp binding for the framework-free service core.

Middleware parity with the reference stack (cloud/app/main.py:76-699 and
factory.py:26-87): body-size guard (413), request-id propagation, security
headers, sampled JSON access log, per-IP + global rate limits (handled inside
`api.handle`), CORS/TrustedHost from env.

The synchronous `handle()` (which runs full lattice settles) executes in a
thread-pool executor so a long solve never blocks the event loop — health
checks and concurrent requests stay responsive.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import sys
import time
import uuid
from typing import Optional

from .api import ApiRequest, ServiceState, create_state, handle
from .config import get_app_settings

try:  # pragma: no cover — optional dependency
    from aiohttp import web

    HAVE_AIOHTTP = True
except Exception:  # pragma: no cover
    HAVE_AIOHTTP = False
    web = None  # type: ignore

_SECURITY_HEADERS = {
    "X-Content-Type-Options": "nosniff",
    "X-Frame-Options": "DENY",
    "Referrer-Policy": "no-referrer",
}


def _access_log(record: dict) -> None:
    if os.getenv("OSCILLINK_JSON_LOGS", "0") not in {"1", "true"}:
        return
    try:
        sample = float(os.getenv("OSCILLINK_LOG_SAMPLE", "1.0"))
    except ValueError:
        sample = 1.0
    if random.random() > sample:
        return
    sys.stderr.write(json.dumps(record, separators=(",", ":")) + "\n")


def _cors_headers(settings, request_origin: str) -> dict[str, str]:
    """Per-spec single-origin ACAO: echo the request origin when allowed
    (a comma-joined multi-value ACAO is rejected by browsers)."""
    if not settings.allowed_origins:
        return {}
    if "*" in settings.allowed_origins:
        return {"Access-Control-Allow-Origin": "*"}
    if request_origin and request_origin in settings.allowed_origins:
        return {
            "Access-Control-Allow-Origin": request_origin,
            "Vary": "Origin",
        }
    return {}


def create_app(state: Optional[ServiceState] = None):
    """Build the aiohttp application bound to a ServiceState."""
    if not HAVE_AIOHTTP:  # pragma: no cover
        raise RuntimeError("aiohttp is not available; use service.testing.LocalClient")
    st = state or create_state()
    settings = get_app_settings()

    def _early(request, payload: dict, status: int, cors: dict) -> "web.Response":
        # early rejections still carry request-id + security headers (log
        # correlation matters most for exactly these requests)
        out = web.json_response(payload, status=status)
        out.headers["X-Request-ID"] = request.headers.get(
            "X-Request-ID", uuid.uuid4().hex
        )
        for k, v in {**_SECURITY_HEADERS, **cors}.items():
            out.headers[k] = v
        return out

    async def dispatch(request: "web.Request") -> "web.StreamResponse":
        t0 = time.perf_counter()
        cors = _cors_headers(settings, request.headers.get("Origin", ""))
        if request.method == "OPTIONS" and cors:
            out = web.Response(status=204)
            for k, v in cors.items():
                out.headers[k] = v
            out.headers["Access-Control-Allow-Methods"] = "GET,POST,PUT,DELETE"
            out.headers["Access-Control-Allow-Headers"] = (
                "Content-Type,X-API-Key,X-Request-ID,X-Admin-Secret"
            )
            out.headers["Access-Control-Max-Age"] = "600"
            return out
        body = await request.read()
        if len(body) > settings.max_body_bytes:
            return _early(request, {"detail": "request body too large"}, 413, cors)
        host = request.headers.get("Host", "")
        if settings.trusted_hosts != ("*",) and host.split(":")[0] not in settings.trusted_hosts:
            return _early(request, {"detail": "untrusted host"}, 400, cors)

        api_req = ApiRequest(
            method=request.method,
            path=request.path,
            headers={k.lower(): v for k, v in request.headers.items()},
            body=body,
            remote_ip=request.remote or "0.0.0.0",
            query=dict(request.query),
        )
        # the sync handler runs full lattice settles — offload so one long
        # solve doesn't serialize every other request on the event loop
        resp = await asyncio.get_running_loop().run_in_executor(
            None, handle, st, api_req
        )
        _access_log(
            {
                "ts": time.time(),
                "method": request.method,
                "path": request.path,
                "status": resp.status,
                "duration_ms": 1000.0 * (time.perf_counter() - t0),
                "request_id": resp.headers.get("X-Request-ID", ""),
            }
        )
        if isinstance(resp.body, (bytes, bytearray)):
            out = web.Response(
                body=bytes(resp.body),
                status=resp.status,
                headers=resp.headers,
                content_type=resp.content_type.split(";")[0],
            )
        else:
            out = web.json_response(resp.body, status=resp.status)
            for k, v in resp.headers.items():
                out.headers[k] = v
        for k, v in cors.items():
            out.headers[k] = v
        return out

    app = web.Application(client_max_size=settings.max_body_bytes + 1024)
    app.router.add_route("*", "/{tail:.*}", dispatch)
    return app


def run(host: str = "127.0.0.1", port: int = 8000, device=None):  # pragma: no cover
    """Serve on ``device`` (``cuda`` unless given): the state first, so a
    refused configuration stops before the warmup runs."""
    from .warmup import run_warmup

    state = create_state(device)
    run_warmup(device=state.device)
    web.run_app(create_app(state), host=host, port=port)
