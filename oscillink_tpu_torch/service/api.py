"""Framework-free service core: (ServiceState, ApiRequest) -> ApiResponse.

The port of ``oscillink_tpu/service/api.py``: the same endpoints, request
models, status codes and response bodies, served by the port's
`OscillinkLattice` on the state's device (``cuda`` unless `create_state`
is asked for another).  Endpoint surface and behavior mirror the reference
FastAPI app (cloud/app/main.py, jobs.py, admin.py, autocorrect.py,
benchmarks.py, billing_webhook.py); the web framework is deliberately
absent from this module so the whole service is testable in-process
(`testing.LocalClient`) and bindable to any HTTP server (`http.py`
provides aiohttp).

Every compute request is served by the lattice (``meta.backend`` is
``"device"``).  The JAX service's other two routes, the small-N native
host engine (``OSCILLINK_NATIVE_SMALL_N``) and the sharded mesh tier
(``OSCILLINK_SHARDED_MIN_N``), are off there unless their thresholds are
set above 0; they are not ported yet, so the port refuses to start with
either set (`create_state`) and refuses a compute request if one was set
since.
"""

from __future__ import annotations

import json
import os
import re
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
from pydantic import ValidationError

from .. import __version__
from ..core.lattice import OscillinkLattice
from ..preprocess.autocorrect import smart_correct
from ..utils.device import DeviceLike, resolve_device
from .billing import TIERS, price_map, tier_info
from .cache import BundleCache, ReplayCache
from .graph_cache import GraphCache, graph_cache_key
from .cli_sessions import CliSessionStore
from .config import env_flag, get_settings
from .features import resolve_features
from .governance import ApiError, MonthlyUsage, QuotaState, RateLimiter
from .jobs import JobStore
from .keystore import InMemoryKeyStore, KeyStore, make_keystore
from .learners import Learners
from .metrics import Metrics
from .models import (
    AdminKeyUpdate,
    AutoCorrectRequest,
    BatchSettleRequest,
    BundleRequest,
    ChainReceiptRequest,
    CompetitorBenchRequest,
    RaggedBundleRequest,
    SettleRequest,
)
from .usage import append_usage
from .webhooks import WebhookProcessor

REQUEST_ID_HEADER = "X-Request-ID"


# --------------------------------------------------------------------------
# transport-neutral request / response
# --------------------------------------------------------------------------


@dataclass
class ApiRequest:
    method: str
    path: str
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    remote_ip: str = "127.0.0.1"
    query: dict[str, str] = field(default_factory=dict)

    def header(self, name: str) -> Optional[str]:
        return self.headers.get(name.lower())

    def json(self) -> Any:
        try:
            return json.loads(self.body.decode("utf-8")) if self.body else {}
        except Exception:
            raise ApiError(400, "invalid JSON body") from None


@dataclass
class ApiResponse:
    status: int = 200
    body: Any = None  # dict/list (JSON) or bytes
    headers: dict[str, str] = field(default_factory=dict)
    content_type: str = "application/json"


# --------------------------------------------------------------------------
# service state
# --------------------------------------------------------------------------


class ServiceState:
    """All mutable service singletons, owned by one object (no module
    globals — the reference's reload-to-reset-env pattern becomes simply
    constructing a fresh ServiceState).  ``device``: where every lattice
    of the service runs (`resolve_device`; ``cuda`` by default)."""

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.keystore: KeyStore = make_keystore()
        self.quota = QuotaState()
        self.monthly = MonthlyUsage()
        self.rate_limiter = RateLimiter()
        self.metrics = Metrics()
        self.jobs = JobStore()
        self.bundle_cache = BundleCache()
        self.replay_cache = ReplayCache()
        self.graph_cache = GraphCache()
        self.learners = Learners()
        self.cli_sessions = CliSessionStore()
        self.webhooks = WebhookProcessor(self.keystore, self.cli_sessions)


# thresholds that route requests off the lattice in the JAX service, and
# the ROADMAP.md queue item that ports each route
_UNPORTED_ROUTES = (
    ("OSCILLINK_NATIVE_SMALL_N", "the native host engine", "queue A item 12"),
    ("OSCILLINK_SHARDED_MIN_N", "the sharded mesh tier", "queue A item 11"),
)


def _env_threshold(name: str) -> int:
    # the JAX service's reading: unset or not an integer is 0 (off)
    try:
        return int(os.getenv(name, "0"))
    except ValueError:
        return 0


def _unported_routes() -> list[str]:
    """One line for each route-off-the-lattice threshold set above 0."""
    return [
        f"{name}={_env_threshold(name)} selects {what}, which is not ported yet "
        f"(ROADMAP.md {item}); unset it or set it to 0"
        for name, what, item in _UNPORTED_ROUTES
        if _env_threshold(name) > 0
    ]


def _require_lattice_route() -> None:
    """Refuse a compute request that the JAX service would route off the
    lattice: the port never serves it from the lattice in its place."""
    lines = _unported_routes()
    if lines:
        raise ApiError(503, "; ".join(lines))


def create_state(device: DeviceLike = None) -> ServiceState:
    """A fresh service on ``device`` (``cuda`` unless given).  Raises
    RuntimeError when a threshold of `_unported_routes` is set."""
    lines = _unported_routes()
    if lines:
        raise RuntimeError("oscillink_tpu_torch.service: " + "; ".join(lines))
    # the kernels' build directory: with OSCILLINK_COMPILE_CACHE_DIR set, a
    # fresh serving process loads the nvcc products a previous one built
    # there (the port's stand-in for the JAX service's persistent XLA cache)
    from ..utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    return ServiceState(device)


# --------------------------------------------------------------------------
# auth / feature resolution (reference main.py:746-832)
# --------------------------------------------------------------------------


def _api_key_guard(state: ServiceState, req: ApiRequest) -> Optional[str]:
    key = req.header("x-api-key")
    ks = state.keystore
    if isinstance(ks, InMemoryKeyStore):
        ks.maybe_hot_reload()
    # legacy env list always enforced when present
    allowed = {
        k.strip()
        for k in os.getenv("OSCILLINK_API_KEYS", "").split(",")
        if k.strip()
    }
    if allowed:
        if key is None or key not in allowed:
            raise ApiError(401, "invalid or missing API key")
        return key
    backend = os.getenv("OSCILLINK_KEYSTORE_BACKEND", "memory").lower()
    if backend == "memory" and not allowed and ks.is_empty():
        return None  # open access
    if key:
        meta = ks.get(key)
        if meta:
            if meta.is_active():
                return key
            if meta.status == "pending":
                raise ApiError(403, "key pending manual activation")
            raise ApiError(401, "invalid or inactive API key")
        if backend == "firestore":
            raise ApiError(401, "invalid or missing API key")
        raise ApiError(401, "invalid or missing API key")
    if backend == "firestore":
        raise ApiError(401, "invalid or missing API key")
    if ks.is_empty():
        return None
    raise ApiError(401, "invalid or missing API key")


def _feature_context(state: ServiceState, req: ApiRequest) -> dict:
    key = _api_key_guard(state, req)
    meta = state.keystore.get(key) if key else None
    return {"api_key": key, "features": resolve_features(meta)}


def _bundle_cache_sig(state_sig: str, breq) -> str:
    """Bundle-cache key: the lattice state signature alone is NOT enough —
    bundle_k, alpha, and diversify all change the served picks without
    changing the lattice state (review finding: an alpha=1.0 request was
    served the cached alpha=0.0 ranking)."""
    mode = "mmr" if breq.diversify else "nodiv"
    return f"{state_sig}:{int(breq.bundle_k)}:{float(breq.alpha):.6g}:{mode}"


def _diffusion_requested(req) -> bool:
    """True when the request carries an enabled server-side diffusion block."""
    d = getattr(req, "diffusion", None)
    return d is not None and bool(d.enable)


def _validate_diffusion(req) -> None:
    """422 on a degenerate diffusion block — BEFORE quota is charged (the
    charge happens between parse and lattice build in _settle_core)."""
    if not _diffusion_requested(req):
        return
    if getattr(req, "gates", None) is not None:
        raise ApiError(
            422, "provide either explicit gates or a diffusion block, not both"
        )
    d = req.diffusion
    if not (np.isfinite(d.gamma) and d.gamma > 0):
        raise ApiError(422, "diffusion.gamma must be finite and > 0 (SPD)")
    if not np.isfinite(d.beta):
        raise ApiError(422, "diffusion.beta must be finite")
    if not (np.isfinite(d.tol) and d.tol > 0):
        raise ApiError(422, "diffusion.tol must be finite and > 0")
    if not 1 <= int(d.max_iters) <= 4096:
        raise ApiError(422, "diffusion.max_iters must be in [1, 4096]")


def _check_diffusion_allowed(requested, feats) -> None:
    if requested:
        if os.getenv("OSCILLINK_DIFFUSION_GATES_ENABLED", "1") not in {
            "1",
            "true",
            "TRUE",
            "on",
        }:
            raise ApiError(403, "diffusion gating temporarily disabled")
        if not feats.diffusion_allowed:
            raise ApiError(403, "diffusion gating not enabled for this tier")


# --------------------------------------------------------------------------
# lattice construction (reference main.py:887-947)
# --------------------------------------------------------------------------


def _parse(model, payload):
    try:
        return model.model_validate(payload)
    except ValidationError as e:
        raise ApiError(422, e.errors(include_url=False).__repr__()) from None


def _np_array_or_400(value, what: str) -> np.ndarray:
    """list -> float32 ndarray; ragged nested lists are a client error
    (pydantic's list[list[float]] accepts them, np.array raises)."""
    try:
        return np.array(value, dtype=np.float32)
    except (ValueError, TypeError):
        raise ApiError(400, f"{what} must be rectangular numeric") from None


def _validate_and_overrides(
    state: ServiceState, req: SettleRequest, api_key: Optional[str]
):
    """Shape/cap validation + adaptive-profile overrides (no lattice built).

    Validates EVERYTHING knowable without building (psi/gates lengths,
    chain bounds): every shape error must be a 400 BEFORE quota is
    charged, on every backend."""
    Y = _np_array_or_400(req.Y, "Y")
    if Y.ndim != 2 or Y.shape[0] == 0 or Y.shape[1] == 0:
        raise ApiError(400, "Empty matrix")
    N, D = Y.shape
    s = get_settings()
    if N > s.max_nodes:
        raise ApiError(413, f"N>{s.max_nodes} exceeds limit")
    if D > s.max_dim:
        raise ApiError(413, f"D>{s.max_dim} exceeds limit")
    if req.psi is not None and len(req.psi) != D:
        raise ApiError(400, "psi dimension mismatch")
    if req.gates is not None and len(req.gates) != N:
        raise ApiError(400, "gates length mismatch")
    if req.chain:
        if len(req.chain) < 2:
            raise ApiError(400, "chain must have >=2 nodes")
        if min(req.chain) < 0 or max(req.chain) >= N:
            raise ApiError(400, "chain indices out of bounds")

    profile_id, overrides = state.learners.propose_overrides(
        api_key,
        base={
            "lamG": req.params.lamG,
            "lamC": req.params.lamC,
            "lamQ": req.params.lamQ,
            "kneighbors": req.params.kneighbors,
        },
    )
    lamG = float(overrides.get("lamG", req.params.lamG))
    lamC = float(overrides.get("lamC", req.params.lamC))
    lamQ = float(overrides.get("lamQ", req.params.lamQ))
    k_req = int(overrides.get("kneighbors", req.params.kneighbors))
    k_eff = min(k_req, max(1, N - 1))
    # eff carries the REQUESTED k: it feeds the adaptive learner, and
    # recording the per-request N-clamped value would let one tiny-N
    # request promote kneighbors=2 into the key's profile permanently.
    # Every consumer (the lattice's init) re-clamps to its own N.
    eff = {"lamG": lamG, "lamC": lamC, "lamQ": lamQ, "kneighbors": k_req}
    return Y, N, D, k_eff, eff, profile_id


def _build_lattice(
    state: ServiceState, req: SettleRequest, api_key: Optional[str], pre=None
):
    """``pre`` is a prior _validate_and_overrides result: callers that
    already validated (to charge quota first) pass it to skip the duplicate
    Y conversion and the second learner/keystore read + RNG draw."""
    Y, N, D, k_eff, eff, profile_id = (
        pre if pre is not None else _validate_and_overrides(state, req, api_key)
    )
    lamG, lamC, lamQ = eff["lamG"], eff["lamC"], eff["lamQ"]

    if req.params.similarity not in {"auto", "exact", "fast", "fastest", "cluster"}:
        raise ApiError(
            422, "params.similarity must be auto|exact|fast|fastest|cluster"
        )
    # opt-in cross-request graph cache (OSCILLINK_GRAPH_CACHE_SIZE > 0):
    # long-lived corpus + churning queries is the dominant serving pattern,
    # and the graph build dominates the device-path E2E.  Keyed per api key
    # over every graph-determining input; a hit restores the device graph +
    # window plan and is behaviorally identical to a rebuild (same token ->
    # same signatures/receipts).  See service/graph_cache.py.
    cache_key = None
    if GraphCache.enabled():
        cache_key = graph_cache_key(
            # full=True: the sampled fingerprint is lossy above 128 MiB and
            # a collision here would silently serve a stale graph
            OscillinkLattice._hash_anchors(Y, full=True),
            k_eff,
            1.0,
            bool(req.params.deterministic_k),
            req.params.neighbor_seed,
            req.params.similarity,
            n=N,
            d=D,
        )
        snap = state.graph_cache.get_snapshot(api_key, cache_key)
        if snap is not None:
            lat = OscillinkLattice(
                Y,
                kneighbors=k_eff,
                lamG=lamG,
                lamC=lamC,
                lamQ=lamQ,
                deterministic_k=req.params.deterministic_k,
                neighbor_seed=req.params.neighbor_seed,
                similarity=req.params.similarity,
                _defer_graph=True,
                device=state.device,
            )
            lat._install_graph_snapshot(snap)
            lat._graph_cache_status = "HIT"
            state.metrics.graph_cache.labels(status="hit").inc()
            _finish_lattice_request_state(lat, req, N, D)
            return lat, N, D, k_eff, eff, profile_id
    lat = OscillinkLattice(
        Y,
        kneighbors=k_eff,
        lamG=lamG,
        lamC=lamC,
        lamQ=lamQ,
        deterministic_k=req.params.deterministic_k,
        neighbor_seed=req.params.neighbor_seed,
        similarity=req.params.similarity,
        device=state.device,
    )
    if cache_key is not None:
        state.graph_cache.put_snapshot(api_key, cache_key, lat._graph_snapshot())
        lat._graph_cache_status = "MISS"
        state.metrics.graph_cache.labels(status="miss").inc()
    _finish_lattice_request_state(lat, req, N, D)
    return lat, N, D, k_eff, eff, profile_id


def _finish_lattice_request_state(lat, req, N: int, D: int) -> None:
    """Per-request lattice state (query, gates, diffusion, chain, signing) —
    shared by the fresh-build and graph-cache-hit construction paths."""
    if req.psi is not None:
        psi = np.array(req.psi, dtype=np.float32)
        if psi.shape[0] != D:
            raise ApiError(400, "psi dimension mismatch")
        lat.set_query(psi)
    if req.gates is not None:
        gates = np.array(req.gates, dtype=np.float32)
        if gates.shape[0] != N:
            raise ApiError(400, "gates length mismatch")
        lat.set_gates(gates)
    if _diffusion_requested(req):
        _validate_diffusion(req)  # backstop; handlers validate pre-charge
        dopt = req.diffusion
        # derived over the lattice's own graph; psi omitted -> uniform gates
        # (zero sources min-max-normalize to the ones fallback)
        lat.diffusion_gates(
            beta=float(dopt.beta),
            gamma=float(dopt.gamma),
            tol=float(dopt.tol),
            max_iters=int(dopt.max_iters),
            apply=True,
        )
    if req.chain:
        if len(req.chain) < 2:
            raise ApiError(400, "chain must have >=2 nodes")
        lat.add_chain(req.chain, lamP=req.params.lamP)

    s_set = get_settings()
    if s_set.enable_signature and s_set.receipt_secret:
        lat.set_receipt_secret(s_set.receipt_secret)


def _charge(state: ServiceState, api_key: Optional[str], units: int):
    # peek-then-consume: a windowed-quota 429 must not permanently burn
    # monthly units (a client honoring Retry-After would otherwise drain
    # its whole month on rejected retries)
    state.monthly.peek(api_key, units, state.keystore)
    remaining, limit, reset_at, route = state.quota.check_and_consume(
        api_key, units, state.keystore
    )
    try:
        monthly_ctx = state.monthly.check_and_consume(api_key, units, state.keystore)
    except ApiError:
        # peek->consume isn't atomic across concurrent requests: if the
        # monthly cap was raced away between the two, refund the windowed
        # units this rejection would otherwise burn — back to the SAME
        # ledger this consume charged (route from check_and_consume)
        state.quota.refund(api_key, units, route=route)
        raise
    return monthly_ctx, remaining, limit, reset_at


def _usage_and_headers(resp, state, monthly_ctx, remaining, limit, reset_at, profile_id):
    for k, v in QuotaState.headers(remaining, limit, reset_at).items():
        resp.headers.setdefault(k, v)
    if monthly_ctx:
        resp.headers.setdefault("X-Monthly-Cap", str(monthly_ctx["limit"]))
        resp.headers.setdefault("X-Monthly-Used", str(monthly_ctx["used"]))
        resp.headers.setdefault("X-Monthly-Remaining", str(monthly_ctx["remaining"]))
        resp.headers.setdefault("X-Monthly-Period", str(monthly_ctx["period"]))
    resp.headers.setdefault("X-Profile-Id", profile_id)


# --------------------------------------------------------------------------
# handlers
# --------------------------------------------------------------------------


def h_health(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    return ApiResponse(body={"status": "ok", "version": __version__})


def h_license_status(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    """Licensed-container status from exported entitlements (main.py:840-884)."""
    ent_path = os.getenv(
        "OSCILLINK_ENTITLEMENTS_PATH", "/run/oscillink_entitlements.json"
    )
    try:
        leeway = int(os.getenv("OSCILLINK_JWT_LEEWAY", "300"))
    except ValueError:
        leeway = 300
    require = env_flag("OSCILLINK_LICENSE_REQUIRED")
    try:
        with open(ent_path, encoding="utf-8") as f:
            data = json.load(f)
    except Exception:
        if require:
            return ApiResponse(status=503, body={"status": "unlicensed"})
        return ApiResponse(body={"status": "unknown"})
    exp = data.get("exp") if isinstance(data.get("exp"), (int, float)) else None
    now = int(time.time())
    if exp is not None and (now - leeway) > int(exp):
        if require:
            return ApiResponse(status=503, body={"status": "expired", "exp": int(exp)})
        return ApiResponse(body={"status": "stale", "exp": int(exp)})
    return ApiResponse(
        body={
            "status": "ok",
            "iss": data.get("iss"),
            "sub": data.get("sub") or data.get("license_id"),
            "tier": data.get("tier"),
            "exp": int(exp) if exp is not None else None,
        }
    )


def h_openapi(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    """Serve the generated OpenAPI schema for this dispatcher."""
    from .openapi import build_schema

    try:
        return ApiResponse(body=build_schema())
    except Exception as e:
        raise ApiError(500, f"schema generation failed: {e}") from None


def h_metrics(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    admin_secret = os.getenv("OSCILLINK_METRICS_ADMIN_SECRET")
    if admin_secret and req.header("x-admin-secret") != admin_secret:
        raise ApiError(403, "metrics protected")
    payload = Metrics.render()
    if payload is None:
        return ApiResponse(body={"detail": "prometheus_client not installed"}, status=501)
    return ApiResponse(body=payload, content_type="text/plain; version=0.0.4")


def _settle_core(state: ServiceState, req: ApiRequest, include_receipt=None):
    ctx = _feature_context(state, req)
    _require_lattice_route()
    sreq = _parse(SettleRequest, req.json())
    _check_diffusion_allowed(
        sreq.gates is not None or _diffusion_requested(sreq), ctx["features"]
    )
    _validate_diffusion(sreq)

    # idempotent replay (opt-in, OSCILLINK_REPLAY_CACHE_TTL): an exact
    # retry within the TTL is answered without recompute / quota charge /
    # usage append — the work was already paid for.  Keyed AFTER auth so a
    # revoked key can never replay, and per api key so tenants are isolated.
    replay_sig = None
    if ReplayCache.ttl() > 0:
        endpoint = f"settle:{include_receipt}"
        replay_sig = ReplayCache.key(endpoint, req.body, ctx["api_key"])
        hit = state.replay_cache.get(ctx["api_key"], replay_sig)
        if hit is not None:
            body = json.loads(json.dumps(hit))  # defensive copy
            body.setdefault("meta", {})["request_id"] = (
                req.header(REQUEST_ID_HEADER) or ""
            )
            return ApiResponse(body=body, headers={"X-Replay-Cache": "hit"})

    Y_req, N, D, k_eff, eff, profile_id = _validate_and_overrides(
        state, sreq, ctx["api_key"]
    )
    units = N * D
    monthly_ctx, remaining, limit, reset_at = _charge(state, ctx["api_key"], units)

    t0 = time.perf_counter()
    try:
        lat, N, D, k_eff, eff, profile_id = _build_lattice(
            state, sreq, ctx["api_key"],
            pre=(Y_req, N, D, k_eff, eff, profile_id),
        )
        stats = lat.settle(
            dt=sreq.options.dt, max_iters=sreq.options.max_iters,
            tol=sreq.options.tol,
        )
        want_receipt = (
            sreq.options.include_receipt
            if include_receipt is None
            else include_receipt
        )
        receipt = lat.receipt() if want_receipt else None
        bundle = (
            lat.bundle(
                k=sreq.options.bundle_k,
                diversify=sreq.options.bundle_diversify,
            )
            if sreq.options.bundle_k
            else None
        )
        state_sig = (
            receipt.get("meta", {}).get("state_sig") if receipt else None
        ) or lat._signature()
        graph_cache_status = getattr(lat, "_graph_cache_status", None)
        state.metrics.settle_counter.labels(status="ok").inc()
    except ApiError:
        raise
    except Exception:
        state.metrics.settle_counter.labels(status="error").inc()
        raise
    elapsed = time.perf_counter() - t0
    t_settle = 1000.0 * elapsed
    state.metrics.settle_latency.observe(elapsed)
    state.metrics.n_gauge.set(N)
    state.metrics.d_gauge.set(D)
    state.metrics.usage_nodes.inc(N)
    state.metrics.usage_units.inc(units)

    state.learners.record_observation(
        ctx["api_key"],
        profile_id,
        eff,
        {
            "duration_ms": t_settle,
            "iters": int(stats.get("iters") or 0),
            "residual": float(stats.get("res") or 0.0),
            "tol": float(sreq.options.tol),
        },
    )
    monthly_block = (
        {
            "limit": monthly_ctx["limit"],
            "used": monthly_ctx["used"],
            "remaining": monthly_ctx["remaining"],
            "period": monthly_ctx["period"],
        }
        if monthly_ctx
        else None
    )
    body = {
        "state_sig": state_sig,
        "receipt": receipt,
        "bundle": bundle,
        "timings_ms": {"total_settle_ms": t_settle},
        "meta": {
            "N": N,
            "D": D,
            "kneighbors_requested": sreq.params.kneighbors,
            "kneighbors_effective": k_eff,
            "lam": {
                "G": eff["lamG"],
                "C": eff["lamC"],
                "Q": eff["lamQ"],
                "P": sreq.params.lamP,
            },
            "profile_id": profile_id,
            "backend": "device",
            "graph_cache": graph_cache_status,
            "diffusion": (
                {"beta": sreq.diffusion.beta, "gamma": sreq.diffusion.gamma}
                if _diffusion_requested(sreq)
                else None
            ),
            "request_id": req.header(REQUEST_ID_HEADER) or "",
            "usage": {"nodes": N, "node_dim_units": units, "monthly": monthly_block},
            "quota": None
            if limit == 0
            else {"limit": limit, "remaining": remaining, "reset": int(reset_at)},
        },
    }
    resp = ApiResponse(body=body)
    if replay_sig is not None:
        state.replay_cache.put(ctx["api_key"], replay_sig, body)
        resp.headers["X-Replay-Cache"] = "miss"
    _usage_and_headers(resp, state, monthly_ctx, remaining, limit, reset_at, profile_id)
    append_usage(
        {
            "ts": time.time(),
            "event": "settle",
            "api_key": ctx["api_key"],
            "N": N,
            "D": D,
            "units": units,
            "duration_ms": t_settle,
            "quota": body["meta"]["quota"],
            "monthly": monthly_block,
        }
    )
    return resp


def h_settle(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    return _settle_core(state, req)


def h_receipt(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    return _settle_core(state, req, include_receipt=True)


def h_bundle(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    """Bundle with per-key TTL-LRU cache + X-Cache headers (main.py:1261-1354)."""
    ctx = _feature_context(state, req)
    _require_lattice_route()
    breq = _parse(BundleRequest, req.json())
    _check_diffusion_allowed(
        breq.gates is not None or _diffusion_requested(breq), ctx["features"]
    )
    _validate_diffusion(breq)

    # validate (cheap) -> charge -> build: an over-quota client must not be
    # able to force the O(N^2 D) graph scan before its 429
    pre = _validate_and_overrides(state, breq, ctx["api_key"])
    N, D = pre[1], pre[2]
    units = N * D
    monthly_ctx, remaining, limit, reset_at = _charge(state, ctx["api_key"], units)
    lat, N, D, k_eff, eff, profile_id = _build_lattice(
        state, breq, ctx["api_key"], pre=pre
    )

    state_sig = lat._signature()
    cache_sig = _bundle_cache_sig(state_sig, breq)
    cached = state.bundle_cache.get(ctx["api_key"], cache_sig)
    if cached is not None:
        bundle = cached["bundle"]
        cache_status = "HIT"
        t_ms = 0.0
    else:
        t0 = time.perf_counter()
        stats = lat.settle(
            dt=breq.options.dt, max_iters=breq.options.max_iters, tol=breq.options.tol
        )
        bundle = lat.bundle(
            k=breq.bundle_k, alpha=breq.alpha, diversify=breq.diversify
        )
        t_ms = 1000.0 * (time.perf_counter() - t0)
        state.metrics.settle_counter.labels(status="ok").inc()
        state.metrics.settle_latency.observe(t_ms / 1000.0)
        state.bundle_cache.put(ctx["api_key"], cache_sig, bundle)
        cache_status = "MISS"
        state.learners.record_observation(
            ctx["api_key"],
            profile_id,
            eff,
            {
                "duration_ms": t_ms,
                "iters": int(stats.get("iters") or 0),
                "residual": float(stats.get("res") or 0.0),
                "tol": float(breq.options.tol),
            },
        )
    resp = ApiResponse(
        body={
            "state_sig": state_sig,
            "bundle": bundle,
            "timings_ms": {"total_ms": t_ms},
            "meta": {"N": N, "D": D, "kneighbors_effective": k_eff, "cache": cache_status},
        },
        headers={"X-Cache": cache_status, "X-Cache-Key": state_sig[:16]},
    )
    _usage_and_headers(resp, state, monthly_ctx, remaining, limit, reset_at, profile_id)
    return resp


def h_chain_receipt(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    ctx = _feature_context(state, req)
    _require_lattice_route()
    creq = _parse(ChainReceiptRequest, req.json())
    if not creq.chain or len(creq.chain) < 2:
        raise ApiError(400, "chain must have >=2 nodes")
    _check_diffusion_allowed(
        creq.gates is not None or _diffusion_requested(creq), ctx["features"]
    )
    _validate_diffusion(creq)

    pre = _validate_and_overrides(state, creq, ctx["api_key"])
    units = pre[1] * pre[2]
    monthly_ctx, remaining, limit, reset_at = _charge(state, ctx["api_key"], units)
    lat, N, D, k_eff, eff, profile_id = _build_lattice(
        state, creq, ctx["api_key"], pre=pre
    )
    t0 = time.perf_counter()
    lat.settle(dt=creq.options.dt, max_iters=creq.options.max_iters, tol=creq.options.tol)
    chain_rec = lat.chain_receipt(creq.chain, z_th=creq.z_th)
    t_ms = 1000.0 * (time.perf_counter() - t0)
    resp = ApiResponse(
        body={
            "state_sig": lat._signature(),
            "chain_receipt": chain_rec,
            "timings_ms": {"total_ms": t_ms},
            "meta": {"N": N, "D": D, "kneighbors_effective": k_eff},
        }
    )
    _usage_and_headers(resp, state, monthly_ctx, remaining, limit, reset_at, profile_id)
    return resp


def h_settle_batch(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    """One corpus, Q queries: vmapped stationary solves + per-query bundles.

    Units charged: N * D * Q (each query is a full solve)."""
    ctx = _feature_context(state, req)
    _require_lattice_route()
    breq = _parse(BatchSettleRequest, req.json())
    _check_diffusion_allowed(
        breq.gates_batch is not None or _diffusion_requested(breq),
        ctx["features"],
    )
    if _diffusion_requested(breq):
        if breq.gates_batch is not None:
            raise ApiError(
                422,
                "provide either gates_batch or a diffusion block, not both",
            )
        _validate_diffusion(breq)
    Y = _np_array_or_400(breq.Y, "Y")
    if Y.ndim != 2 or Y.shape[0] == 0 or Y.shape[1] == 0:
        raise ApiError(400, "Empty matrix")
    N, D = Y.shape
    s = get_settings()
    if N > s.max_nodes:
        raise ApiError(413, f"N>{s.max_nodes} exceeds limit")
    if D > s.max_dim:
        raise ApiError(413, f"D>{s.max_dim} exceeds limit")
    psis = _np_array_or_400(breq.psis, "psis")
    if psis.ndim != 2 or psis.shape[1] != D:
        raise ApiError(400, "psis must be [Q, D]")
    Q = psis.shape[0]
    if Q == 0 or Q > 256:
        raise ApiError(400, "Q must be in [1, 256]")
    gates = None
    if breq.gates_batch is not None:
        gates = np.array(breq.gates_batch, dtype=np.float32)
        if gates.shape != (Q, N):
            raise ApiError(400, "gates_batch must be [Q, N]")

    units = N * D * Q
    monthly_ctx, remaining, limit, reset_at = _charge(state, ctx["api_key"], units)

    k_eff = min(int(breq.params.kneighbors), max(1, N - 1))
    if breq.params.similarity not in {"auto", "exact", "fast", "fastest", "cluster"}:
        raise ApiError(
            422, "params.similarity must be auto|exact|fast|fastest|cluster"
        )
    t0 = time.perf_counter()
    lat = OscillinkLattice(
        Y,
        kneighbors=k_eff,
        lamG=breq.params.lamG,
        lamC=breq.params.lamC,
        lamQ=breq.params.lamQ,
        deterministic_k=breq.params.deterministic_k,
        neighbor_seed=breq.params.neighbor_seed,
        similarity=breq.params.similarity,
        device=state.device,
    )
    if _diffusion_requested(breq):
        # Q screened-Poisson solves over the one shared graph, vmapped —
        # the per-query semantics of the single-settle diffusion block
        dopt = breq.diffusion
        gates = lat.diffusion_gates_batch(
            psis,
            beta=float(dopt.beta),
            gamma=float(dopt.gamma),
            tol=float(dopt.tol),
            max_iters=int(dopt.max_iters),
        )
    bundles = lat.bundle_batch(psis, gates=gates, k=breq.bundle_k, alpha=breq.alpha)
    t_ms = 1000.0 * (time.perf_counter() - t0)
    state.metrics.usage_units.inc(units)
    resp = ApiResponse(
        body={
            "queries": Q,
            "bundles": bundles,
            "timings_ms": {"total_ms": t_ms, "per_query_ms": t_ms / Q},
            "meta": {
                "N": N,
                "D": D,
                "kneighbors_effective": k_eff,
                "diffusion": (
                    {"beta": breq.diffusion.beta, "gamma": breq.diffusion.gamma}
                    if _diffusion_requested(breq)
                    else None
                ),
            },
        }
    )
    _usage_and_headers(resp, state, monthly_ctx, remaining, limit, reset_at, "baseline")
    return resp


def h_bundle_ragged(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    """Many different-size corpora settled + bundled in ONE padded vmapped
    device program (models/ragged.py).  Bundles are identical to serving
    each corpus alone.  Units charged: sum(N_i * D)."""
    from ..models.ragged import bundle_ragged

    ctx = _feature_context(state, req)
    rreq = _parse(RaggedBundleRequest, req.json())
    if _diffusion_requested(rreq):
        raise ApiError(
            422,
            "diffusion block not supported on the ragged endpoint; "
            "precompute gates and pass them per corpus",
        )
    if not rreq.corpora:
        raise ApiError(400, "corpora must be non-empty")
    if len(rreq.corpora) > 64:
        raise ApiError(400, "at most 64 corpora per request")
    if len(rreq.psis) != len(rreq.corpora):
        raise ApiError(400, "psis must match corpora")
    s = get_settings()
    ns, d0 = [], None
    for c in rreq.corpora:
        if not c or not c[0]:
            raise ApiError(400, "empty corpus")
        n_i, d_i = len(c), len(c[0])
        if d0 is None:
            d0 = d_i
        elif d_i != d0:
            raise ApiError(400, "all corpora must share D")
        if n_i > s.max_nodes:
            raise ApiError(413, f"N>{s.max_nodes} exceeds limit")
        if d_i > s.max_dim:
            raise ApiError(413, f"D>{s.max_dim} exceeds limit")
        ns.append(n_i)
    for p in rreq.psis:
        if len(p) != d0:
            raise ApiError(400, "psi dimension mismatch")
    if rreq.gates is not None:
        if len(rreq.gates) != len(rreq.corpora):
            raise ApiError(400, "gates must match corpora")
        for g, n_i in zip(rreq.gates, ns):
            if g is not None and len(g) != n_i:
                raise ApiError(400, "gates length mismatch")
    # convert BEFORE charging: a ragged inner list passes pydantic but
    # fails np.array — that is a 400, and it must not consume units
    corpora_np = [_np_array_or_400(c, "corpus") for c in rreq.corpora]
    psis_np = [_np_array_or_400(p, "psi") for p in rreq.psis]
    gates_np = (
        None
        if rreq.gates is None
        else [None if g is None else _np_array_or_400(g, "gates") for g in rreq.gates]
    )
    units = sum(ns) * int(d0 or 0)
    monthly_ctx, remaining, limit, reset_at = _charge(state, ctx["api_key"], units)

    t0 = time.perf_counter()
    results = bundle_ragged(
        corpora_np,
        psis_np,
        gates_np,
        kneighbors=rreq.params.kneighbors,
        lamG=rreq.params.lamG,
        lamC=rreq.params.lamC,
        lamQ=rreq.params.lamQ,
        bundle_k=rreq.bundle_k,
        alpha=rreq.alpha,
        dt=rreq.options.dt,
        tol=rreq.options.tol,
        max_iters=rreq.options.max_iters,
        device=state.device,
    )
    t_ms = 1000.0 * (time.perf_counter() - t0)
    # the JAX service's result keys: the port's bundle_ragged also reports
    # each corpus's U* solve, which the response does not carry
    results = [
        {key: val for key, val in r.items() if key not in ("ustar_iters", "ustar_res")}
        for r in results
    ]
    state.metrics.usage_units.inc(units)
    resp = ApiResponse(
        body={
            "corpora": len(ns),
            "results": results,
            "timings_ms": {"total_ms": t_ms, "per_corpus_ms": t_ms / len(ns)},
            "meta": {"Ns": ns, "D": d0, "padded_N": max(ns)},
        }
    )
    _usage_and_headers(resp, state, monthly_ctx, remaining, limit, reset_at, "baseline")
    return resp


def h_autocorrect(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    _feature_context(state, req)
    areq = _parse(AutoCorrectRequest, req.json())
    corrected = smart_correct(areq.text, custom_preserve=areq.preserve)
    # smart_correct normalizes line endings (reference parity: splitlines +
    # '\n'.join); compare against the same normalization so a trailing
    # newline alone doesn't report changed=True with zero corrections
    normalized = "\n".join(areq.text.splitlines())
    return ApiResponse(
        body={"text": corrected, "changed": corrected != normalized}
    )


# -- jobs (reference cloud/app/jobs.py:74-247) ------------------------------


def h_jobs_submit(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    ctx = _feature_context(state, req)
    _require_lattice_route()
    if not ctx["features"].get("async_jobs", True):
        raise ApiError(403, "async jobs not enabled for this tier")
    payload = req.json()
    sreq = _parse(SettleRequest, payload)
    # the same gate/validation the sync settle applies — otherwise a job is
    # a tier-gate bypass for diffusion, and malformed blocks would burn
    # execution-time quota before failing
    _check_diffusion_allowed(
        sreq.gates is not None or _diffusion_requested(sreq), ctx["features"]
    )
    _validate_diffusion(sreq)
    api_key = ctx["api_key"]

    def run() -> dict:
        # quota charged at execution time (jobs.py:81-94)
        Y_req, N, D, k_eff, eff, profile_id = _validate_and_overrides(
            state, sreq, api_key
        )
        units = N * D
        _charge(state, api_key, units)
        lat, N, D, k_eff, eff, profile_id = _build_lattice(
            state, sreq, api_key, pre=(Y_req, N, D, k_eff, eff, profile_id)
        )
        stats = lat.settle(
            dt=sreq.options.dt,
            max_iters=sreq.options.max_iters,
            tol=sreq.options.tol,
        )
        out: dict[str, Any] = {
            "state_sig": lat._signature(),
            "backend": "device",
            "settle": {
                "iters": int(stats.get("iters") or 0),
                "res": float(stats.get("res") or 0.0),
            },
        }
        if sreq.options.include_receipt:
            out["receipt"] = lat.receipt()
        if sreq.options.bundle_k:
            out["bundle"] = lat.bundle(
                k=sreq.options.bundle_k,
                diversify=sreq.options.bundle_diversify,
            )
        return out

    rec = state.jobs.submit(
        run,
        meta={"api_key": api_key},
        priority=bool(ctx["features"].get("priority_queue")),
    )
    state.metrics.job_queue_depth.set(state.jobs.depth())
    return ApiResponse(status=202, body={"job_id": rec["id"], "status": rec["status"]})


def _job_for_caller(state: ServiceState, req: ApiRequest, job_id: str):
    """404 unless the job exists AND belongs to the caller's key — a job id
    must not let one tenant read or cancel another tenant's job (uuid
    unguessability is not an authorization model)."""
    ctx = _feature_context(state, req)
    job = state.jobs.get(job_id)
    if job is None or job.get("api_key") != ctx["api_key"]:
        raise ApiError(404, "job not found")
    return job


def h_jobs_get(state: ServiceState, req: ApiRequest, job_id: str = "", **_) -> ApiResponse:
    job = _job_for_caller(state, req, job_id)
    body = {k: v for k, v in job.items() if k != "api_key"}
    return ApiResponse(body=body)


def h_jobs_delete(state: ServiceState, req: ApiRequest, job_id: str = "", **_) -> ApiResponse:
    _job_for_caller(state, req, job_id)
    job = state.jobs.cancel(job_id)
    if job is None:
        raise ApiError(404, "job not found")
    return ApiResponse(body={"job_id": job_id, "status": job["status"]})


# -- competitor benchmark (reference cloud/app/benchmarks.py:210-353) -------


def _topk_f1_hall(pred, labels, traps):
    if labels is None:
        if traps is None:
            return None, None
        return None, any(i in traps for i in pred)
    gt = {i for i, lab in enumerate(labels) if int(lab) == 1}
    tp = len([i for i in pred if i in gt])
    fp = len([i for i in pred if i not in gt])
    fn = len([i for i in gt if i not in pred])
    prec = tp / (tp + fp) if (tp + fp) else 0.0
    rec = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = 0.0 if (prec == 0.0 and rec == 0.0) else 2 * prec * rec / (prec + rec)
    hall = any(i in traps for i in pred) if traps is not None else None
    return f1, hall


def h_bench_competitor(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    from ..adapters.text import embed_texts

    _feature_context(state, req)
    breq = _parse(CompetitorBenchRequest, req.json())
    texts = breq.texts
    if not texts:
        raise ApiError(400, "texts must be non-empty")
    if breq.smart_correct:
        texts = [smart_correct(t) for t in texts]
    Y = embed_texts(texts).astype(np.float32)
    if breq.query is not None:
        psi = embed_texts([breq.query])[0].astype(np.float32)
        q_idx = None
    else:
        q_idx = breq.query_index if breq.query_index is not None else 0
        q_idx = max(0, min(q_idx, len(texts) - 1))
        psi = Y[q_idx]

    k = min(breq.k, len(texts))
    # cosine baseline
    Yn = Y / (np.linalg.norm(Y, axis=1, keepdims=True) + 1e-9)
    pn = psi / (np.linalg.norm(psi) + 1e-9)
    t0 = time.perf_counter()
    scores = Yn @ pn
    if q_idx is not None:
        scores[q_idx] = -1e9
    cos_pred = np.argsort(-scores)[:k].tolist()
    cos_ms = 1000.0 * (time.perf_counter() - t0)
    cos_f1, cos_hall = _topk_f1_hall(cos_pred, breq.labels, breq.traps)

    # oscillink default
    k_eff = min(breq.kneighbors, max(1, len(texts) - 1))
    t1 = time.perf_counter()
    lat = OscillinkLattice(
        Y, kneighbors=k_eff, lamG=breq.lamG, lamC=breq.lamC, lamQ=breq.lamQ,
        deterministic_k=True, device=state.device,
    )
    lat.set_query(psi)
    lat.settle(max_iters=12, tol=1e-3)
    # mask the query document like the cosine baseline does — otherwise
    # the two systems are scored on different candidate sets (the bundle
    # could claim the query itself as a free true positive)
    picks = lat.bundle(k=k + (1 if q_idx is not None else 0))
    osc_pred = [int(e["id"]) for e in picks if int(e["id"]) != q_idx][:k]
    osc_ms = 1000.0 * (time.perf_counter() - t1)
    osc_f1, osc_hall = _topk_f1_hall(osc_pred, breq.labels, breq.traps)

    result: dict[str, Any] = {
        "n": len(texts),
        "k": k,
        "cosine": {"pred": cos_pred, "ms": cos_ms, "f1": cos_f1, "hallucinated": cos_hall},
        "oscillink": {"pred": osc_pred, "ms": osc_ms, "f1": osc_f1, "hallucinated": osc_hall},
    }

    if breq.tune and breq.labels is not None:
        best = None
        for cs in (0.6, 1.0, 1.4):
            for qs in (0.5, 1.0, 1.5):
                lat_t = OscillinkLattice(
                    Y,
                    kneighbors=k_eff,
                    lamG=breq.lamG,
                    lamC=max(0.1, breq.lamC * cs),
                    lamQ=max(0.5, breq.lamQ * qs),
                    deterministic_k=True,
                    device=state.device,
                )
                lat_t.set_query(psi)
                lat_t.settle(max_iters=12, tol=1e-3)
                picks_t = lat_t.bundle(k=k + (1 if q_idx is not None else 0))
                pred_t = [
                    int(e["id"]) for e in picks_t if int(e["id"]) != q_idx
                ][:k]
                f1_t, hall_t = _topk_f1_hall(pred_t, breq.labels, breq.traps)
                cand = {
                    "lamC": max(0.1, breq.lamC * cs),
                    "lamQ": max(0.5, breq.lamQ * qs),
                    "f1": f1_t,
                    "hallucinated": hall_t,
                    "pred": pred_t,
                }
                if best is None or (f1_t or 0.0) > (best["f1"] or 0.0):
                    best = cand
        result["oscillink_tuned"] = best
    return ApiResponse(body=result)


# -- stripe webhook + billing/CLI pairing ------------------------------------


def h_stripe_webhook(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    try:
        out = state.webhooks.process(req.body, req.header("stripe-signature"))
        state.metrics.webhook_events.labels(outcome=out.get("status", "ok")).inc()
        return ApiResponse(body=out)
    except ApiError:
        state.metrics.webhook_events.labels(outcome="rejected").inc()
        raise


def h_billing_cli_start(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    """Create a CLI pairing session; returns the poll code and (when Stripe is
    configured) a checkout URL (main.py:1499-1568)."""
    payload = req.json() if req.body else {}
    rec = state.cli_sessions.create(metadata=payload if isinstance(payload, dict) else {})
    checkout_url = None
    if os.getenv("OSCILLINK_STRIPE_SECRET_KEY"):
        checkout_url = f"https://checkout.stripe.com/pay/session-for-{rec['code']}"
    return ApiResponse(
        body={"code": rec["code"], "status": rec["status"], "checkout_url": checkout_url}
    )


def h_billing_cli_poll(state: ServiceState, req: ApiRequest, code: str = "", **_) -> ApiResponse:
    rec = state.cli_sessions.get(code)
    if rec is None:
        raise ApiError(404, "unknown session code")
    body = {"code": code, "status": rec["status"]}
    if rec["status"] == "complete":
        body["api_key"] = rec["api_key"]
    return ApiResponse(body=body)


def h_billing_success(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    """Payment Link landing page.

    With ?session_id={CHECKOUT_SESSION_ID} (the redirect target
    scripts/stripe_payment_link.py configures), shows the API key the
    webhook provisioned for that checkout — reference
    docs/cloud/DEPLOY_STRIPE_CLOUD.md's self-serve onboarding, served from
    the webhook-recorded mapping instead of a live Stripe fetch.  Without a
    session id (CLI pairing flow) it stays a static confirmation page.
    """
    import html as _html

    session_id = (req.query.get("session_id") or "").strip()
    if session_id:
        rec = state.webhooks.lookup_checkout(session_id)
        if rec is None:
            # Stripe's browser redirect can arrive before its webhook does;
            # tell the user to refresh rather than implying failure.
            body = (
                "<html><body><h1>Payment received</h1>"
                "<p>Your API key is still being provisioned &mdash; refresh "
                "this page in a few seconds.</p></body></html>"
            )
            return ApiResponse(body=body.encode(), content_type="text/html")
        key = _html.escape(str(rec.get("api_key", "")))
        tier = _html.escape(str(rec.get("tier", "")))
        note = (
            "<p>This key is pending manual activation; you will be contacted "
            "shortly.</p>"
            if rec.get("key_status") == "pending"
            else ""
        )
        body = (
            "<html><body><h1>Payment complete</h1>"
            f"<p>Your <b>{tier}</b> API key:</p><pre><code>{key}</code></pre>"
            "<p>Store it now &mdash; this page expires in 24 hours.</p>"
            f"{note}</body></html>"
        )
        return ApiResponse(body=body.encode(), content_type="text/html")
    html = (
        "<html><body><h1>Payment complete</h1>"
        "<p>You can close this window and return to the CLI.</p></body></html>"
    )
    return ApiResponse(body=html.encode(), content_type="text/html")


def h_billing_portal(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    if not os.getenv("OSCILLINK_STRIPE_SECRET_KEY"):
        raise ApiError(503, "billing portal not configured")
    key = _api_key_guard(state, req)
    if key is None:
        raise ApiError(401, "API key required for portal access")
    return ApiResponse(body={"url": f"https://billing.stripe.com/portal-for-{key[:8]}"})


# -- admin (reference cloud/app/admin.py:15-266) ----------------------------


def _admin_guard(req: ApiRequest) -> None:
    secret = os.getenv("OSCILLINK_ADMIN_SECRET")
    if not secret:
        raise ApiError(503, "admin API not configured")
    if req.header("x-admin-secret") != secret:
        raise ApiError(403, "invalid admin secret")


def h_admin_get_key(state: ServiceState, req: ApiRequest, api_key: str = "", **_) -> ApiResponse:
    _admin_guard(req)
    meta = state.keystore.get(api_key)
    if meta is None:
        raise ApiError(404, "key not found")
    return ApiResponse(body=meta.to_dict())


def h_admin_put_key(state: ServiceState, req: ApiRequest, api_key: str = "", **_) -> ApiResponse:
    _admin_guard(req)
    upd = _parse(AdminKeyUpdate, req.json())
    # explicit JSON null = clear the override back to the global default
    # (None-omitted fields stay unchanged; keystore.update skips Nones)
    clear = [
        f
        for f in ("quota_limit_units", "quota_window_seconds", "features")
        if f in upd.model_fields_set and getattr(upd, f) is None
    ]
    meta = state.keystore.update(
        api_key,
        create=True,
        clear=clear,
        tier=upd.tier,
        status=upd.status,
        quota_limit_units=upd.quota_limit_units,
        quota_window_seconds=upd.quota_window_seconds,
        features=upd.features,
    )
    assert meta is not None
    return ApiResponse(body=meta.to_dict())


def h_admin_webhook_events(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    """Webhook-event introspection with pagination + filtering (reference
    checklist item 'Pagination & filtering for admin webhook events',
    unchecked upstream): ?limit=&offset=&type=&since= (epoch seconds)."""
    _admin_guard(req)
    events = state.webhooks.events()
    etype = (req.query.get("type") or "").strip()
    if etype:
        events = [e for e in events if e.get("type") == etype]
    since = req.query.get("since")
    if since:
        try:
            ts = float(since)
            events = [e for e in events if float(e.get("processed_at", 0)) >= ts]
        except ValueError:
            raise ApiError(422, "since must be an epoch timestamp") from None
    total = len(events)
    try:
        offset = max(0, int(req.query.get("offset", "0")))
        limit = int(req.query.get("limit", "100"))
    except ValueError:
        raise ApiError(422, "limit/offset must be integers") from None
    limit = max(1, min(limit, 1000))
    page = events[offset : offset + limit]
    return ApiResponse(
        body={"events": page, "total": total, "offset": offset, "limit": limit}
    )


def h_admin_price_map(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    _admin_guard(req)
    return ApiResponse(
        body={
            "price_map": price_map(),
            "tiers": {
                name: {"monthly_unit_cap": t.monthly_unit_cap, "description": t.description}
                for name, t in TIERS.items()
            },
        }
    )


def h_admin_usage(state: ServiceState, req: ApiRequest, api_key: str = "", **_) -> ApiResponse:
    _admin_guard(req)
    return ApiResponse(
        body={
            "api_key": api_key,
            "quota_window": state.quota.snapshot(api_key),
            "monthly": state.monthly.snapshot(api_key),
        }
    )


def h_admin_usage_records(
    state: ServiceState, req: ApiRequest, api_key: str = "", **_
) -> ApiResponse:
    """Signed usage receipts export (reference checklist item: 'Signed
    usage receipts endpoint + verification helper', unchecked upstream):
    the key's recent usage JSONL records, each carrying its per-line HMAC
    when OSCILLINK_USAGE_SIGNING_SECRET is set; ?verify=1 re-checks every
    signature server-side and reports the count."""
    from .usage import read_usage_records, verify_usage_line

    _admin_guard(req)
    try:
        limit = max(1, min(int(req.query.get("limit", "100")), 10_000))
    except ValueError:
        raise ApiError(422, "limit must be an integer") from None
    records = read_usage_records(api_key=api_key, limit=limit)
    body: dict = {"api_key": api_key, "records": records, "count": len(records)}
    if req.query.get("verify") in {"1", "true"}:
        secret = os.getenv("OSCILLINK_USAGE_SIGNING_SECRET")
        if not secret:
            raise ApiError(409, "OSCILLINK_USAGE_SIGNING_SECRET not configured")
        body["verified"] = sum(
            1 for r in records if verify_usage_line(r, secret)
        )
        body["unverified"] = len(records) - body["verified"]
    return ApiResponse(body=body)


def h_admin_cancel(state: ServiceState, req: ApiRequest, api_key: str = "", **_) -> ApiResponse:
    _admin_guard(req)
    meta = state.keystore.get(api_key)
    if meta is None:
        raise ApiError(404, "key not found")
    state.keystore.update(api_key, status="revoked")
    return ApiResponse(body={"api_key": api_key, "status": "revoked"})


def h_admin_introspect(state: ServiceState, req: ApiRequest, **_) -> ApiResponse:
    _admin_guard(req)
    s = get_settings()
    key = req.query.get("api_key")
    meta = state.keystore.get(key) if key else None
    feats = resolve_features(meta)
    return ApiResponse(
        body={
            "limits": {"max_nodes": s.max_nodes, "max_dim": s.max_dim},
            "tier": feats.get("tier"),
            "features": dict(feats),
            "monthly_cap": tier_info(meta.tier if meta else None).monthly_unit_cap,
            "license_required": env_flag("OSCILLINK_LICENSE_REQUIRED"),
            # cache occupancy (counts only, no key material): the graph
            # cache's entries pin device memory, so operators need to see
            # what the global bound is actually holding
            "caches": {
                "graph": {
                    "enabled": state.graph_cache.enabled(),
                    "bound": state.graph_cache.global_bound(),
                    "ttl_s": state.graph_cache.ttl(),
                    **state.graph_cache.stats(),
                },
                "bundle": {
                    "ttl_s": state.bundle_cache.ttl(),
                    **state.bundle_cache.stats(),
                },
                "replay": {
                    "ttl_s": state.replay_cache.ttl(),
                    **state.replay_cache.stats(),
                },
            },
        }
    )


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

Handler = Callable[..., ApiResponse]

_ROUTES: list[tuple[str, re.Pattern, Handler]] = []


def _route(method: str, pattern: str, handler: Handler) -> None:
    regex = re.compile(
        "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
    )
    _ROUTES.append((method, regex, handler))


_route("GET", "/health", h_health)
_route("GET", "/license/status", h_license_status)
_route("GET", "/metrics", h_metrics)
_route("GET", "/openapi.json", h_openapi)
_route("POST", "/v1/settle", h_settle)
_route("POST", "/v1/receipt", h_receipt)
_route("POST", "/v1/bundle", h_bundle)
_route("POST", "/v1/chain/receipt", h_chain_receipt)
_route("POST", "/v1/settle/batch", h_settle_batch)
_route("POST", "/v1/bundle/ragged", h_bundle_ragged)
_route("POST", "/v1/autocorrect", h_autocorrect)
_route("POST", "/v1/bench/competitor", h_bench_competitor)
_route("POST", "/v1/jobs/settle", h_jobs_submit)
_route("GET", "/v1/jobs/{job_id}", h_jobs_get)
_route("DELETE", "/v1/jobs/{job_id}", h_jobs_delete)
_route("POST", "/stripe/webhook", h_stripe_webhook)
_route("POST", "/billing/cli/start", h_billing_cli_start)
_route("GET", "/billing/cli/poll/{code}", h_billing_cli_poll)
_route("GET", "/billing/success", h_billing_success)
_route("POST", "/billing/portal", h_billing_portal)
_route("GET", "/admin/keys/{api_key}", h_admin_get_key)
_route("PUT", "/admin/keys/{api_key}", h_admin_put_key)
_route("GET", "/admin/webhook/events", h_admin_webhook_events)
_route("GET", "/admin/billing/price-map", h_admin_price_map)
_route("GET", "/admin/usage/{api_key}", h_admin_usage)
_route("GET", "/admin/usage/{api_key}/records", h_admin_usage_records)
_route("POST", "/admin/billing/cancel/{api_key}", h_admin_cancel)
_route("GET", "/admin/introspect", h_admin_introspect)


def handle(state: ServiceState, req: ApiRequest) -> ApiResponse:
    """Dispatch one request through governance + routing; never raises."""
    rid = req.header(REQUEST_ID_HEADER) or uuid.uuid4().hex
    try:
        state.rate_limiter.check_ip(req.remote_ip)
        state.rate_limiter.check_global()
        for method, regex, handler in _ROUTES:
            if method != req.method.upper():
                continue
            m = regex.match(req.path)
            if m:
                resp = handler(state, req, **m.groupdict())
                break
        else:
            resp = ApiResponse(status=404, body={"detail": "not found"})
    except ApiError as e:
        if e.kind:
            state.metrics.rejections.labels(kind=e.kind).inc()
        resp = ApiResponse(status=e.status, body={"detail": e.detail}, headers=dict(e.headers))
    except Exception as e:  # pragma: no cover — defense in depth
        resp = ApiResponse(status=500, body={"detail": f"internal error: {e}"})
    # security headers + request id (reference main.py:386-405)
    resp.headers.setdefault(REQUEST_ID_HEADER, rid)
    resp.headers.setdefault("X-Content-Type-Options", "nosniff")
    resp.headers.setdefault("X-Frame-Options", "DENY")
    resp.headers.setdefault("Referrer-Policy", "no-referrer")
    return resp
