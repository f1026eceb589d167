"""Quotas, monthly caps, and rate limits (reference cloud/app/main.py:186-383,
576-699).

All counters are in-process by default; when OSCILLINK_STATE_BACKEND=redis
the rate limiters ride Redis fixed-window counters (reference
main.py:512,588,652 via redis_backend.incr_with_window) so limits are
shared across instances, falling back to the in-memory buckets when the
server is unreachable.  Thread-safe: the sync request handlers and the
async-jobs worker thread charge the same objects concurrently.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from .billing import tier_info
from .config import get_ip_rate_limit, get_quota_config, get_rate_limit
from .keystore import KeyMetadata, KeyStore

__all__ = [
    "ApiError",
    "QuotaState",
    "RateLimiter",
    "MonthlyUsage",
    "current_period",
]


class ApiError(Exception):
    """HTTP-mappable error raised by governance / handlers.

    ``kind`` tags governance rejections (quota_window / monthly_cap /
    payload / rate_limit) for the rejection counter; None for ordinary
    request errors."""

    def __init__(self, status: int, detail: str, headers: Optional[dict] = None,
                 kind: Optional[str] = None):
        super().__init__(detail)
        self.status = status
        self.detail = detail
        self.headers = headers or {}
        self.kind = kind


def current_period() -> str:
    """Billing period key: UTC year-month."""
    return time.strftime("%Y-%m", time.gmtime())


@dataclass
class _Window:
    window_start: float
    used: float
    limit: int
    window: int


class QuotaState:
    """Per-key sliding-window N*D-unit quota (main.py:323-373)."""

    def __init__(self) -> None:
        self._usage: Dict[str, _Window] = {}
        self._lock = threading.Lock()

    def check_and_consume(
        self, key: Optional[str], units: int, keystore: KeyStore
    ) -> tuple[int, int, float, str]:
        """Returns (remaining, limit, reset_epoch, route); (-1, 0, 0, "none")
        when disabled.  ``route`` says where THIS consume landed ("redis" or
        "memory") so a later rejection's refund goes back to the same
        ledger — routing by the key's history misrefunds when Redis flaps
        between two requests."""
        q = get_quota_config()
        q_limit, q_window = q.limit, q.window
        if key:
            meta: Optional[KeyMetadata] = keystore.get(key)
            if meta:
                if meta.quota_limit_units is not None:
                    q_limit = int(meta.quota_limit_units)
                if meta.quota_window_seconds is not None:
                    q_window = int(meta.quota_window_seconds)
        if q_limit <= 0 or key is None:
            return -1, 0, 0, "none"
        if units > q_limit:
            raise ApiError(
                413, f"request units {units} exceed per-key limit {q_limit}",
                kind="payload",
            )
        # shared windows when OSCILLINK_STATE_BACKEND=redis (reference
        # readiness-checklist item "Redis backend for quota", unchecked
        # upstream): INCRBY-consume, DECRBY-refund on rejection, window =
        # key TTL — so horizontally-scaled replicas enforce ONE budget.
        # Any Redis failure falls through to the in-memory window.
        from .redis_backend import get_redis_state

        rs = get_redis_state()
        if rs is not None:
            rkey = f"osc:quota:{key}"
            res = rs.incrby_with_window(rkey, units, q_window)
            if res is not None:
                used_after, ttl = res
                now = time.time()
                reset_at = now + max(ttl, 0)
                if used_after > q_limit:
                    rs.decrby(rkey, units)  # this consume never happened
                    raise ApiError(
                        429,
                        "quota exceeded",
                        headers={
                            "Retry-After": str(int(max(ttl, 0)) + 1),
                            "X-Quota-Limit": str(q_limit),
                            "X-Quota-Remaining": "0",
                            "X-Quota-Reset": str(int(reset_at)),
                        },
                        kind="quota_window",
                    )
                return q_limit - used_after, q_limit, reset_at, "redis"

        with self._lock:
            now = time.time()
            rec = self._usage.get(key)
            if rec is None or now - rec.window_start >= rec.window:
                rec = _Window(
                    window_start=now, used=0.0, limit=q_limit, window=q_window
                )
                self._usage[key] = rec
            elif rec.limit != q_limit or rec.window != q_window:
                # config/override change mid-window: adopt the new limits but
                # KEEP consumption — resetting used=0 would grant a full
                # fresh window exactly when an operator tries to tighten
                rec.limit, rec.window = q_limit, q_window
            if rec.used + units > q_limit:
                reset_at = rec.window_start + q_window
                raise ApiError(
                    429,
                    "quota exceeded",
                    headers={
                        "Retry-After": str(int(reset_at - now) + 1),
                        "X-Quota-Limit": str(q_limit),
                        "X-Quota-Remaining": "0",
                        "X-Quota-Reset": str(int(reset_at)),
                    },
                    kind="quota_window",
                )
            rec.used += units
            remaining = q_limit - int(rec.used)
            return remaining, q_limit, rec.window_start + q_window, "memory"

    def refund(self, key: Optional[str], units: int, route: str = "memory") -> None:
        """Return units consumed for a request that was then rejected by a
        later check (the peek/consume pair around the monthly cap is not
        atomic under concurrency).  ``route`` must be the value returned by
        the check_and_consume that charged these units."""
        if key is None or route == "none":
            return
        if route == "redis":
            from .redis_backend import get_redis_state

            rs = get_redis_state()
            if rs is not None and rs.decrby(f"osc:quota:{key}", units):
                return
            # Redis gone mid-request: the units are stranded in the shared
            # ledger until the window expires — never refund them from the
            # LOCAL window, which never charged them
            return
        with self._lock:
            rec = self._usage.get(key)
            if rec is not None:
                rec.used = max(0.0, rec.used - units)

    @staticmethod
    def headers(remaining: int, limit: int, reset_epoch: float) -> dict[str, str]:
        if remaining < 0:
            return {}
        return {
            "X-Quota-Limit": str(limit),
            "X-Quota-Remaining": str(max(remaining, 0)),
            "X-Quota-Reset": str(int(reset_epoch)),
        }

    def snapshot(self, key: str) -> Optional[dict]:
        rec = self._usage.get(key)
        if rec is None:
            return None
        return {
            "window_start": rec.window_start,
            "used": rec.used,
            "limit": rec.limit,
            "window": rec.window,
        }


class MonthlyUsage:
    """Per-key monthly unit caps by tier (main.py:186-320), env override
    OSCILLINK_MONTHLY_CAP.  In-process records are authoritative within an
    instance; when OSCILLINK_MONTHLY_USAGE_COLLECTION is set, usage is
    seeded from and written through to Firestore (reference main.py:202-244)
    so caps survive restarts and apply across instances."""

    class _RedisPersistence:
        """Monthly-usage persistence on Redis (same load/add contract as
        FirestoreMonthlyPersistence): INCRBY composes across replicas;
        keys carry a 40-day TTL so closed periods self-expire.  Used when
        Firestore is unconfigured and OSCILLINK_STATE_BACKEND=redis —
        semi-durable (a Redis flush loses the month), so Firestore stays
        the billing-grade option."""

        _TTL = 40 * 24 * 3600

        @staticmethod
        def _key(api_key: str, period: str) -> str:
            return f"osc:month:{api_key}:{period}"

        def load(self, api_key: str, period: str):
            from .redis_backend import get_redis_state

            rs = get_redis_state()
            if rs is None:
                return None
            raw = rs.get(self._key(api_key, period))
            try:
                return int(raw) if raw is not None else None
            except ValueError:
                return None

        def add(self, api_key: str, period: str, units: int):
            from .redis_backend import get_redis_state

            rs = get_redis_state()
            if rs is None:
                return None
            res = rs.incrby_with_window(self._key(api_key, period), units, self._TTL)
            return res[0] if res is not None else None

    def __init__(self, persistence=None) -> None:
        self._records: Dict[str, dict] = {}
        self._lock = threading.Lock()
        if persistence is None:
            from ._firestore_stores import make_monthly_persistence

            persistence = make_monthly_persistence()
        import os

        if persistence is None and os.getenv(
            "OSCILLINK_STATE_BACKEND", ""
        ).strip().lower() == "redis":
            persistence = MonthlyUsage._RedisPersistence()
        self.persistence = persistence
        from .alerts import AlertHooks

        self.alerts = AlertHooks()

    @staticmethod
    def _cap_for(meta: Optional[KeyMetadata]) -> int:
        import os

        if not meta:
            return 0
        try:
            cap_env = int(os.getenv("OSCILLINK_MONTHLY_CAP", "0"))
        except ValueError:
            cap_env = 0
        if cap_env > 0:
            return cap_env
        return int(tier_info(meta.tier).monthly_unit_cap)

    def _record(self, key: str, period: str) -> dict:
        rec = self._records.get(key)
        if rec is None or rec.get("period") != period:
            seed = 0
            if self.persistence is not None:
                seed = int(self.persistence.load(key, period) or 0)
            rec = {"period": period, "used": seed}
            self._records[key] = rec
        return rec

    def _raise_if_over(self, cap: int, used: int, units: int) -> None:
        if units > cap:
            raise ApiError(
                413, f"request units {units} exceed monthly cap {cap}",
                kind="payload",
            )
        if used + units > cap:
            raise ApiError(
                429,
                f"monthly cap exceeded (cap={cap}, used={used})",
                headers={
                    "X-MonthCap-Limit": str(cap),
                    "X-MonthCap-Remaining": str(max(cap - used, 0)),
                },
                kind="monthly_cap",
            )

    def peek(self, key: Optional[str], units: int, keystore: KeyStore) -> None:
        """Raise 413/429 if the request WOULD exceed the cap, consuming
        nothing — run before the windowed quota so a window 429 doesn't
        permanently burn monthly units (the reference consumes on check,
        main.py:286-320, so rejected retries drain the month there)."""
        if key is None:
            return
        cap = self._cap_for(keystore.get(key))
        if cap <= 0:
            return
        period = current_period()
        with self._lock:
            rec = self._record(key, period)
            used = int(rec["used"])
        try:
            self._raise_if_over(cap, used, units)
        except ApiError as e:
            if e.kind == "monthly_cap":
                # a key that never lands exactly on the cap would otherwise
                # never fire the 100% alert — tell the operator it's capped
                self.alerts.observe_monthly_rejection(key, period, used, cap)
            raise

    def check_and_consume(
        self, key: Optional[str], units: int, keystore: KeyStore
    ) -> Optional[dict]:
        if key is None:
            return None
        cap = self._cap_for(keystore.get(key))
        if cap <= 0:
            return None
        period = current_period()
        with self._lock:
            rec = self._record(key, period)
            used = int(rec["used"])
            try:
                self._raise_if_over(cap, used, units)
            except ApiError as e:
                if e.kind == "monthly_cap":
                    self.alerts.observe_monthly_rejection(key, period, used, cap)
                raise
            rec["used"] = used + units
        # the Firestore transactional increment is a blocking network RPC —
        # holding the process-wide lock across it would stall every other
        # key's monthly check behind one slow round-trip
        total = (
            self.persistence.add(key, period, units)
            if self.persistence is not None
            else None
        )
        with self._lock:
            rec = self._records.get(key)
            if rec is None or rec.get("period") != period:
                rec = self._record(key, period)
            if total is not None and int(total) > int(rec["used"]):
                # adopt the global total when another replica consumed more
                rec["used"] = int(total)
            used_now = int(rec["used"])
        # cap-threshold alert hooks (best-effort, fire-and-forget)
        self.alerts.observe_monthly(key, period, used_now, cap)
        return {
            "limit": cap,
            "used": used_now,
            "remaining": cap - used_now,
            "period": period,
        }

    def snapshot(self, key: str) -> Optional[dict]:
        return self._records.get(key)


@dataclass
class _Bucket:
    window_start: float = 0.0
    count: int = 0


class RateLimiter:
    """Fixed-window request rate limit, global and per-IP (main.py:576-699).

    With OSCILLINK_STATE_BACKEND=redis the windows are shared Redis
    counters (reference main.py:512,588,652); Redis unreachable falls back
    to the in-memory buckets, mirroring the reference's (0, -2) fallback."""

    _PURGE_EVERY = 1024  # check_ip calls between expired-bucket sweeps

    def __init__(self) -> None:
        self._global = _Bucket()
        self._per_ip: Dict[str, _Bucket] = {}
        self._lock = threading.Lock()
        self._ip_calls = 0

    def _check(self, bucket: _Bucket, limit: int, window: int) -> Optional[float]:
        now = time.time()
        if now - bucket.window_start >= window:
            bucket.window_start = now
            bucket.count = 0
        if bucket.count + 1 > limit:
            return bucket.window_start + window - now
        bucket.count += 1
        return None

    def _check_redis(self, scope: str, limit: int, window: int):
        """Returns None (allowed), retry seconds (limited), or "memory"
        (Redis not configured/unreachable — use the local bucket)."""
        from .redis_backend import get_redis_state

        rs = get_redis_state()
        if rs is None:
            return "memory"
        count = rs.incr_with_window(f"oscillink:rl:{scope}", window)
        if count is None:
            return "memory"
        if int(count) > limit:
            return float(window)  # conservative: full window as Retry-After
        return None

    def _enforce(self, scope: str, bucket: _Bucket, limit: int, window: int,
                 detail: str) -> None:
        retry = self._check_redis(scope, limit, window)
        if retry == "memory":
            with self._lock:
                retry = self._check(bucket, limit, window)
        if retry is not None:
            raise ApiError(
                429, detail, headers={"Retry-After": str(int(retry) + 1)},
                kind="rate_limit",
            )

    def check_global(self) -> None:
        rl = get_rate_limit()
        if rl.limit <= 0:
            return
        self._enforce("global", self._global, rl.limit, rl.window,
                      "rate limit exceeded")

    def check_ip(self, ip: str) -> None:
        rl = get_ip_rate_limit()
        if rl.limit <= 0:
            return
        with self._lock:
            self._ip_calls += 1
            if self._ip_calls % self._PURGE_EVERY == 0:
                # expired buckets never self-delete; a botnet / large NAT
                # pool would otherwise grow this map without bound
                now = time.time()
                dead = [
                    k
                    for k, b in self._per_ip.items()
                    if now - b.window_start >= rl.window
                ]
                for k in dead:
                    del self._per_ip[k]
            bucket = self._per_ip.setdefault(ip, _Bucket())
        self._enforce(f"ip:{ip}", bucket, rl.limit, rl.window,
                      "per-ip rate limit exceeded")
