"""Per-key TTL-LRU caches (reference cloud/app/services/cache.py:29-73).

One shared, LOCKED structure (`_PerKeyTTLLRU`) backs both the bundle cache
and the replay cache — `handle()` runs in the aiohttp thread pool, so an
unlocked OrderedDict's get/move_to_end racing a put/popitem raises
KeyError on a valid request.  Entry TTL and per-key LRU size come from the
subclass's env vars; TTL <= 0 disables the cache.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any, Optional


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.getenv(name, str(default)))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.getenv(name, str(default)))
    except ValueError:
        return default


class _PerKeyTTLLRU:
    """Thread-safe per-api-key TTL-LRU of small records.

    Subclasses define `ttl()` / `size()` (read per call so env hot-reload
    keeps working).  Values are opaque; expiry is stamped at put time.
    A periodic sweep (every 256 puts) drops expired entries and empty
    buckets so rotated keys don't pin memory forever."""

    def __init__(self) -> None:
        self._per_key: dict[str, OrderedDict[str, dict]] = {}
        self._puts = 0
        self._lock = threading.Lock()

    @staticmethod
    def ttl() -> float:  # pragma: no cover — overridden
        return 0.0

    @staticmethod
    def size() -> int:  # pragma: no cover — overridden
        return 64

    @staticmethod
    def global_bound() -> int:
        """Total-entry cap across ALL api keys (0 = per-key bound only).

        Caches whose records pin device memory (the graph cache holds
        device tensors: neighbor idx/w, degrees, window plan) override this —
        a per-key bound alone lets total memory grow as size x tenants."""
        return 0

    def stats(self) -> dict:
        """Entry/bucket counts for admin introspection (no key material)."""
        with self._lock:
            return {
                "entries": sum(len(b) for b in self._per_key.values()),
                "buckets": len(self._per_key),
            }

    def sweep_expired(self) -> None:
        """Drop every expired entry now (access-driven, like jobs.purge)."""
        ttl = self.ttl()
        if ttl <= 0:
            return
        now = time.time()
        with self._lock:
            for key in list(self._per_key):
                b = self._per_key[key]
                for s in [s for s, r in list(b.items()) if now - r["ts"] > ttl]:
                    b.pop(s, None)
                if not b:
                    self._per_key.pop(key, None)

    def _evict_to_global_bound(self) -> None:
        """Assumes self._lock held. Evict oldest-put entries across keys."""
        bound = self.global_bound()
        if bound <= 0:
            return
        while sum(len(b) for b in self._per_key.values()) > bound:
            oldest_key, oldest_sig, oldest_ts = None, None, None
            for key, b in self._per_key.items():
                for s, r in b.items():  # front of each LRU bucket first
                    at = r.get("atime", r["ts"])
                    if oldest_ts is None or at < oldest_ts:
                        oldest_key, oldest_sig, oldest_ts = key, s, at
                    break
            if oldest_key is None:  # pragma: no cover — defensive
                return
            b = self._per_key[oldest_key]
            b.pop(oldest_sig, None)
            if not b:
                self._per_key.pop(oldest_key, None)

    def _get(self, api_key: Optional[str], sig: str) -> Optional[dict]:
        ttl = self.ttl()
        if ttl <= 0:
            return None
        with self._lock:
            bucket = self._per_key.get(api_key or "_anon_")
            if not bucket:
                return None
            rec = bucket.get(sig)
            if rec is None:
                return None
            if time.time() - rec["ts"] > ttl:
                bucket.pop(sig, None)
                return None
            rec["atime"] = time.time()  # global-LRU recency (TTL stays put-time)
            bucket.move_to_end(sig)
            return rec

    def _put(self, api_key: Optional[str], sig: str, rec: dict) -> None:
        ttl = self.ttl()
        if ttl <= 0:
            return
        now = time.time()
        with self._lock:
            bucket = self._per_key.setdefault(api_key or "_anon_", OrderedDict())
            bucket[sig] = {"ts": now, "atime": now, **rec}
            bucket.move_to_end(sig)
            while len(bucket) > self.size():
                bucket.popitem(last=False)
            self._evict_to_global_bound()
            self._puts += 1
            if self._puts % 256 == 0:
                for key in list(self._per_key):
                    b = self._per_key[key]
                    for s in [s for s, r in list(b.items()) if now - r["ts"] > ttl]:
                        b.pop(s, None)
                    if not b:
                        self._per_key.pop(key, None)


class BundleCache(_PerKeyTTLLRU):
    """Keyed by (api_key, state_sig); `OSCILLINK_BUNDLE_CACHE_TTL` seconds
    (default 30), `OSCILLINK_BUNDLE_CACHE_SIZE` entries per key."""

    @staticmethod
    def ttl() -> float:
        return _env_float("OSCILLINK_BUNDLE_CACHE_TTL", 30.0)

    @staticmethod
    def size() -> int:
        return _env_int("OSCILLINK_BUNDLE_CACHE_SIZE", 64)

    def get(self, api_key: Optional[str], state_sig: str) -> Optional[dict]:
        return self._get(api_key, state_sig)

    def put(self, api_key: Optional[str], state_sig: str,
            bundle: list[dict[str, Any]]) -> None:
        self._put(api_key, state_sig, {"bundle": bundle})


class ReplayCache(_PerKeyTTLLRU):
    """Idempotent-replay cache for settle-family responses (the reference
    CLOUD_ARCH_GCP.md open question — "ephemeral object cache … for
    idempotent replay? Possibly enterprise only" — implemented, opt-in).

    Keyed by SHA-256 of (endpoint, raw request bytes, api key): an exact
    retry of a recent request is answered from cache WITHOUT recompute,
    quota charge, or usage append (retry semantics — the work was already
    paid for).  Off by default: enable with OSCILLINK_REPLAY_CACHE_TTL
    seconds; per-key LRU bound OSCILLINK_REPLAY_CACHE_SIZE (default 32).
    Within the TTL, adaptive-learner exploration jitter is deliberately
    not re-rolled (identical body => identical response)."""

    @staticmethod
    def ttl() -> float:
        return _env_float("OSCILLINK_REPLAY_CACHE_TTL", 0.0)

    @staticmethod
    def size() -> int:
        return _env_int("OSCILLINK_REPLAY_CACHE_SIZE", 32)

    @staticmethod
    def key(endpoint: str, raw_body: bytes, api_key: Optional[str]) -> str:
        """Hash the RAW bytes: an exact retry resends identical bytes, and
        hashing them avoids a second full json parse + canonical dump of a
        multi-MB Y matrix on every request."""
        import hashlib

        h = hashlib.sha256()
        h.update(endpoint.encode("utf-8"))
        h.update(b"\x00")
        h.update((api_key or "").encode("utf-8"))
        h.update(b"\x00")
        h.update(raw_body)
        return h.hexdigest()

    def get(self, api_key: Optional[str], sig: str) -> Optional[dict]:
        rec = self._get(api_key, sig)
        return rec["body"] if rec is not None else None

    def put(self, api_key: Optional[str], sig: str, body: dict) -> None:
        self._put(api_key, sig, {"body": body})
