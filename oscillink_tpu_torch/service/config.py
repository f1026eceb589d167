"""Service configuration: cached structural settings + uncached runtime knobs.

Mirrors the env-var contract of the reference (cloud/app/config.py:7-25,
runtime_config.py:19-56, settings.py:14-50).  Structural limits are cached;
credentials / limits that operators hot-rotate are read per-request.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional


@dataclass(frozen=True)
class Settings:
    project_name: str = "oscillink-tpu-cloud"
    api_version: str = "v1"
    max_nodes: int = 5000
    max_dim: int = 2048
    enable_signature: bool = True
    receipt_secret: Optional[str] = None


def _ienv(name: str, default: int) -> int:
    """Int env with fallback — every getter degrades to its default on a
    malformed value instead of 500ing all traffic / failing startup."""
    try:
        return int(os.getenv(name, str(default)))
    except ValueError:
        return default


@lru_cache
def get_settings() -> Settings:
    return Settings(
        max_nodes=_ienv("OSCILLINK_MAX_NODES", 5000),
        max_dim=_ienv("OSCILLINK_MAX_DIM", 2048),
        enable_signature=os.getenv("OSCILLINK_ENABLE_SIGNATURE", "1") == "1",
        receipt_secret=os.getenv("OSCILLINK_RECEIPT_SECRET"),
    )


@dataclass(frozen=True)
class AppSettings:
    """HTTP-layer settings (CORS / hosts / body cap)."""

    allowed_origins: tuple[str, ...] = ()
    trusted_hosts: tuple[str, ...] = ("*",)
    https_redirect: bool = False
    max_body_bytes: int = 1024 * 1024  # 1 MiB cap, reference settings.py


@lru_cache
def get_app_settings() -> AppSettings:
    origins = tuple(
        o.strip()
        for o in os.getenv("OSCILLINK_CORS_ORIGINS", "").split(",")
        if o.strip()
    )
    hosts = tuple(
        h.strip()
        for h in os.getenv("OSCILLINK_TRUSTED_HOSTS", "*").split(",")
        if h.strip()
    )
    return AppSettings(
        allowed_origins=origins,
        trusted_hosts=hosts or ("*",),
        https_redirect=os.getenv("OSCILLINK_HTTPS_REDIRECT", "0") == "1",
        max_body_bytes=_ienv("OSCILLINK_MAX_BODY_BYTES", 1024 * 1024),
    )


# ---- uncached runtime config (hot-reload contract) ----


@dataclass(frozen=True)
class RateLimitConfig:
    limit: int
    window: int


@dataclass(frozen=True)
class QuotaConfig:
    limit: int
    window: int


def get_api_keys() -> set[str]:
    raw = os.getenv("OSCILLINK_API_KEYS")
    if not raw:
        return set()
    return {k.strip() for k in raw.split(",") if k.strip()}


def get_rate_limit() -> RateLimitConfig:
    try:
        return RateLimitConfig(
            limit=int(os.getenv("OSCILLINK_RATE_LIMIT", "0")),
            window=int(os.getenv("OSCILLINK_RATE_WINDOW", "60")),
        )
    except ValueError:
        return RateLimitConfig(limit=0, window=60)


def get_ip_rate_limit() -> RateLimitConfig:
    try:
        return RateLimitConfig(
            limit=int(os.getenv("OSCILLINK_IP_RATE_LIMIT", "0")),
            window=int(os.getenv("OSCILLINK_IP_RATE_WINDOW", "60")),
        )
    except ValueError:
        return RateLimitConfig(limit=0, window=60)


def get_quota_config() -> QuotaConfig:
    try:
        return QuotaConfig(
            limit=int(os.getenv("OSCILLINK_KEY_NODE_UNITS_LIMIT", "0")),
            window=int(os.getenv("OSCILLINK_KEY_NODE_UNITS_WINDOW", "3600")),
        )
    except ValueError:
        return QuotaConfig(limit=0, window=3600)


def env_flag(name: str, default: str = "0") -> bool:
    return os.getenv(name, default).strip().lower() in {"1", "true", "on", "yes"}
