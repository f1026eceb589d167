"""API-key store: metadata, tiers, status (reference cloud/app/keystore.py:17-189).

Backends: in-memory (env-seeded, hot-reloads when OSCILLINK_API_KEYS /
OSCILLINK_KEY_TIERS change) and an optional Firestore adapter that activates
only when google-cloud-firestore is importable.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["KeyMetadata", "KeyStore", "InMemoryKeyStore", "make_keystore"]


@dataclass
class KeyMetadata:
    api_key: str
    tier: str = "free"
    status: str = "active"  # active | pending | revoked | suspended
    quota_limit_units: Optional[int] = None
    quota_window_seconds: Optional[int] = None
    features: Dict[str, bool] = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)

    def is_active(self) -> bool:
        return self.status == "active"

    def to_dict(self) -> dict:
        return {
            "api_key": self.api_key,
            "tier": self.tier,
            "status": self.status,
            "quota_limit_units": self.quota_limit_units,
            "quota_window_seconds": self.quota_window_seconds,
            "features": dict(self.features),
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }


class KeyStore:
    def get(self, api_key: str) -> Optional[KeyMetadata]:
        raise NotImplementedError

    def update(
        self,
        api_key: str,
        create: bool = False,
        clear: Optional[list[str]] = None,
        **fields,
    ) -> Optional[KeyMetadata]:
        raise NotImplementedError

    def is_empty(self) -> bool:
        raise NotImplementedError


class InMemoryKeyStore(KeyStore):
    """Env-seeded store: OSCILLINK_API_KEYS (comma list) and
    OSCILLINK_KEY_TIERS ('key:tier;key2:tier2')."""

    def __init__(self) -> None:
        self._keys: Dict[str, KeyMetadata] = {}
        self._env_origin: set[str] = set()  # keys owned by the env lists
        self._env_fingerprint = self._fingerprint()
        self._seed_from_env()

    @staticmethod
    def _fingerprint() -> tuple[str, str]:
        return (
            os.getenv("OSCILLINK_API_KEYS", ""),
            os.getenv("OSCILLINK_KEY_TIERS", ""),
        )

    def _seed_from_env(self) -> None:
        raw = os.getenv("OSCILLINK_API_KEYS", "").strip()
        if raw:
            for k in (x.strip() for x in raw.split(",")):
                if k and k not in self._keys:
                    self._keys[k] = KeyMetadata(api_key=k)
                    self._env_origin.add(k)
        tiers = os.getenv("OSCILLINK_KEY_TIERS", "").strip()
        if tiers:
            for part in (x.strip() for x in tiers.split(";")):
                if ":" in part:
                    k, t = part.split(":", 1)
                    meta = self._keys.get(k)
                    if meta:
                        meta.tier = t
                        meta.updated_at = time.time()
                    else:
                        self._keys[k] = KeyMetadata(api_key=k, tier=t)
                        self._env_origin.add(k)

    def maybe_hot_reload(self) -> None:
        """Re-seed when the env key lists change (dev / test rotation).

        Only env-owned entries are replaced: clearing the whole dict would
        destroy every Stripe-webhook-provisioned key and admin update the
        moment an operator edits OSCILLINK_API_KEYS (all paying customers
        401 until their subscription events replay)."""
        fp = self._fingerprint()
        if fp != self._env_fingerprint:
            for k in self._env_origin:
                self._keys.pop(k, None)
            self._env_origin.clear()
            self._env_fingerprint = fp
            self._seed_from_env()

    def get(self, api_key: str) -> Optional[KeyMetadata]:
        return self._keys.get(api_key)

    def update(
        self,
        api_key: str,
        create: bool = False,
        clear: Optional[list[str]] = None,
        **fields,
    ) -> Optional[KeyMetadata]:
        meta = self._keys.get(api_key)
        if meta is None:
            if not create:
                return None
            meta = KeyMetadata(api_key=api_key)
            self._keys[api_key] = meta
        for k, v in fields.items():
            if hasattr(meta, k) and v is not None:
                setattr(meta, k, v)
        # None means "leave unchanged" above, so clearing an override back
        # to the global default needs the explicit clear list
        for k in clear or []:
            if k in ("quota_limit_units", "quota_window_seconds", "features"):
                setattr(meta, k, {} if k == "features" else None)
        meta.updated_at = time.time()
        return meta

    def is_empty(self) -> bool:
        return not self._keys


def make_keystore() -> KeyStore:
    backend = os.getenv("OSCILLINK_KEYSTORE_BACKEND", "memory").lower()
    if backend == "firestore":  # pragma: no cover — external dependency
        try:
            from ._firestore import FirestoreKeyStore

            return FirestoreKeyStore()
        except Exception:
            pass
    return InMemoryKeyStore()
