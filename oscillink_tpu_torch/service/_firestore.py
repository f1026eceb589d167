"""Firestore keystore adapter (reference keystore.py:95-189 contract).

Activated by OSCILLINK_KEYSTORE_BACKEND=firestore when
google-cloud-firestore is importable (not baked into this image — the
adapter is exercised in deployments, with the in-memory store covering the
same interface in tests).  Document shape, collection override and field
fallbacks follow the reference.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from .keystore import KeyMetadata, KeyStore


class FirestoreKeyStore(KeyStore):  # pragma: no cover — external dependency
    """Keys live in OSCILLINK_FIRESTORE_COLLECTION (default
    'oscillink_api_keys'); document id = api key; fields mirror
    KeyMetadata (tier, status, quota_limit_units, quota_window_seconds,
    features, created_at, updated_at) with defaults for missing fields."""

    def __init__(self) -> None:
        from google.cloud import firestore  # type: ignore

        self._client = firestore.Client()
        self._collection = os.getenv(
            "OSCILLINK_FIRESTORE_COLLECTION", "oscillink_api_keys"
        )

    def _doc(self, api_key: str):
        return self._client.collection(self._collection).document(api_key)

    def get(self, api_key: str) -> Optional[KeyMetadata]:
        try:
            snap = self._doc(api_key).get()
        except Exception:
            return None
        if not snap.exists:
            return None
        data = snap.to_dict() or {}
        return KeyMetadata(
            api_key=api_key,
            tier=str(data.get("tier", "free")),
            status=str(data.get("status", "active")),
            quota_limit_units=data.get("quota_limit_units"),
            quota_window_seconds=data.get("quota_window_seconds"),
            features=dict(data.get("features") or {}),
            created_at=float(data.get("created_at", time.time())),
            updated_at=float(data.get("updated_at", time.time())),
        )

    def update(
        self,
        api_key: str,
        create: bool = False,
        clear: Optional[list] = None,
        **fields,
    ) -> Optional[KeyMetadata]:
        meta = self.get(api_key)
        if meta is None:
            if not create:
                return None
            meta = KeyMetadata(api_key=api_key)
        for k, v in fields.items():
            if hasattr(meta, k) and v is not None:
                setattr(meta, k, v)
        for k in clear or []:
            if k in ("quota_limit_units", "quota_window_seconds", "features"):
                setattr(meta, k, {} if k == "features" else None)
        meta.updated_at = time.time()
        payload = meta.to_dict()
        payload.pop("api_key", None)
        try:
            self._doc(api_key).set(payload, merge=True)
        except Exception:
            return None
        return meta

    def is_empty(self) -> bool:
        try:
            docs = self._client.collection(self._collection).limit(1).stream()
            return next(iter(docs), None) is None
        except Exception:
            return True
