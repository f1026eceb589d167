"""Receipt signing / verification (host-side, hardware independent).

The port's own copy of ``oscillink_tpu/core/receipts.py`` (that package
imports JAX on import, so the port cannot reuse it).  HMAC-SHA256 over
canonical (sorted-keys) JSON payloads, constant-time compare.  It must stay
wire-compatible: a receipt signed by either package verifies in the other.
"""

from __future__ import annotations

import hashlib
import hmac
import json
from typing import Any, Optional

__all__ = [
    "canonical_json",
    "sign_payload",
    "verify_receipt",
    "verify_receipt_mode",
    "sign_component",
    "verify_component",
]


def _as_bytes(secret: bytes | str) -> bytes:
    return secret.encode("utf-8") if isinstance(secret, str) else secret


def canonical_json(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True).encode("utf-8")


def sign_payload(payload: dict, secret: bytes | str) -> str:
    """Hex HMAC-SHA256 of the canonical JSON encoding of ``payload``."""
    return hmac.new(_as_bytes(secret), canonical_json(payload), hashlib.sha256).hexdigest()


def _candidate_secrets(
    block: dict, secret: "bytes | str | dict[str, bytes | str]"
) -> list:
    """Resolve the secret(s) to try: a plain secret is tried as-is; a
    {kid: secret} rotation map narrows to the block's kid when stamped,
    else tries every mapped secret (rotation-safe, like the Stripe
    webhook verify)."""
    if not isinstance(secret, dict):
        return [secret]
    kid = block.get("kid")
    if kid is not None:
        s = secret.get(kid)
        return [s] if s is not None else []
    return list(secret.values())


def verify_receipt(
    receipt: dict, secret: "bytes | str | dict[str, bytes | str]"
) -> bool:
    """Verify a signed receipt's meta.signature block. Never raises.

    ``secret`` may be a single secret or a {kid: secret} rotation map
    (reference roadmap: multi-secret receipt signing with key ids)."""
    try:
        block = receipt.get("meta", {}).get("signature")
        if not block or block.get("algorithm") != "HMAC-SHA256":
            return False
        payload = block.get("payload")
        claimed = block.get("signature")
        if payload is None or claimed is None:
            return False
        return any(
            hmac.compare_digest(sign_payload(payload, s), str(claimed))
            for s in _candidate_secrets(block, secret)
        )
    except Exception:
        return False


def verify_receipt_mode(
    receipt: dict,
    secret: "bytes | str | dict[str, bytes | str]",
    require_mode: Optional[str] = None,
    minimal_subset: bool = False,
    required_sig_v: Optional[int] = None,
) -> tuple[bool, Optional[dict]]:
    """Mode-aware verification (reference receipts.py:113-179).

    * ``require_mode`` in {'minimal', 'extended', None}: fail when the signed
      payload's mode differs.
    * ``required_sig_v``: fail when payload['sig_v'] differs.
    * ``minimal_subset``: for an 'extended' payload whose full signature does
      not match, retry against the minimal-subset payload {sig_v, mode:
      'minimal', state_sig, deltaH_total} — accepted only when require_mode is
      None or 'minimal'.

    Returns (ok, signed_payload_or_none).
    """
    try:
        block = receipt.get("meta", {}).get("signature")
        if not block or block.get("algorithm") != "HMAC-SHA256":
            return False, None
        payload = block.get("payload")
        sig_hex = block.get("signature")
        if payload is None or sig_hex is None:
            return False, None
        mode = payload.get("mode")
        if require_mode and mode != require_mode:
            return False, None
        if required_sig_v is not None and payload.get("sig_v") != required_sig_v:
            return False, None
        candidates = _candidate_secrets(block, secret)
        if any(
            hmac.compare_digest(sign_payload(payload, s), str(sig_hex))
            for s in candidates
        ):
            return True, payload
        if minimal_subset and mode == "extended":
            minimal_payload: dict[str, Any] = {
                "sig_v": payload.get("sig_v"),
                "mode": "minimal",
                "state_sig": payload.get("state_sig"),
                "deltaH_total": payload.get("deltaH_total"),
            }
            ok = any(
                hmac.compare_digest(sign_payload(minimal_payload, s), str(sig_hex))
                for s in candidates
            )
            if ok and require_mode in (None, "minimal"):
                return True, minimal_payload
        return False, None
    except Exception:
        return False, None


def sign_component(payload: dict, secret: bytes | str) -> dict:
    """Signature block for a composition-tier component receipt (shard /
    super / composed — SCALING.md section 6: each shard produces an
    independently verifiable receipt).  Same HMAC-SHA256-over-canonical-JSON
    contract as the lattice receipt's meta.signature block; attached at the
    component's top level as ``receipt["signature"]``."""
    return {
        "algorithm": "HMAC-SHA256",
        "payload": payload,
        "signature": sign_payload(payload, secret),
    }


def verify_component(receipt: dict, secret: bytes | str) -> bool:
    """Verify a composition component receipt signed by `sign_component`.
    Never raises; also checks that the signed payload's scalar fields match
    the receipt's own (a tampered receipt with an intact signed payload
    fails)."""
    try:
        block = receipt.get("signature")
        if not block or block.get("algorithm") != "HMAC-SHA256":
            return False
        payload = block.get("payload")
        claimed = block.get("signature")
        if payload is None or claimed is None:
            return False
        if not hmac.compare_digest(sign_payload(payload, secret), str(claimed)):
            return False
        return all(receipt.get(k) == v for k, v in payload.items())
    except Exception:
        return False
