"""Usage JSONL log with optional per-line HMAC signing
(reference cloud/app/services/usage_log.py:10-33)."""

from __future__ import annotations

import hashlib
import hmac
import json
import os
from typing import Any, Optional


def _signing_secret() -> Optional[bytes]:
    s = os.getenv("OSCILLINK_USAGE_SIGNING_SECRET")
    return s.encode("utf-8") if s else None


def append_usage(record: dict[str, Any]) -> None:
    """Append one JSONL usage record to OSCILLINK_USAGE_LOG (no-op when unset).

    With OSCILLINK_USAGE_SIGNING_SECRET set, each line carries an HMAC-SHA256
    'sig' over its canonical JSON (for the remote flusher to verify)."""
    path = os.getenv("OSCILLINK_USAGE_LOG")
    if not path:
        return
    try:
        secret = _signing_secret()
        if secret is not None:
            raw = json.dumps(record, sort_keys=True).encode("utf-8")
            record = {**record, "sig": hmac.new(secret, raw, hashlib.sha256).hexdigest()}
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record, separators=(",", ":")) + "\n")
    except Exception:
        pass  # usage logging must never break the request path


def verify_usage_line(
    record: "dict[str, Any] | str | bytes", secret: bytes | str
) -> bool:
    """Verify one signed usage record (the checklist's 'signed usage
    receipts … verification helper'): the 'sig' field is HMAC-SHA256 over
    the record's canonical JSON WITHOUT the sig itself.  Accepts the dict
    or the raw JSONL line; never raises."""
    try:
        if isinstance(record, (str, bytes)):
            record = json.loads(record)
        if not isinstance(record, dict):
            return False
        claimed = record.get("sig")
        if not claimed:
            return False
        body = {k: v for k, v in record.items() if k != "sig"}
        raw = json.dumps(body, sort_keys=True).encode("utf-8")
        key = secret.encode("utf-8") if isinstance(secret, str) else secret
        return hmac.compare_digest(
            hmac.new(key, raw, hashlib.sha256).hexdigest(), str(claimed)
        )
    except Exception:
        return False


def read_usage_records(
    api_key: Optional[str] = None, limit: int = 100
) -> list[dict[str, Any]]:
    """Tail the usage JSONL (most recent last), optionally filtered by api
    key.  Returns [] when the log is unset/missing; malformed lines are
    skipped."""
    path = os.getenv("OSCILLINK_USAGE_LOG")
    if not path:
        return []
    out: list[dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except Exception:
                    continue
                if api_key is not None and rec.get("api_key") != api_key:
                    continue
                out.append(rec)
    except FileNotFoundError:
        return []
    except Exception:
        return []
    return out[-max(1, int(limit)):]
