"""Cap-threshold alert webhooks (reference PROD_READINESS checklist item
"Alert hooks (cap threshold webhooks/email)" — designed upstream, never
implemented).

When a key's monthly usage crosses a configured fraction of its cap, a
JSON alert is POSTed to ``OSCILLINK_ALERT_WEBHOOK_URL``:

    {"event": "monthly_cap_threshold", "threshold": 0.8,
     "api_key_hash": "…12 hex…", "api_key_suffix": "…4…",
     "period": "2026-08", "used": 812, "limit": 1000, "ts": …}

* thresholds come from ``OSCILLINK_ALERT_THRESHOLDS`` (comma-separated
  fractions, default ``0.8,1.0``);
* each (key, period, threshold) fires at most once per process;
* delivery is best-effort on a daemon thread with a short timeout — a
  slow or dead alert sink never blocks or fails the request path;
* the raw API key never leaves the process: the payload carries a short
  SHA-256 prefix plus the last four characters;
* with ``OSCILLINK_ALERT_SECRET`` set, the body is HMAC-SHA256-signed into
  an ``X-Oscillink-Signature`` header (same canonical-JSON contract as
  receipt signing).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import threading
import time
from typing import Optional

__all__ = ["AlertHooks"]


def _thresholds() -> list[float]:
    raw = os.getenv("OSCILLINK_ALERT_THRESHOLDS", "0.8,1.0")
    out = []
    for part in raw.split(","):
        try:
            v = float(part.strip())
        except ValueError:
            continue
        if 0 < v <= 1.0:
            out.append(v)
    return sorted(set(out))


class AlertHooks:
    def __init__(self) -> None:
        self._fired: set[tuple[str, str, float]] = set()
        self._lock = threading.Lock()

    @staticmethod
    def url() -> str:
        return os.getenv("OSCILLINK_ALERT_WEBHOOK_URL", "").strip()

    def observe_monthly(
        self, api_key: str, period: str, used: int, cap: int
    ) -> None:
        """Called after a successful monthly consume; fires any thresholds
        newly crossed.  Never raises."""
        try:
            url = self.url()
            if not url or cap <= 0:
                return
            frac = used / cap
            for th in _thresholds():
                if frac < th:
                    continue
                tag = (api_key, period, th)
                with self._lock:
                    if tag in self._fired:
                        continue
                    self._fired.add(tag)
                self._post(url, {
                    "event": "monthly_cap_threshold",
                    "threshold": th,
                    "api_key_hash": hashlib.sha256(
                        api_key.encode()).hexdigest()[:12],
                    # the suffix identifies the key to an operator; for
                    # short keys it would BE the key, so omit it there
                    "api_key_suffix": api_key[-4:] if len(api_key) > 8 else "",
                    "period": period,
                    "used": int(used),
                    "limit": int(cap),
                    "ts": time.time(),
                })
        except Exception:
            pass

    def observe_monthly_rejection(
        self, api_key: str, period: str, used: int, cap: int
    ) -> None:
        """Fired when a request is REJECTED by the monthly cap.  Without
        this, a key whose usage never lands exactly on the cap (used + next
        request > cap but used < cap) would never trigger the 1.0 alert —
        the operator must still learn the key is effectively exhausted.
        Once per (key, period).  Never raises."""
        try:
            url = self.url()
            if not url or cap <= 0:
                return
            tag = (api_key, period, -1.0)  # sentinel threshold for rejection
            with self._lock:
                if tag in self._fired:
                    return
                self._fired.add(tag)
            self._post(url, {
                "event": "monthly_cap_rejected",
                "api_key_hash": hashlib.sha256(
                    api_key.encode()).hexdigest()[:12],
                "api_key_suffix": api_key[-4:] if len(api_key) > 8 else "",
                "period": period,
                "used": int(used),
                "limit": int(cap),
                "ts": time.time(),
            })
        except Exception:
            pass

    @staticmethod
    def _post(url: str, payload: dict) -> None:
        body = json.dumps(payload, sort_keys=True).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        secret: Optional[str] = os.getenv("OSCILLINK_ALERT_SECRET")
        if secret:
            headers["X-Oscillink-Signature"] = hmac.new(
                secret.encode("utf-8"), body, hashlib.sha256
            ).hexdigest()

        def send():
            try:
                import urllib.request

                req = urllib.request.Request(
                    url, data=body, headers=headers, method="POST"
                )
                urllib.request.urlopen(req, timeout=3.0).read()
            except Exception:
                pass  # best-effort: a dead sink never breaks serving

        threading.Thread(target=send, daemon=True).start()
