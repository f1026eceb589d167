"""CLI pairing sessions: signup code -> session store with TTL
(reference cloud/app/services/cli.py:11-153).  In-memory backend; a Redis
backend slots in via the same interface when OSCILLINK_STATE_BACKEND=redis
and a client is reachable.
"""

from __future__ import annotations

import os
import secrets
import time
from typing import Dict, Optional


def _ttl() -> float:
    try:
        return float(os.getenv("OSCILLINK_CLI_SESSION_TTL", "900"))
    except ValueError:
        return 900.0


class CliSessionStore:
    # hard bound on live sessions: /billing/cli/start is unauthenticated,
    # so without a cap an attacker loops it into unbounded memory growth
    MAX_SESSIONS = 10_000

    def __init__(self) -> None:
        self._sessions: Dict[str, dict] = {}

    def create(self, metadata: Optional[dict] = None) -> dict:
        self.purge()  # expired sessions leave the dict, not just flip status
        if len(self._sessions) >= self.MAX_SESSIONS:
            # drop the oldest pending sessions first
            pend = sorted(
                (r for r in self._sessions.values() if r["status"] == "pending"),
                key=lambda r: r["created_at"],
            )
            for r in pend[: max(1, len(pend) // 10)]:
                self._sessions.pop(r["code"], None)
        code = secrets.token_urlsafe(8)
        rec = {
            "code": code,
            "status": "pending",  # pending -> complete | expired
            "api_key": None,
            "created_at": time.time(),
            "metadata": metadata or {},
        }
        self._sessions[code] = rec
        return rec

    def get(self, code: str) -> Optional[dict]:
        rec = self._sessions.get(code)
        if rec is None:
            return None
        # only PENDING sessions expire: a completed session carries the
        # provisioned api_key, and expiring it strands a key the customer
        # paid for and can never retrieve (checkout often outlasts the TTL)
        if rec["status"] == "pending" and time.time() - rec["created_at"] > _ttl():
            rec["status"] = "expired"
        return rec

    def complete(self, code: str, api_key: str) -> bool:
        rec = self._sessions.get(code)
        if rec is None:
            return False
        # completion window is Stripe's checkout lifetime (24 h), not the
        # short poll TTL — a customer can legitimately finish checkout
        # (and the webhook land) long after polling marked the session
        # expired; the late completion un-expires it so the key is
        # retrievable instead of stranded
        if time.time() - rec["created_at"] > 86400:
            rec["status"] = "expired"
            return False
        rec["status"] = "complete"
        rec["api_key"] = api_key
        rec["completed_at"] = time.time()
        return True

    def complete_by_session_id(self, session_id: str, api_key: str) -> bool:
        """Complete the pairing session whose metadata carries this Stripe
        checkout-session id (webhook completion path)."""
        for rec in self._sessions.values():
            if rec["metadata"].get("checkout_session_id") == session_id:
                return self.complete(rec["code"], api_key)
        return False

    def purge(self) -> None:
        """Drop expired pending sessions and long-finished completed ones
        (completed sessions linger 24 h so slow pollers still get the key)."""
        now = time.time()
        ttl = _ttl()
        stale = [
            c
            for c, r in list(self._sessions.items())
            if (r["status"] != "complete" and now - r["created_at"] > ttl)
            or (
                r["status"] == "complete"
                and now - r.get("completed_at", r["created_at"]) > 86400
            )
        ]
        for code in stale:
            self._sessions.pop(code, None)


_store: Optional[CliSessionStore] = None


def get_cli_sessions() -> CliSessionStore:
    global _store
    if _store is None:
        _store = CliSessionStore()
    return _store
