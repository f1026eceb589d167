"""Redis state backend for multi-instance deployments
(reference cloud/app/redis_backend.py:9-73).

This image has no redis-py, so the client speaks RESP directly over a
socket — the three operations the service needs (windowed counters, TTL
get/set) cover rate limits, quotas, webhook idempotency, and CLI sessions
across instances.  Enabled by OSCILLINK_STATE_BACKEND=redis +
OSCILLINK_REDIS_URL; every call degrades to None/False on any error so the
in-memory fallbacks keep serving (reference redis_backend.py:25-29).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Optional
from urllib.parse import urlparse

__all__ = ["RespClient", "RedisState", "RedisReplyError", "get_redis_state"]


class RedisReplyError(RuntimeError):
    """Application-level Redis error reply (-ERR/WRONGTYPE/...)."""


class RespClient:
    """Minimal RESP2 client: connect lazily, one socket, thread-safe."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379, timeout: float = 1.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port), timeout=self.timeout)
            s.settimeout(self.timeout)
            self._sock = s
            self._buf = b""
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except Exception:
                pass
            self._sock = None

    def _read_line(self, s: socket.socket) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = s.recv(4096)
            if not chunk:
                raise ConnectionError("redis closed connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, s: socket.socket, n: int) -> bytes:
        while len(self._buf) < n + 2:  # payload + trailing CRLF
            chunk = s.recv(4096)
            if not chunk:
                raise ConnectionError("redis closed connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n + 2 :]
        return out

    def _read_reply(self, s: socket.socket):
        line = self._read_line(s)
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisReplyError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            return self._read_exact(s, n)
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply(s) for _ in range(n)]
        raise RuntimeError(f"unexpected RESP reply: {line!r}")

    def command(self, *args):
        parts = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            parts.append(b"$%d\r\n%s\r\n" % (len(b), b))
        payload = b"".join(parts)
        with self._lock:
            try:
                s = self._connect()
                s.sendall(payload)
                return self._read_reply(s)
            except RedisReplyError:
                # application-level error reply: the RESP stream is still in
                # sync — keep the connection (closing forced a TCP handshake
                # per benign -ERR/WRONGTYPE reply)
                raise
            except Exception:
                self.close()
                raise


class RedisState:
    """Operation wrapper with a failure circuit: every op records
    success/failure; after ``_BREAK_AFTER`` consecutive failures the
    circuit opens for ``_BREAK_FOR`` seconds and `get_redis_state` serves
    None (memory fallbacks) instead of letting every request re-pay a
    connect timeout against a blackholed server."""

    _BREAK_AFTER = 3
    _BREAK_FOR = 30.0

    def __init__(self, client: RespClient):
        self.client = client
        self._fails = 0
        self._open_until = 0.0

    def _cmd(self, *args):
        """client.command with circuit accounting: consecutive transport
        failures open the circuit; any success closes it."""
        try:
            out = self.client.command(*args)
        except RedisReplyError:
            # an application-level error reply IS a live server
            self._fails = 0
            raise
        except Exception:
            self._fails += 1
            if self._fails >= self._BREAK_AFTER:
                self._open_until = time.time() + self._BREAK_FOR
            raise
        self._fails = 0
        return out

    def circuit_open(self) -> bool:
        return time.time() < self._open_until

    def ping(self) -> bool:
        try:
            return self._cmd("PING") == "PONG"
        except Exception:
            return False

    def incr_with_window(self, key: str, window_seconds: int) -> Optional[int]:
        """Fixed-window counter: INCR + EXPIRE on first increment; returns the
        current count or None on failure (caller falls back to memory).

        TTL self-repair: if the EXPIRE after the first INCR ever failed
        (socket timeout, process death between the two commands), the key
        would live forever and the window would 429 permanently.  On later
        increments we cheaply re-check/heal the TTL every 64 counts."""
        try:
            count = int(self._cmd("INCR", key))
            if count == 1 or count % 64 == 0:
                ttl = self._cmd("TTL", key)
                if isinstance(ttl, int) and ttl < 0:
                    self._cmd("EXPIRE", key, window_seconds)
            return count
        except Exception:
            return None

    def incrby_with_window(
        self, key: str, amount: int, window_seconds: int
    ) -> Optional[tuple[int, int]]:
        """Fixed-window accumulator (quota units): INCRBY + EXPIRE on first
        touch, with the same TTL self-repair as `incr_with_window`.
        Returns (count_after, ttl_remaining_seconds) or None on failure."""
        try:
            count = int(self._cmd("INCRBY", key, int(amount)))
            ttl = self._cmd("TTL", key)
            if not isinstance(ttl, int) or ttl < 0:
                self._cmd("EXPIRE", key, window_seconds)
                ttl = window_seconds
            return count, int(ttl)
        except Exception:
            return None

    def decrby(self, key: str, amount: int) -> bool:
        """Refund quota units (a consume whose request was then rejected).

        Guarded: if the window key already expired there is nothing to
        refund (the consume died with it) — a blind DECRBY would recreate
        the key NEGATIVE with no TTL and grant double budget next window.
        A refund that lands at <= 0 deletes the key for the same reason."""
        try:
            exists = self._cmd("EXISTS", key)
            if not isinstance(exists, int) or exists == 0:
                return True  # expired window: nothing owed
            v = int(self._cmd("DECRBY", key, int(amount)))
            if v <= 0:
                self._cmd("DEL", key)
            return True
        except Exception:
            return False

    def get(self, key: str) -> Optional[bytes]:
        try:
            v = self._cmd("GET", key)
            return v if isinstance(v, (bytes, type(None))) else str(v).encode()
        except Exception:
            return None

    def set_with_ttl(self, key: str, value: str | bytes, ttl_seconds: int) -> bool:
        try:
            return self._cmd("SET", key, value, "EX", ttl_seconds) == "OK"
        except Exception:
            return False

    def delete(self, key: str) -> bool:
        try:
            self._cmd("DEL", key)
            return True
        except Exception:
            return False


_state: Optional[RedisState] = None
_checked_at = 0.0


def get_redis_state() -> Optional[RedisState]:
    """RedisState when OSCILLINK_STATE_BACKEND=redis and the server answers
    PING; otherwise None (re-probed at most every 30 s)."""
    global _state, _checked_at
    if os.getenv("OSCILLINK_STATE_BACKEND", "").lower() != "redis":
        return None
    now = time.time()
    if _state is not None:
        # circuit open (consecutive transport failures against a cached
        # state): serve memory fallbacks instead of paying a fresh connect
        # timeout on every operation of every request; after the cooldown
        # one cheap ping decides whether to close the circuit
        if _state.circuit_open():
            return None
        if _state._fails >= RedisState._BREAK_AFTER:
            if _state.ping():
                return _state
            return None
        return _state
    if now - _checked_at < 30.0:
        return None
    _checked_at = now
    url = urlparse(os.getenv("OSCILLINK_REDIS_URL", "redis://127.0.0.1:6379"))
    # short timeout: this probe runs ON the request path (once per 30 s
    # while Redis is down) — a 1 s connect timeout was a recurring
    # user-visible latency spike
    client = RespClient(url.hostname or "127.0.0.1", url.port or 6379, timeout=0.3)
    state = RedisState(client)
    if state.ping():
        _state = state
        return state
    return None
