"""The port's service (``oscillink_tpu_torch.service``, ``device="cpu"``):
the Redis backend (RESP over a socket, fake server), the cases of ``tests/test_redis_backend.py``.

RESP client + RedisState against an in-process fake Redis server."""

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import socket
import threading
import time


from oscillink_tpu_torch.service.redis_backend import RedisState, RespClient


class FakeRedis:
    """Tiny RESP2 server implementing PING/GET/SET/INCR/EXPIRE/TTL/DEL."""

    def __init__(self):
        self.data: dict[bytes, bytes] = {}
        self.expiry: dict[bytes, float] = {}
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self._stop = False
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _expired(self, key):
        exp = self.expiry.get(key)
        if exp is not None and time.time() > exp:
            self.data.pop(key, None)
            self.expiry.pop(key, None)
            return True
        return False

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn):
        buf = b""
        try:
            while True:
                chunk = conn.recv(4096)
                if not chunk:
                    return
                buf += chunk
                while True:
                    cmd, buf2 = self._parse(buf)
                    if cmd is None:
                        break
                    buf = buf2
                    conn.sendall(self._execute(cmd))
        except Exception:
            pass
        finally:
            conn.close()

    @staticmethod
    def _parse(buf):
        if not buf.startswith(b"*") or b"\r\n" not in buf:
            return None, buf
        head, rest = buf.split(b"\r\n", 1)
        n = int(head[1:])
        args = []
        for _ in range(n):
            if not rest.startswith(b"$") or b"\r\n" not in rest:
                return None, buf
            lhead, rest = rest.split(b"\r\n", 1)
            ln = int(lhead[1:])
            if len(rest) < ln + 2:
                return None, buf
            args.append(rest[:ln])
            rest = rest[ln + 2 :]
        return args, rest

    def _execute(self, args):
        cmd = args[0].upper()
        if cmd == b"PING":
            return b"+PONG\r\n"
        if cmd == b"SET":
            self.data[args[1]] = args[2]
            if len(args) >= 5 and args[3].upper() == b"EX":
                self.expiry[args[1]] = time.time() + int(args[4])
            return b"+OK\r\n"
        if cmd == b"GET":
            if self._expired(args[1]):
                return b"$-1\r\n"
            v = self.data.get(args[1])
            return b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v), v)
        if cmd == b"INCR":
            if self._expired(args[1]):
                pass
            v = int(self.data.get(args[1], b"0")) + 1
            self.data[args[1]] = str(v).encode()
            return b":%d\r\n" % v
        if cmd in (b"INCRBY", b"DECRBY"):
            if self._expired(args[1]):
                pass
            delta = int(args[2]) * (1 if cmd == b"INCRBY" else -1)
            v = int(self.data.get(args[1], b"0")) + delta
            self.data[args[1]] = str(v).encode()
            return b":%d\r\n" % v
        if cmd == b"EXPIRE":
            self.expiry[args[1]] = time.time() + int(args[2])
            return b":1\r\n"
        if cmd == b"TTL":
            if args[1] not in self.data:
                return b":-2\r\n"
            exp = self.expiry.get(args[1])
            if exp is None:
                return b":-1\r\n"
            return b":%d\r\n" % max(0, int(exp - time.time()))
        if cmd == b"DEL":
            existed = args[1] in self.data
            self.data.pop(args[1], None)
            self.expiry.pop(args[1], None)
            return b":%d\r\n" % (1 if existed else 0)
        if cmd == b"EXISTS":
            if self._expired(args[1]):
                return b":0\r\n"
            return b":%d\r\n" % (1 if args[1] in self.data else 0)
        return b"-ERR unknown\r\n"

    def stop(self):
        self._stop = True
        self.sock.close()


@pytest.fixture()
def fake_redis():
    server = FakeRedis()
    yield server
    server.stop()


def test_resp_roundtrip(fake_redis):
    state = RedisState(RespClient("127.0.0.1", fake_redis.port))
    assert state.ping()
    assert state.set_with_ttl("k1", "v1", 60)
    assert state.get("k1") == b"v1"
    assert state.get("missing") is None
    assert state.delete("k1")
    assert state.get("k1") is None


def test_windowed_counter(fake_redis):
    state = RedisState(RespClient("127.0.0.1", fake_redis.port))
    assert state.incr_with_window("rate:x", 60) == 1
    assert state.incr_with_window("rate:x", 60) == 2
    assert state.incr_with_window("rate:x", 60) == 3


def test_degrades_on_dead_server():
    state = RedisState(RespClient("127.0.0.1", 1))  # nothing listens here
    assert not state.ping()
    assert state.incr_with_window("x", 60) is None
    assert state.get("x") is None
    assert not state.set_with_ttl("x", "y", 60)


def test_get_redis_state_disabled(monkeypatch):
    from oscillink_tpu_torch.service import redis_backend

    monkeypatch.delenv("OSCILLINK_STATE_BACKEND", raising=False)
    assert redis_backend.get_redis_state() is None


def test_rate_limiter_rides_redis(fake_redis, monkeypatch):
    """With OSCILLINK_STATE_BACKEND=redis the limiters consult the shared
    Redis window (reference main.py:512,588,652) — two limiter INSTANCES
    (as in two replicas) share one budget."""
    from oscillink_tpu_torch.service import redis_backend
    from oscillink_tpu_torch.service.governance import ApiError, RateLimiter

    monkeypatch.setenv("OSCILLINK_STATE_BACKEND", "redis")
    monkeypatch.setenv("OSCILLINK_REDIS_URL", f"redis://127.0.0.1:{fake_redis.port}")
    monkeypatch.setenv("OSCILLINK_RATE_LIMIT", "3")
    monkeypatch.setenv("OSCILLINK_RATE_WINDOW", "60")
    monkeypatch.setattr(redis_backend, "_state", None)
    monkeypatch.setattr(redis_backend, "_checked_at", 0.0)

    a, b = RateLimiter(), RateLimiter()
    a.check_global()
    b.check_global()
    a.check_global()  # 3 of 3 consumed across BOTH instances
    try:
        b.check_global()
        raise AssertionError("expected shared-window 429")
    except ApiError as e:
        assert e.status == 429
    # memory fallback when redis goes away mid-flight
    fake_redis.stop()
    monkeypatch.setattr(redis_backend, "_state", None)
    monkeypatch.setattr(redis_backend, "_checked_at", 0.0)
    monkeypatch.setenv("OSCILLINK_REDIS_URL", "redis://127.0.0.1:1")
    c = RateLimiter()
    c.check_global()  # local bucket takes over; no exception


def test_incr_with_window_ttl_self_repair(fake_redis):
    """A lost EXPIRE (key with TTL=-1) is healed instead of 429ing the
    scope forever."""
    state = RedisState(RespClient("127.0.0.1", fake_redis.port))
    # simulate the lost EXPIRE: key exists with no expiry
    fake_redis.data[b"oscillink:rl:stuck"] = b"63"
    assert b"oscillink:rl:stuck" not in fake_redis.expiry
    count = state.incr_with_window("oscillink:rl:stuck", 60)
    assert count == 64  # 64 % 64 == 0 -> TTL check fires
    assert b"oscillink:rl:stuck" in fake_redis.expiry  # healed


def test_quota_windows_ride_redis(fake_redis, monkeypatch):
    """Reference readiness-checklist item (unchecked upstream): Redis
    backend for quota. Two QuotaState INSTANCES (two replicas) share one
    per-key unit budget; a rejected consume is refunded; refund after a
    later check's rejection routes to Redis."""
    from oscillink_tpu_torch.service import redis_backend
    from oscillink_tpu_torch.service.governance import ApiError, QuotaState
    from oscillink_tpu_torch.service.keystore import InMemoryKeyStore

    monkeypatch.setenv("OSCILLINK_STATE_BACKEND", "redis")
    monkeypatch.setenv("OSCILLINK_REDIS_URL", f"redis://127.0.0.1:{fake_redis.port}")
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_LIMIT", "1000")
    monkeypatch.setenv("OSCILLINK_KEY_WINDOW_SECONDS", "60")
    monkeypatch.setattr(redis_backend, "_state", None)
    monkeypatch.setattr(redis_backend, "_checked_at", 0.0)

    ks = InMemoryKeyStore()
    a, b = QuotaState(), QuotaState()
    rem_a, limit, _, route = a.check_and_consume("k1", 400, ks)
    assert route == "redis"
    assert (rem_a, limit) == (600, 1000)
    rem_b, _, _, _ = b.check_and_consume("k1", 400, ks)
    assert rem_b == 200  # instance B sees instance A's consumption
    with pytest.raises(ApiError) as ei:
        b.check_and_consume("k1", 400, ks)  # would be 1200 > 1000
    assert ei.value.status == 429 and ei.value.kind == "quota_window"
    # the rejected consume was refunded: 200 units still available
    rem_a2, _, _, _ = a.check_and_consume("k1", 200, ks)
    assert rem_a2 == 0
    # an explicit refund (monthly-cap race path) restores shared units
    a.refund("k1", 200, route="redis")
    rem_b2, _, _, _ = b.check_and_consume("k1", 200, ks)
    assert rem_b2 == 0
    # per-key isolation
    rem_other, _, _, _ = b.check_and_consume("k2", 100, ks)
    assert rem_other == 900


def test_monthly_usage_rides_redis(fake_redis, monkeypatch):
    """With Firestore unconfigured and OSCILLINK_STATE_BACKEND=redis,
    monthly usage persists to Redis: INCRBY composes across replicas."""
    from oscillink_tpu_torch.service import redis_backend
    from oscillink_tpu_torch.service.governance import ApiError, MonthlyUsage
    from oscillink_tpu_torch.service.keystore import InMemoryKeyStore

    monkeypatch.delenv("OSCILLINK_MONTHLY_USAGE_COLLECTION", raising=False)
    monkeypatch.setenv("OSCILLINK_STATE_BACKEND", "redis")
    monkeypatch.setenv("OSCILLINK_REDIS_URL", f"redis://127.0.0.1:{fake_redis.port}")
    monkeypatch.setenv("OSCILLINK_MONTHLY_CAP", "1000")
    monkeypatch.setenv("OSCILLINK_API_KEYS", "km")
    monkeypatch.setattr(redis_backend, "_state", None)
    monkeypatch.setattr(redis_backend, "_checked_at", 0.0)

    ks = InMemoryKeyStore()
    a, b = MonthlyUsage(), MonthlyUsage()
    assert a.persistence is not None and b.persistence is not None
    ctx = a.check_and_consume("km", 600, ks)
    assert ctx["used"] == 600
    # a fresh replica seeds from Redis and sees the global total
    ctx_b = b.check_and_consume("km", 300, ks)
    assert ctx_b["used"] == 900
    with pytest.raises(ApiError) as ei:
        b.check_and_consume("km", 300, ks)  # 1200 > 1000
    assert ei.value.status == 429 and ei.value.kind == "monthly_cap"


def test_refund_routes_to_the_consuming_ledger(fake_redis, monkeypatch):
    """Review fix: a consume that landed in the MEMORY window (Redis down
    for that request) must refund to memory even if Redis is back — and a
    redis-routed refund never touches the local window."""
    from oscillink_tpu_torch.service import redis_backend
    from oscillink_tpu_torch.service.governance import QuotaState
    from oscillink_tpu_torch.service.keystore import InMemoryKeyStore

    monkeypatch.setenv("OSCILLINK_STATE_BACKEND", "redis")
    monkeypatch.setenv("OSCILLINK_REDIS_URL", f"redis://127.0.0.1:{fake_redis.port}")
    monkeypatch.setenv("OSCILLINK_KEY_NODE_UNITS_LIMIT", "1000")
    monkeypatch.setattr(redis_backend, "_state", None)
    monkeypatch.setattr(redis_backend, "_checked_at", 0.0)
    ks = InMemoryKeyStore()
    q = QuotaState()
    _, _, _, route1 = q.check_and_consume("kr1", 300, ks)
    assert route1 == "redis"
    # Redis flap: force the memory path for the second consume
    monkeypatch.setattr(redis_backend, "_state", None)
    monkeypatch.setattr(redis_backend, "_checked_at", time.time())
    monkeypatch.setenv("OSCILLINK_STATE_BACKEND", "memory")
    _, _, _, route2 = q.check_and_consume("kr1", 200, ks)
    assert route2 == "memory"
    # refund the MEMORY consume while Redis is reachable again
    monkeypatch.setenv("OSCILLINK_STATE_BACKEND", "redis")
    monkeypatch.setattr(redis_backend, "_checked_at", 0.0)
    q.refund("kr1", 200, route=route2)
    # redis ledger untouched (still 300), memory ledger back to 0
    assert int(fake_redis.data[b"osc:quota:kr1"]) == 300
    assert q._usage["kr1"].used == 0.0


def test_decrby_never_recreates_expired_window(fake_redis):
    """Review fix: a refund after the window key expired must not recreate
    it negative with no TTL (double budget next window)."""
    state = RedisState(RespClient("127.0.0.1", fake_redis.port))
    # no key at all: refund is a no-op success
    assert state.decrby("osc:quota:gone", 400)
    assert b"osc:quota:gone" not in fake_redis.data
    # a refund landing at zero deletes the key
    state.incrby_with_window("osc:quota:z", 400, 60)
    assert state.decrby("osc:quota:z", 400)
    assert b"osc:quota:z" not in fake_redis.data


def test_circuit_breaker_stops_repaying_timeouts(fake_redis, monkeypatch):
    """Review fix: after consecutive transport failures the circuit opens
    and get_redis_state serves None (memory fallback) instead of paying a
    connect timeout per operation per request."""
    from oscillink_tpu_torch.service import redis_backend

    monkeypatch.setenv("OSCILLINK_STATE_BACKEND", "redis")
    monkeypatch.setenv("OSCILLINK_REDIS_URL", f"redis://127.0.0.1:{fake_redis.port}")
    monkeypatch.setattr(redis_backend, "_state", None)
    monkeypatch.setattr(redis_backend, "_checked_at", 0.0)
    st = redis_backend.get_redis_state()
    assert st is not None and st.incr_with_window("cb", 60) == 1
    # server dies; three failed ops open the circuit
    fake_redis.stop()
    st.client.close()
    st.client.port = 1  # blackhole-ish: connection refused
    for _ in range(3):
        assert st.incr_with_window("cb", 60) is None
    assert st.circuit_open()
    assert redis_backend.get_redis_state() is None  # memory fallback now
    # cooldown elapses: one ping probes; still dead -> stays None AND the
    # failed probe re-arms the circuit for another cooldown
    st._open_until = 0.0
    assert redis_backend.get_redis_state() is None
    assert st.circuit_open()
    # server back: after the next cooldown the probe closes the circuit
    revived = FakeRedis()
    try:
        st.client.port = revived.port
        st.client.close()
        st._open_until = 0.0
        assert redis_backend.get_redis_state() is st
        assert st.incr_with_window("cb2", 60) == 1
    finally:
        revived.stop()
