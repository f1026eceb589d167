"""The port's service (``oscillink_tpu_torch.service``, ``device="cpu"``):
the Firestore stores (in-memory fake), the cases of ``tests/test_firestore_stores.py``.

Contract tests for the Firestore persistence adapters
(oscillink_tpu/service/_firestore_stores.py) against an in-memory fake of
the google-cloud-firestore client — the fake implements exactly the API
subset the adapters use (document get/set, transactions, create-only put),
so these tests exercise the REAL adapter code paths.

Reference contracts: learners.py:127-145 (profile docs), main.py:202-244
(transactional monthly usage), services/events.py:14-72 (idempotent events).
"""

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import sys
import types


# one process-global backing store so separate Client() instances behave like
# separate service instances sharing one Firestore project
_DB: dict = {}


class _Snap:
    def __init__(self, data):
        self._data = data

    @property
    def exists(self):
        return self._data is not None

    def to_dict(self):
        return dict(self._data) if self._data is not None else None


class _DocRef:
    def __init__(self, coll: str, doc_id: str):
        self._key = (coll, doc_id)

    def get(self, transaction=None):
        return _Snap(_DB.get(self._key))

    def set(self, payload, merge=False):
        if merge and self._key in _DB:
            cur = dict(_DB[self._key])
            cur.update(payload)
            _DB[self._key] = cur
        else:
            _DB[self._key] = dict(payload)

    def create(self, payload):
        # Firestore semantics: atomic create, AlreadyExists when present
        if self._key in _DB:
            raise RuntimeError("AlreadyExists")
        _DB[self._key] = dict(payload)


class _Coll:
    def __init__(self, name):
        self._name = name

    def document(self, doc_id):
        return _DocRef(self._name, doc_id)

    def limit(self, n):
        return self

    def stream(self):
        return iter([])


class _Tx:
    def set(self, ref, payload, merge=False):
        ref.set(payload, merge=merge)


class _Client:
    def collection(self, name):
        return _Coll(name)

    def transaction(self):
        return _Tx()


def _transactional(fn):
    def wrapper(tx, ref):
        return fn(tx, ref)

    return wrapper


@pytest.fixture()
def fake_firestore(monkeypatch):
    _DB.clear()
    fake = types.ModuleType("google.cloud.firestore")
    fake.Client = _Client
    fake.transactional = _transactional
    google = types.ModuleType("google")
    cloud = types.ModuleType("google.cloud")
    cloud.firestore = fake
    google.cloud = cloud
    monkeypatch.setitem(sys.modules, "google", google)
    monkeypatch.setitem(sys.modules, "google.cloud", cloud)
    monkeypatch.setitem(sys.modules, "google.cloud.firestore", fake)
    return fake


# -- factories ---------------------------------------------------------------


def test_factories_disabled_without_env(monkeypatch):
    from oscillink_tpu_torch.service._firestore_stores import (
        make_event_store,
        make_monthly_persistence,
        make_profile_store,
    )

    for v in (
        "OSCILLINK_LEARNERS_COLLECTION",
        "OSCILLINK_MONTHLY_USAGE_COLLECTION",
        "OSCILLINK_WEBHOOK_EVENTS_COLLECTION",
    ):
        monkeypatch.delenv(v, raising=False)
    assert make_profile_store() is None
    assert make_monthly_persistence() is None
    assert make_event_store() is None


def test_factories_fall_back_without_client_lib(monkeypatch):
    """Env set but google-cloud-firestore unimportable -> memory fallback."""
    from oscillink_tpu_torch.service._firestore_stores import make_profile_store

    monkeypatch.setenv("OSCILLINK_LEARNERS_COLLECTION", "profiles")
    monkeypatch.setitem(sys.modules, "google.cloud.firestore", None)
    monkeypatch.setitem(sys.modules, "google.cloud", None)
    monkeypatch.setitem(sys.modules, "google", None)
    assert make_profile_store() is None


# -- profile store -----------------------------------------------------------


def test_profile_store_roundtrip_across_instances(fake_firestore, monkeypatch):
    monkeypatch.setenv("OSCILLINK_LEARNERS_COLLECTION", "oscillink_profiles")
    from oscillink_tpu_torch.service._firestore_stores import FirestoreProfileStore

    s1 = FirestoreProfileStore()
    assert s1.get("key-1") is None
    doc = {
        "active_profile_id": "p-2026-08-17",
        "learned_params": {"lamC": 0.7, "kneighbors": 8},
        "ema_score": -12.5,
        "obs_count": 600,
        "last_promoted_at": 123.0,
    }
    s1.set("key-1", doc)
    # a different instance (different "service replica") sees the same doc
    s2 = FirestoreProfileStore()
    got = s2.get("key-1")
    assert got == doc


def test_learners_use_firestore_store(fake_firestore, monkeypatch):
    monkeypatch.setenv("OSCILLINK_LEARNERS_COLLECTION", "oscillink_profiles")
    from oscillink_tpu_torch.service._firestore_stores import FirestoreProfileStore
    from oscillink_tpu_torch.service.learners import Learners

    lr = Learners()
    assert isinstance(lr.store, FirestoreProfileStore)
    monkeypatch.setenv("OSCILLINK_ADAPTIVE_PROFILES", "1")
    lr.store.set(
        "key-2", {"active_profile_id": "tuned", "learned_params": {"lamQ": 5.0}}
    )
    # a fresh Learners (fresh replica) resolves the persisted profile
    prof_id, overrides = Learners().get_active_profile("key-2")
    assert prof_id == "tuned"
    assert overrides == {"lamQ": 5.0}


# -- monthly usage persistence ----------------------------------------------


def test_monthly_usage_survives_restart(fake_firestore, monkeypatch):
    monkeypatch.setenv("OSCILLINK_MONTHLY_USAGE_COLLECTION", "oscillink_monthly")
    monkeypatch.setenv("OSCILLINK_MONTHLY_CAP", "100")
    from oscillink_tpu_torch.service.governance import ApiError, MonthlyUsage
    from oscillink_tpu_torch.service.keystore import InMemoryKeyStore

    ks = InMemoryKeyStore()
    ks.update("k", create=True, tier="free", status="active")

    m1 = MonthlyUsage()
    assert m1.persistence is not None
    out = m1.check_and_consume("k", 60, ks)
    assert out["used"] == 60 and out["remaining"] == 40

    # a brand-new instance (restart / second replica) seeds from Firestore
    m2 = MonthlyUsage()
    out2 = m2.check_and_consume("k", 30, ks)
    assert out2["used"] == 90
    with pytest.raises(ApiError) as exc:
        m2.check_and_consume("k", 20, ks)
    assert exc.value.status == 429


def test_monthly_persistence_blind_set_fallback(fake_firestore, monkeypatch):
    """When the transaction path raises, the read+merge-set fallback still
    lands the increment (reference main.py:233-242)."""
    monkeypatch.setenv("OSCILLINK_MONTHLY_USAGE_COLLECTION", "oscillink_monthly")
    from oscillink_tpu_torch.service._firestore_stores import FirestoreMonthlyPersistence

    p = FirestoreMonthlyPersistence()

    def boom(self):
        raise RuntimeError("tx unavailable")

    monkeypatch.setattr(_Client, "transaction", boom)
    assert p.add("k", "2026-08", 42) == 42
    assert p.load("k", "2026-08") == 42


def test_monthly_concurrent_replicas_compose(fake_firestore, monkeypatch):
    """Two replicas consuming concurrently must ACCUMULATE in Firestore —
    the transactional add increments the stored total instead of writing
    each replica's local view (last-write-wins would let caps be bypassed
    cap x replicas times)."""
    monkeypatch.setenv("OSCILLINK_MONTHLY_USAGE_COLLECTION", "oscillink_monthly")
    monkeypatch.setenv("OSCILLINK_MONTHLY_CAP", "100")
    from oscillink_tpu_torch.service.governance import ApiError, MonthlyUsage
    from oscillink_tpu_torch.service.keystore import InMemoryKeyStore

    ks = InMemoryKeyStore()
    ks.update("k", create=True, tier="free", status="active")

    # both replicas seed at 0 (fresh period), then consume interleaved
    m1, m2 = MonthlyUsage(), MonthlyUsage()
    out1 = m1.check_and_consume("k", 60, ks)
    assert out1["used"] == 60
    out2 = m2.check_and_consume("k", 30, ks)
    # replica 2 adopts the GLOBAL total (60 + 30), not its local 30
    assert out2["used"] == 90
    with pytest.raises(ApiError) as exc:
        m2.check_and_consume("k", 20, ks)
    assert exc.value.status == 429


# -- webhook event store -----------------------------------------------------


def test_event_store_cross_instance_idempotency(fake_firestore, monkeypatch):
    monkeypatch.setenv("OSCILLINK_WEBHOOK_EVENTS_COLLECTION", "oscillink_events")
    from oscillink_tpu_torch.service.cli_sessions import CliSessionStore
    from oscillink_tpu_torch.service.keystore import InMemoryKeyStore
    from oscillink_tpu_torch.service.webhooks import WebhookProcessor

    w1 = WebhookProcessor(InMemoryKeyStore(), CliSessionStore())
    assert w1._fs_events is not None
    assert w1.seen("evt_1") is None
    w1.record("evt_1", {"id": "evt_1", "type": "checkout.session.completed"})

    # a second replica has no memory/Redis state but finds the Firestore doc
    w2 = WebhookProcessor(InMemoryKeyStore(), CliSessionStore())
    rec = w2.seen("evt_1")
    assert rec is not None and rec["id"] == "evt_1"


def test_event_store_create_only(fake_firestore, monkeypatch):
    monkeypatch.setenv("OSCILLINK_WEBHOOK_EVENTS_COLLECTION", "oscillink_events")
    from oscillink_tpu_torch.service._firestore_stores import FirestoreEventStore

    es = FirestoreEventStore()
    es.put("evt_2", {"id": "evt_2", "n": 1})
    es.put("evt_2", {"id": "evt_2", "n": 2})  # must NOT overwrite
    assert es.get("evt_2")["n"] == 1
