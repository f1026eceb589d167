"""Opt-in cross-request graph cache: repeat queries over the same corpus
skip the O(N^2 D) similarity scan and the window-plan build.

The reference's service is deliberately stateless — "embeddings discarded
post response" (reference docs/cloud/CLOUD_ARCH_GCP.md:29) — so this cache
is OFF by default and opt-in via `OSCILLINK_GRAPH_CACHE_SIZE` (> 0 enables;
entries) + `OSCILLINK_GRAPH_CACHE_TTL` (seconds, default 300).  What is
retained on a hit is the derived k-sparse graph (neighbor ids/weights/
degrees) and window plan — not the anchor embeddings themselves — but the
graph is still derived tenant data: the cache is keyed per api key so one
tenant can never be served another tenant's graph, even on a hash
collision of public corpora.

Key = SHA-256 of (Y-hash, k_eff, row_cap, deterministic_k, neighbor_seed,
resolved similarity).  The Y-hash is the FULL (unsampled) anchor content
hash (`OscillinkLattice._hash_anchors(Y, full=True)`) — the lattice's own
sampled fingerprint is lossy above 128 MiB, and a cache key must never
collide for corpora differing only in rows the stride skips.  Every
parameter that changes the built graph is in the key, so a hit is
behaviorally identical to a rebuild (same graph token -> same state
signatures -> same receipts).

Serving pattern this exists for: RAG corpora are long-lived while queries
churn — build once, settle per query.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from .cache import _PerKeyTTLLRU, _env_float, _env_int

__all__ = ["GraphCache", "graph_cache_key"]


def graph_cache_key(
    y_hash: str,
    k_eff: int,
    row_cap: float,
    deterministic_k: bool,
    neighbor_seed: Optional[int],
    similarity: str,
    n: int = -1,
    d: int = -1,
) -> str:
    # deterministic_k / neighbor_seed combinations that build the IDENTICAL
    # graph (e.g. detk=True ignores the seed) still get distinct keys on
    # purpose: the snapshot carries the graph TOKEN, which feeds state_sig
    # and signed receipts and is computed over the RAW params
    # (compute_graph_token) — collapsing keys would serve a token minted
    # under different params and break hit == rebuild behavioral identity.
    # (n, d) are in the key because the full=True anchor hash covers raw
    # bytes only — two corpora with identical bytes but different (N, D)
    # (realistic with constant-filled embeddings where N*D matches) must
    # never share a graph (ADVICE r4).
    raw = (
        f"{y_hash}:{n}x{d}:{k_eff}:{row_cap}:{int(bool(deterministic_k))}:"
        f"{neighbor_seed}:{similarity}"
    )
    return hashlib.sha256(raw.encode()).hexdigest()


class GraphCache(_PerKeyTTLLRU):
    """Keyed by (api_key, graph_cache_key); OFF unless
    `OSCILLINK_GRAPH_CACHE_SIZE` > 0."""

    @staticmethod
    def ttl() -> float:
        return _env_float("OSCILLINK_GRAPH_CACHE_TTL", 300.0)

    @staticmethod
    def size() -> int:
        return _env_int("OSCILLINK_GRAPH_CACHE_SIZE", 0)

    @staticmethod
    def global_bound() -> int:
        # Snapshots pin device memory (the graph's neighbor/weight/degree
        # tensors + window plan), so OSCILLINK_GRAPH_CACHE_SIZE bounds TOTAL entries
        # across api keys — not per key like the small host-side caches.
        return GraphCache.size()

    @staticmethod
    def enabled() -> bool:
        return GraphCache.size() > 0 and GraphCache.ttl() > 0

    def get_snapshot(self, api_key: Optional[str], key: str) -> Optional[dict]:
        # access-driven expiry (jobs.purge idiom): device buffers must not
        # stay pinned past TTL waiting for the every-256-puts sweep
        self.sweep_expired()
        rec = self._get(api_key, key)
        return rec["snap"] if rec else None

    def put_snapshot(self, api_key: Optional[str], key: str, snap: dict) -> None:
        self.sweep_expired()
        self._put(api_key, key, {"snap": snap})
