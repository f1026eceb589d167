"""Universal model adapter: provider registry + content-hash cache (the
port's own copy of ``oscillink_tpu/adapters/registry.py``; its hash
provider goes through the port's byte-compatible `adapters.text`).

The reference plans this as the `oscillink-adapters` package
(docs/guides/ROADMAP.md Phase 2 item 2: "Auto-detect embedding providers
(OpenAI, Cohere, Anthropic, Hugging Face, local); automatic normalization
to unit vectors in L2 space; content-hash based caching with TTL; provider
registry with dtype/shape validation; pluggable backends") but never ships
it.  Implemented here:

  * `register_provider` / `resolve_provider`: a name -> factory registry;
    third-party backends plug in without touching this module;
  * shipped providers: `hash` (deterministic SHA-256-seeded unit vectors —
    zero dependencies), `st` (sentence-transformers, offline-fail-fast),
    `lsa` (corpus-trained TF-IDF+SVD, `adapters/lsa.py`), and API-key
    providers `openai` / `cohere` / `anthropic` / `huggingface` that
    resolve lazily and raise actionable errors when their package or key
    is absent (this image has no egress — they exist so deployments with
    credentials get them by name, and so auto-detection can consider them);
  * `auto_detect()`: explicit `OSCILLINK_EMBED_PROVIDER` env wins, then
    API-key providers whose package+key are BOTH present, then local
    sentence-transformers, then the hash fallback — mirroring the
    reference's detection order (managed APIs > local model > fallback);
  * every provider's output passes through dtype/shape validation and
    (by default) L2 unit normalization;
  * `CachedEmbedder`: per-text content-hash cache (SHA-256 of
    provider/model/text) with TTL and an LRU size bound, so repeated and
    partially-overlapping batches only pay for new texts.
"""

from __future__ import annotations

import hashlib
import os
import time
from collections import OrderedDict
from typing import Callable, Iterable, Optional, Protocol

import numpy as np

__all__ = [
    "EmbeddingProvider",
    "register_provider",
    "resolve_provider",
    "available_providers",
    "auto_detect",
    "CachedEmbedder",
]


class EmbeddingProvider(Protocol):
    """Minimal provider surface: a name and a batch embed call."""

    name: str

    def embed(self, texts: list[str]) -> np.ndarray: ...


def _validate(vecs: np.ndarray, n_texts: int, normalize: bool) -> np.ndarray:
    """dtype/shape validation + optional L2 unit normalization (the
    registry contract: every provider's output passes through here)."""
    vecs = np.asarray(vecs)
    if vecs.ndim != 2 or vecs.shape[0] != n_texts:
        raise ValueError(
            f"provider returned shape {vecs.shape}, expected ({n_texts}, D)"
        )
    if not np.issubdtype(vecs.dtype, np.floating):
        raise ValueError(f"provider returned dtype {vecs.dtype}, expected float")
    vecs = vecs.astype(np.float32, copy=False)
    if not np.isfinite(vecs).all():
        raise ValueError("provider returned non-finite embeddings")
    if normalize:
        vecs = vecs / (np.linalg.norm(vecs, axis=1, keepdims=True) + 1e-12)
    return vecs


class _ValidatedProvider:
    """Wrap a raw provider with the validation/normalization contract.

    ``cache_tag`` distinguishes providers of the same backend with
    different models (``hash:256`` vs ``hash:384``) so `CachedEmbedder`
    keys never collide across embedding spaces; defaults to ``name``."""

    def __init__(self, name: str, fn: Callable[[list[str]], np.ndarray],
                 normalize: bool = True, cache_tag: Optional[str] = None):
        self.name = name
        self.cache_tag = cache_tag or name
        self._fn = fn
        self._normalize = normalize

    def embed(self, texts: Iterable[str]) -> np.ndarray:
        texts_list = list(texts)
        if not texts_list:
            return np.zeros((0, 0), dtype=np.float32)
        return _validate(self._fn(texts_list), len(texts_list), self._normalize)


# ---------------------------------------------------------------------- #
# shipped providers

def _hash_provider(model: Optional[str] = None) -> _ValidatedProvider:
    from .text import simple_text_embed

    d = int(model) if model else 384  # "hash:256" -> 256-dim
    return _ValidatedProvider("hash", lambda ts: simple_text_embed(ts, d=d),
                              cache_tag=f"hash:{d}")


def _st_provider(model: Optional[str] = None) -> _ValidatedProvider:
    from .text import _load_st_model

    name = model or "sentence-transformers/all-MiniLM-L6-v2"
    m = _load_st_model(name)
    if m is None:
        raise RuntimeError(
            "sentence-transformers unavailable (not installed, disabled via "
            "OSCILLINK_DISABLE_ST, or model not cached offline)"
        )

    def fn(ts):  # pragma: no cover — optional dependency
        return m.encode(ts, show_progress_bar=False, convert_to_numpy=True)

    return _ValidatedProvider("st", fn, cache_tag=f"st:{name}")


def _lsa_provider(model: Optional[str] = None) -> _ValidatedProvider:
    """Corpus-trained LSA; fits lazily on the FIRST batch it sees (callers
    embedding a corpus then queries get consistent spaces)."""
    from .lsa import LSAEmbedder

    emb = LSAEmbedder(dim=int(model) if model else 64)
    state = {"fitted": False}

    def fn(ts):
        if not state["fitted"]:
            state["fitted"] = True
            return emb.fit(ts)
        return emb.embed(ts)

    # each LSA instance is its own embedding space (corpus-fit), so the
    # cache tag carries the instance identity, not just the dim
    return _ValidatedProvider("lsa", fn, cache_tag=f"lsa:{emb.dim}:{id(emb)}")


def _api_provider(pkg: str, key_env: str, default_model: str,
                  call: Callable) -> Callable[[Optional[str]], _ValidatedProvider]:
    """Factory-factory for API-key providers: lazy import + key check with
    actionable errors (no egress in this image — these are for deployments
    with credentials)."""

    def factory(model: Optional[str] = None) -> _ValidatedProvider:
        import importlib.util

        if importlib.util.find_spec(pkg) is None:
            raise RuntimeError(f"provider needs the '{pkg}' package installed")
        if not os.getenv(key_env):
            raise RuntimeError(f"provider needs {key_env} set")
        mod = __import__(pkg)
        mdl = model or default_model
        return _ValidatedProvider(pkg, lambda ts: call(mod, mdl, ts),
                                  cache_tag=f"{pkg}:{mdl}")

    return factory


def _openai_call(mod, model, texts):  # pragma: no cover — needs egress
    rsp = mod.OpenAI().embeddings.create(model=model, input=texts)
    return np.asarray([d.embedding for d in rsp.data], dtype=np.float32)


def _cohere_call(mod, model, texts):  # pragma: no cover — needs egress
    rsp = mod.Client().embed(texts=texts, model=model)
    return np.asarray(rsp.embeddings, dtype=np.float32)


def _anthropic_call(mod, model, texts):  # pragma: no cover — needs egress
    raise RuntimeError(
        "anthropic exposes no embeddings endpoint; use a supported provider"
    )


def _hf_call(mod, model, texts):  # pragma: no cover — optional dependency
    import torch
    from transformers import AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model)
    net = AutoModel.from_pretrained(model)
    with torch.no_grad():
        out = net(**tok(texts, padding=True, truncation=True,
                        return_tensors="pt"))
    return out.last_hidden_state.mean(dim=1).numpy()


_REGISTRY: dict[str, Callable[[Optional[str]], _ValidatedProvider]] = {
    "hash": _hash_provider,
    "st": _st_provider,
    "lsa": _lsa_provider,
    "openai": _api_provider("openai", "OPENAI_API_KEY",
                            "text-embedding-3-small", _openai_call),
    "cohere": _api_provider("cohere", "COHERE_API_KEY",
                            "embed-english-v3.0", _cohere_call),
    "anthropic": _api_provider("anthropic", "ANTHROPIC_API_KEY",
                               "", _anthropic_call),
    "huggingface": _api_provider("transformers", "HF_TOKEN",
                                 "sentence-transformers/all-MiniLM-L6-v2",
                                 _hf_call),
}


def register_provider(
    name: str, factory: Callable[[Optional[str]], EmbeddingProvider]
) -> None:
    """Plug in a backend: ``factory(model_or_None) -> provider``.  The
    provider's output still passes dtype/shape validation at resolve time
    if it is built through `_ValidatedProvider`; custom factories are
    trusted to validate their own output or wrap with `_ValidatedProvider`."""
    _REGISTRY[name] = factory


def available_providers() -> list[str]:
    return sorted(_REGISTRY)


def resolve_provider(spec: Optional[str] = None) -> EmbeddingProvider:
    """Resolve ``"name"`` or ``"name:model"`` to a ready provider; with no
    spec, fall through to `auto_detect`."""
    if spec is None:
        spec = os.getenv("OSCILLINK_EMBED_PROVIDER") or ""
    if not spec:
        return auto_detect()
    name, _, model = spec.partition(":")
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown embedding provider {name!r}; available: "
            f"{available_providers()}"
        )
    return _REGISTRY[name](model or None)


def auto_detect() -> EmbeddingProvider:
    """Detection order (reference roadmap: managed APIs > local > fallback):
    API-key providers whose package AND key are both present, then local
    sentence-transformers, then the zero-dependency hash fallback."""
    import importlib.util

    for name, pkg, key in (
        ("openai", "openai", "OPENAI_API_KEY"),
        ("cohere", "cohere", "COHERE_API_KEY"),
    ):
        if importlib.util.find_spec(pkg) is not None and os.getenv(key):
            return _REGISTRY[name](None)
    try:
        return _REGISTRY["st"](None)
    except RuntimeError:
        return _REGISTRY["hash"](None)


class CachedEmbedder:
    """Content-hash TTL cache over any provider (roadmap: "content-hash
    based caching with TTL").  Keys are SHA-256 of provider/model/text;
    hits are per TEXT, so a batch overlapping earlier batches only pays
    the provider for its new texts.  Bounded LRU; expired entries re-embed."""

    def __init__(self, provider: EmbeddingProvider, *, ttl_s: float = 3600.0,
                 max_items: int = 65536,
                 clock: Callable[[], float] = time.monotonic):
        self.provider = provider
        self.ttl_s = float(ttl_s)
        self.max_items = int(max_items)
        self._clock = clock
        self._store: OrderedDict[str, tuple[float, np.ndarray]] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def _key(self, text: str) -> str:
        # cache_tag folds the model in (hash:256 vs hash:384 never collide);
        # bare .name is the fallback for third-party providers without one
        prov = getattr(self.provider, "cache_tag", None) or self.provider.name
        return hashlib.sha256(f"{prov}\x00{text}".encode("utf-8")).hexdigest()

    def embed(self, texts: Iterable[str]) -> np.ndarray:
        texts_list = list(texts)
        if not texts_list:
            return np.zeros((0, 0), dtype=np.float32)
        now = self._clock()
        keys = [self._key(t) for t in texts_list]
        out: list[Optional[np.ndarray]] = [None] * len(texts_list)
        missing: list[int] = []
        for i, k in enumerate(keys):
            entry = self._store.get(k)
            if entry is not None and now - entry[0] <= self.ttl_s:
                self._store.move_to_end(k)
                out[i] = entry[1]
                self.hits += 1
            else:
                missing.append(i)
                self.misses += 1
        if missing:
            fresh = self.provider.embed([texts_list[i] for i in missing])
            for j, i in enumerate(missing):
                out[i] = fresh[j]
                self._store[keys[i]] = (now, fresh[j])
                self._store.move_to_end(keys[i])
            while len(self._store) > self.max_items:
                self._store.popitem(last=False)
        return np.stack(out, axis=0)
