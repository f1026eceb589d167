"""Text embedding adapters (reference: oscillink/adapters/text.py).

`simple_text_embed` produces deterministic SHA-256-seeded Gaussian unit
vectors — the exact scheme the reference benchmarks rely on (text.py:12-23),
so quality harness results (facts+traps, competitor) are comparable.
`embed_texts` prefers sentence-transformers when installed, falling back to
the hash embeddings.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from importlib import import_module
from importlib.util import find_spec
from typing import Iterable, List

import numpy as np

__all__ = ["simple_text_embed", "embed_texts"]


def simple_text_embed(texts: list[str], d: int = 384) -> np.ndarray:
    """Deterministic hash-based unit embeddings."""
    out = np.zeros((len(texts), d), dtype=np.float32)
    for i, t in enumerate(texts):
        h = hashlib.sha256(t.encode("utf-8")).digest()
        seed = int.from_bytes(h[:8], "little", signed=False) % (2**31 - 1)
        rs = np.random.RandomState(seed)
        v = rs.randn(d).astype(np.float32)
        out[i] = v / (np.linalg.norm(v) + 1e-12)
    return out


@lru_cache(maxsize=2)
def _load_st_model(model_name: str):
    try:  # pragma: no cover — optional dependency
        import os

        if os.getenv("OSCILLINK_DISABLE_ST", "0") in {"1", "true"}:
            return None
        if find_spec("sentence_transformers") is None:
            return None
        # fail fast offline instead of the hub's multi-minute retry loop
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        mod = import_module("sentence_transformers")
        cls = getattr(mod, "SentenceTransformer", None)
        return None if cls is None else cls(model_name)
    except Exception:  # pragma: no cover
        return None


def embed_texts(
    texts: Iterable[str],
    model_name: str = "sentence-transformers/all-MiniLM-L6-v2",
    fallback_dim: int = 384,
    normalize: bool = True,
) -> np.ndarray:
    """Embed texts via sentence-transformers when available, else hash fallback."""
    texts_list: List[str] = list(texts)
    if not texts_list:
        return np.zeros((0, fallback_dim), dtype=np.float32)

    model = _load_st_model(model_name)
    if model is not None:  # pragma: no cover — optional dependency
        try:
            vecs = model.encode(
                texts_list,
                show_progress_bar=False,
                convert_to_numpy=True,
                normalize_embeddings=normalize,
            )
            return vecs.astype(np.float32)
        except Exception:
            pass

    # hash embeddings are unit-norm by construction, so normalize is a
    # no-op on this fallback path (it only matters for the ST path above)
    return simple_text_embed(texts_list, d=fallback_dim)
