"""Input adapters: text embedding helpers + the provider registry."""

from .registry import (  # noqa: F401
    CachedEmbedder,
    auto_detect,
    available_providers,
    register_provider,
    resolve_provider,
)
from .text import embed_texts, simple_text_embed  # noqa: F401
