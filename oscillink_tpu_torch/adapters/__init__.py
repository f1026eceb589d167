"""Input adapters: the text embedding helpers (the provider registry of
``oscillink_tpu/adapters`` is not ported yet; ROADMAP.md queue A item 12)."""

from .text import embed_texts, simple_text_embed  # noqa: F401
