"""Typo autocorrect that preserves technical tokens and code.

Behavioral contract (counterpart of the reference preprocess/autocorrect.py):
  * only words in the curated typo map are corrected (case-insensitive);
  * acronyms, snake_case, camelCase, digit-bearing, code-like, URL/email and
    non-ASCII tokens are left untouched;
  * original casing (UPPER / Title / lower) carries over to the replacement;
  * Markdown ``` fences toggle a no-touch region;
  * tokens are space-delimited with surrounding punctuation stripped before
    lookup and re-attached after.
"""

from __future__ import annotations

import re
from typing import List, Optional

__all__ = ["smart_correct", "COMMON_TYPOS"]

# Curated common-typo corrections (data parity with the reference list).
_TYPO_PAIRS = (
    ("teh", "the"),
    ("recieve", "receive"),
    ("seperate", "separate"),
    ("definately", "definitely"),
    ("occured", "occurred"),
    ("accomodate", "accommodate"),
    ("acheive", "achieve"),
    ("adress", "address"),
    ("becuase", "because"),
    ("comming", "coming"),
    ("enviroment", "environment"),
    ("goverment", "government"),
    ("independant", "independent"),
    ("occuring", "occurring"),
    ("occurence", "occurrence"),
    ("publically", "publicly"),
    ("seperately", "separately"),
    ("wich", "which"),
)
COMMON_TYPOS = dict(_TYPO_PAIRS)

# A token is left alone when any of these hold.
_TECHNICAL = re.compile(
    r"^[A-Z]{2,}$"  # acronym
    r"|^[A-Za-z]+_[A-Za-z0-9_]+$"  # snake_case
    r"|^[A-Za-z]+[A-Z][A-Za-z0-9]+$"  # camel/Pascal case
    r"|.*\d"  # digits anywhere
    r"|.*[()\[\]{}<>`]"  # code punctuation
)

_DEFAULT_PRESERVE = frozenset(
    {"Oscillink", "lamG", "lamC", "lamQ", "SPD", "kNN", "k-NN", "API", "LLM", "FFT"}
)

# leading / core / trailing punctuation split
_EDGES = re.compile(r"^([,.!?;:\"'’”()\[\]{}]*)(.*?)([,.!?;:\"'’”()\[\]{}]*)$", re.S)
_FENCE = re.compile(r"^\s*```")


def _carry_case(template: str, replacement: str) -> str:
    if template.isupper():
        return replacement.upper()
    if template.istitle():
        return replacement.title()
    return replacement


def _corrected(token: str, preserve: frozenset) -> str:
    if not token:
        return token
    m = _EDGES.match(token)
    lead, core, trail = m.group(1), m.group(2), m.group(3)
    untouchable = (
        not core
        or core in preserve
        or "://" in core
        or "@" in core
        or not core.isascii()
        or _TECHNICAL.match(core) is not None
    )
    if untouchable:
        return token
    fix = COMMON_TYPOS.get(core.lower())
    return token if fix is None else lead + _carry_case(core, fix) + trail


def smart_correct(text: str, custom_preserve: Optional[List[str]] = None) -> str:
    """Correct common typos while preserving technical terms and code."""
    preserve = (
        _DEFAULT_PRESERVE | frozenset(custom_preserve)
        if custom_preserve
        else _DEFAULT_PRESERVE
    )

    result: List[str] = []
    inside_fence = False
    for line in text.splitlines():
        if _FENCE.match(line):
            inside_fence = not inside_fence
            result.append(line)
        elif inside_fence:
            result.append(line)
        else:
            result.append(" ".join(_corrected(t, preserve) for t in line.split(" ")))
    return "\n".join(result)

