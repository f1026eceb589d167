"""Latent semantic analysis embeddings trained locally on a corpus (the
port's own copy of ``oscillink_tpu/adapters/lsa.py``).

This is the repo's REAL-text embedding model for egress-free retrieval
evaluation (BASELINE.md quality table; reference evaluates with
sentence-transformer embeddings it downloads — this image has no egress, so
the model is *learned from the corpus itself*): TF-IDF term weighting
followed by truncated SVD.  Unlike the hash fallback in `adapters/text.py`
(random projections with NO linguistic structure), LSA vectors place
semantically related passages near each other because they share and
co-occur with the same terms — the property retrieval quality actually
depends on.

Pure NumPy; deterministic; fits in milliseconds at corpus sizes of 10^2-10^4
documents.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["LSAEmbedder"]

_TOKEN_RE = re.compile(r"[a-z0-9]+")

# minimal English stopword list — high-frequency glue words that carry no
# topical signal and would otherwise dominate the co-occurrence structure
_STOPWORDS = frozenset(
    """a an and are as at be been by for from had has have in into is it its
    of on or that the their this to was were which with they she he we you
    not no than then there these those but if only also most more over about
    such through each other between because while during where when how what
    who can could would should may might will shall do does did done being
    all any some one two after before up down out very much many called
    known often usually""".split()
)


def _tokenize(text: str) -> List[str]:
    return [t for t in _TOKEN_RE.findall(text.lower()) if t not in _STOPWORDS]


class LSAEmbedder:
    """TF-IDF + truncated-SVD document/query embedder.

    fit(corpus_texts) learns the vocabulary, IDF weights and the SVD basis;
    embed(texts) folds new text into the latent space (q_hat = q_tfidf @ V),
    L2-normalized.  ``dim`` is clipped to the achievable rank.
    """

    def __init__(self, dim: int = 64, min_df: int = 1):
        self.dim = int(dim)
        self.min_df = int(min_df)
        self.vocab: Dict[str, int] = {}
        self.idf: np.ndarray | None = None
        self.basis: np.ndarray | None = None  # [n_terms, dim] = V_k

    # -- training ---------------------------------------------------------

    def _tfidf_matrix(self, texts: Sequence[str]) -> np.ndarray:
        n_docs = len(texts)
        tf = np.zeros((n_docs, len(self.vocab)), dtype=np.float64)
        for i, text in enumerate(texts):
            for tok in _tokenize(text):
                j = self.vocab.get(tok)
                if j is not None:
                    tf[i, j] += 1.0
        # sublinear tf, standard smooth idf
        tf = np.log1p(tf)
        return tf * self.idf[None, :]

    def fit(self, texts: Sequence[str]) -> np.ndarray:
        """Learn vocab/IDF/basis; returns the corpus embeddings [N, dim]."""
        df: Dict[str, int] = {}
        for text in texts:
            for tok in set(_tokenize(text)):
                df[tok] = df.get(tok, 0) + 1
        terms = sorted(t for t, c in df.items() if c >= self.min_df)
        self.vocab = {t: j for j, t in enumerate(terms)}
        n_docs = len(texts)
        self.idf = np.array(
            [1.0 + np.log((1 + n_docs) / (1 + df[t])) for t in terms],
            dtype=np.float64,
        )
        X = self._tfidf_matrix(texts)  # [N, T]
        # deterministic truncated SVD (dense is fine at corpus scale)
        U, S, Vt = np.linalg.svd(X, full_matrices=False)
        k = min(self.dim, int(np.sum(S > 1e-10)))
        self.basis = np.ascontiguousarray(Vt[:k].T)  # [T, k]
        emb = U[:, :k] * S[None, :k]
        return _l2(emb).astype(np.float32)

    # -- inference --------------------------------------------------------

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        if self.basis is None:
            raise RuntimeError("LSAEmbedder.fit must run first")
        X = self._tfidf_matrix(texts)
        return _l2(X @ self.basis).astype(np.float32)


def _l2(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
