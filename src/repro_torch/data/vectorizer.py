"""Text ingestion: tokenizer + hashing vectorizer -> ELL DocSets (the port's
copy of ``repro.data.vectorizer``).

The paper's system ingests news documents into term-frequency histograms
over a (up to 3M-word) vocabulary. This module provides the real-text path:
a deterministic word tokenizer, a build-or-hash vocabulary, and histogram
construction with stop-word removal (the paper's h excludes stop-words).

Serving path: each vectorizer's ``query_histogram`` is the ``preprocess``
hook shape the query servers expect — and it REJECTS queries that tokenize
to zero in-vocabulary words with a typed
:class:`~repro_torch.serving.errors.PoisonQuery` at submit time, instead of
letting an all-zero weight vector ride into (and NaN-poison) a device
batch.

numpy only at import time: the vectorizers pickle by reference into the
ingest pool's spawned workers, which must not import torch.  Only
``corpus_to_docset`` / ``transform`` build a torch :class:`DocSet`, on the
device the caller names (``None`` → ``"cuda"``), importing torch when
called.
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def _reject_empty(w: np.ndarray, text: str) -> None:
    """Raise a typed PoisonQuery for a zero-in-vocab query histogram.

    Imported lazily so the data layer stays import-light; the serving
    errors module itself is dependency-free.
    """
    if not (w > 0).any():
        from repro_torch.serving.errors import PoisonQuery
        raise PoisonQuery(
            "query tokenizes to zero in-vocabulary words "
            f"(stop-words/OOV only): {text[:60]!r}")

# Minimal english stop list (the paper excludes stop-words from h).
STOP_WORDS = frozenset(
    "a an and are as at be by for from has he in is it its of on that the to "
    "was were will with this these those i you they we she his her them our "
    "not or but if then than so no yes do does did done have had having".split()
)


def tokenize(text: str) -> list[str]:
    return [t for t in _TOKEN_RE.findall(text.lower())
            if t not in STOP_WORDS and len(t) > 1]


@dataclasses.dataclass
class HashingVectorizer:
    """Stateless vocabulary via hashing (the production path for unbounded
    vocabularies; the paper's v_e restriction happens downstream via
    ``restrict_vocab``)."""

    n_features: int = 1 << 20
    h_max: int = 64

    def word_id(self, word: str) -> int:
        h = 2166136261
        for ch in word.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return int(h % self.n_features)

    def doc_to_histogram(self, text: str) -> tuple[np.ndarray, np.ndarray]:
        counts = Counter(self.word_id(t) for t in tokenize(text))
        items = counts.most_common(self.h_max)
        ids = np.full(self.h_max, -1, np.int32)
        w = np.zeros(self.h_max, np.float32)
        for i, (wid, c) in enumerate(items):
            ids[i] = wid
            w[i] = c
        return ids, w

    def corpus_to_docset(self, texts: list[str], *, device=None):
        """A :class:`~repro_torch.data.docs.DocSet` of ``texts`` on
        ``device``."""
        from repro_torch.data.docs import make_docset

        ids = np.stack([self.doc_to_histogram(t)[0] for t in texts])
        w = np.stack([self.doc_to_histogram(t)[1] for t in texts])
        return make_docset(ids, w, device=device)

    def query_histogram(self, text: str) -> tuple[np.ndarray, np.ndarray]:
        """Vectorize ONE serving query (``preprocess`` hook shape).

        Raises :class:`~repro_torch.serving.errors.PoisonQuery` when the text
        tokenizes to zero in-vocabulary words — the all-zero histogram can
        never be served and must not reach a device batch.
        """
        ids, w = self.doc_to_histogram(text)
        _reject_empty(w, text)
        return ids, w


@dataclasses.dataclass
class VocabVectorizer:
    """Explicit vocabulary (fit on the resident corpus — gives the exact v_e
    semantics of the paper; OOV query words are dropped)."""

    h_max: int = 64

    def __post_init__(self):
        self.vocab: dict[str, int] = {}

    def fit(self, texts: list[str]) -> "VocabVectorizer":
        for t in texts:
            for w in tokenize(t):
                if w not in self.vocab:
                    self.vocab[w] = len(self.vocab)
        return self

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def transform(self, texts: list[str], *, device=None):
        """A :class:`~repro_torch.data.docs.DocSet` of ``texts`` on
        ``device``."""
        from repro_torch.data.docs import make_docset

        n = len(texts)
        ids = np.full((n, self.h_max), -1, np.int32)
        w = np.zeros((n, self.h_max), np.float32)
        for i, t in enumerate(texts):
            counts = Counter(self.vocab[x] for x in tokenize(t)
                             if x in self.vocab)
            for j, (wid, c) in enumerate(counts.most_common(self.h_max)):
                ids[i, j] = wid
                w[i, j] = c
        return make_docset(ids, w, device=device)

    def query_histogram(self, text: str) -> tuple[np.ndarray, np.ndarray]:
        """Vectorize ONE serving query (``preprocess`` hook shape).

        OOV words are dropped per the paper's v_e semantics; a query whose
        every word is OOV (or a stop-word) raises a typed
        :class:`~repro_torch.serving.errors.PoisonQuery` instead of producing an
        all-zero histogram.
        """
        counts = Counter(self.vocab[x] for x in tokenize(text)
                         if x in self.vocab)
        ids = np.full(self.h_max, -1, np.int32)
        w = np.zeros(self.h_max, np.float32)
        for j, (wid, c) in enumerate(counts.most_common(self.h_max)):
            ids[j] = wid
            w[j] = c
        _reject_empty(w, text)
        return ids, w
