"""Synthetic corpus + embedding generation matched to the paper's Table IV.

The port's own copy of the reference generator: the same numpy calls in the
same order, so one :class:`CorpusSpec` gives bit-identical arrays in both
packages.  Only the final :class:`~repro_torch.data.docs.DocSet` differs: its
tensors live on ``device``.

Generator model: a topic mixture.  Each of ``n_classes`` topics owns a
Zipf-weighted slice of the vocabulary; a document samples its words from its
topic's slice (with probability 1-noise) or the global vocabulary (noise).
Embeddings place each topic's words around a topic centroid, so word-level
distances encode the label structure, as word2vec does for news.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.docs import DocSet, make_docset


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    n_docs: int = 1024
    vocab_size: int = 4096
    emb_dim: int = 64
    h_max: int = 32           # ELL padding width
    mean_h: float = 16.0      # mean unique words per doc (paper: 27.5/107.5)
    n_classes: int = 8
    topic_noise: float = 0.25
    zipf_a: float = 1.3
    emb_topic_scale: float = 4.0   # topic-centroid separation
    emb_word_scale: float = 1.0    # within-topic spread
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Corpus:
    docs: DocSet            # (n, h_max) ELL histograms, L1-normalized
    labels: np.ndarray      # (n,) int32 topic labels
    emb: np.ndarray         # (vocab_size, emb_dim) f32 "word2vec" embeddings
    spec: CorpusSpec


def make_corpus(spec: CorpusSpec, *, device=None) -> Corpus:
    rng = np.random.default_rng(spec.seed)
    v, d, n = spec.vocab_size, spec.emb_dim, spec.n_docs

    # --- embeddings: topic centroids + word-level jitter ------------------
    word_topic = rng.integers(0, spec.n_classes, size=v)
    centroids = rng.normal(0.0, spec.emb_topic_scale, size=(spec.n_classes, d))
    emb = centroids[word_topic] + rng.normal(0.0, spec.emb_word_scale, size=(v, d))
    emb = emb.astype(np.float32)

    # --- per-topic Zipf word distributions --------------------------------
    topic_words = [np.where(word_topic == c)[0] for c in range(spec.n_classes)]
    for tw in topic_words:
        rng.shuffle(tw)

    labels = rng.integers(0, spec.n_classes, size=n).astype(np.int32)
    ids = np.zeros((n, spec.h_max), dtype=np.int32)
    weights = np.zeros((n, spec.h_max), dtype=np.float32)

    # Document lengths: clipped Poisson around mean_h (>=2, <= h_max).
    lengths = np.clip(rng.poisson(spec.mean_h, size=n), 2, spec.h_max)

    for i in range(n):
        c = labels[i]
        tw = topic_words[c]
        h = lengths[i]
        # Zipf ranks within the topic slice; noise words uniform over vocab.
        n_topic = max(1, int(round(h * (1.0 - spec.topic_noise))))
        ranks = rng.zipf(spec.zipf_a, size=4 * n_topic) - 1
        ranks = ranks[ranks < len(tw)][:n_topic]
        chosen = tw[ranks] if len(ranks) else tw[:1]
        n_noise = h - len(np.unique(chosen))
        noise = rng.integers(0, v, size=max(n_noise, 0))
        words, counts = np.unique(np.concatenate([chosen, noise]), return_counts=True)
        order = np.argsort(-counts)[: spec.h_max]
        words, counts = words[order], counts[order]
        ids[i, : len(words)] = words
        weights[i, : len(words)] = counts

    docs = make_docset(np.where(weights > 0, ids, -1), weights, device=device)
    return Corpus(docs=docs, labels=labels, emb=emb, spec=spec)


def make_bimodal_corpus(spec: CorpusSpec, *, device=None) -> Corpus:
    """Centroid-degenerate corpus: WCD-blind, RWMD-separable classes.

    Each class ``c`` owns TWO word clusters placed antipodally at ``±u_c``,
    and every document draws its words in balanced halves from both
    clusters, so all document centroids collapse to ≈0 regardless of class
    while word-level min-matching still separates classes.
    """
    rng = np.random.default_rng(spec.seed)
    v, d, n = spec.vocab_size, spec.emb_dim, spec.n_docs

    dirs = rng.normal(size=(spec.n_classes, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs *= spec.emb_topic_scale

    # Vocab: class-major slices, each split into a +cluster and a −cluster.
    word_class = np.arange(v) % spec.n_classes
    word_sign = np.where((np.arange(v) // spec.n_classes) % 2 == 0, 1.0, -1.0)
    emb = (word_sign[:, None] * dirs[word_class]
           + rng.normal(0.0, spec.emb_word_scale, size=(v, d)))
    emb = emb.astype(np.float32)

    labels = rng.integers(0, spec.n_classes, size=n).astype(np.int32)
    ids = np.zeros((n, spec.h_max), dtype=np.int32)
    weights = np.zeros((n, spec.h_max), dtype=np.float32)
    lengths = np.clip(rng.poisson(spec.mean_h, size=n), 4, spec.h_max)
    class_words = [np.nonzero(word_class == c)[0] for c in range(spec.n_classes)]
    for i in range(n):
        cw = class_words[labels[i]]
        pos = cw[word_sign[cw] > 0]
        neg = cw[word_sign[cw] < 0]
        h = lengths[i]
        n_noise = int(round(h * spec.topic_noise))
        # Clamp to the cluster populations: tiny vocab/class splits must not
        # over-draw a without-replacement sample.
        half = max(1, min((h - n_noise) // 2, len(pos), len(neg)))
        chosen = np.concatenate([
            rng.choice(pos, size=half, replace=False),
            rng.choice(neg, size=half, replace=False),
            rng.integers(0, v, size=n_noise),
        ])
        words, counts = np.unique(chosen, return_counts=True)
        order = np.argsort(-counts)[: spec.h_max]
        words, counts = words[order], counts[order]
        ids[i, : len(words)] = words
        weights[i, : len(words)] = counts
    docs = make_docset(np.where(weights > 0, ids, -1), weights, device=device)
    return Corpus(docs=docs, labels=labels, emb=emb, spec=spec)


def table_iv_spec(which: str, scale: float = 1.0) -> CorpusSpec:
    """Paper Table IV statistics, shrunk by ``scale``.

    Set 1: n=1M, mean h=107.5, v_e=452,058.
    Set 2: n=2.8M, mean h=27.5, v_e=292,492.
    """
    if which == "set1":
        return CorpusSpec(
            n_docs=max(64, int(1_000_000 * scale)),
            vocab_size=max(512, int(452_058 * scale)),
            emb_dim=300, h_max=160, mean_h=107.5, n_classes=16,
        )
    if which == "set2":
        return CorpusSpec(
            n_docs=max(64, int(2_800_000 * scale)),
            vocab_size=max(512, int(292_492 * scale)),
            emb_dim=300, h_max=48, mean_h=27.5, n_classes=16,
        )
    raise ValueError(which)
