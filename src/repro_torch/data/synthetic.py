"""Procedurally-generated offline datasets.

The container has no dataset downloads (repro band: data gates simulated),
so the paper's MNIST/CIFAR-10 experiments run on a synthetic 10-class
"image" task with controllable difficulty, and the LM training examples use
a topic-mixture token corpus.  The *heterogeneity mechanism* (Dirichlet
splits) is identical to the paper's.
"""
from __future__ import annotations

import numpy as np


def make_classification(n_samples: int = 20_000, n_classes: int = 10,
                        dim: int = 64, noise: float = 1.0, seed: int = 0
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian class prototypes pushed through a fixed random deformation —
    linearly separable-ish but benefits from a nonlinear model."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, dim)) * 2.0
    labels = rng.integers(0, n_classes, size=n_samples)
    x = protos[labels] + rng.normal(size=(n_samples, dim)) * noise
    # fixed nonlinear deformation (shared across classes)
    w = rng.normal(size=(dim, dim)) / np.sqrt(dim)
    x = np.tanh(x @ w) + 0.1 * x
    return x.astype(np.float32), labels.astype(np.int32)


def make_lm_corpus(n_tokens: int = 2_000_000, vocab: int = 512,
                   n_topics: int = 10, seq_len: int = 128, seed: int = 0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Topic-mixture bigram-ish corpus: returns (sequences (N, L) int32,
    topic label per sequence (N,)) — topics play the role of classes for
    Dirichlet heterogeneity."""
    rng = np.random.default_rng(seed)
    n_seq = n_tokens // seq_len
    topics = rng.integers(0, n_topics, size=n_seq)
    # per-topic unigram distribution concentrated on a vocab slice
    probs = np.full((n_topics, vocab), 0.1 / vocab)
    span = vocab // n_topics
    for t in range(n_topics):
        probs[t, t * span:(t + 1) * span] += 0.9 / span
    probs /= probs.sum(axis=1, keepdims=True)
    seqs = np.stack([
        rng.choice(vocab, size=seq_len, p=probs[t]) for t in topics
    ])
    return seqs.astype(np.int32), topics.astype(np.int32)
