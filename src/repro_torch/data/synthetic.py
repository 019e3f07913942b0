"""Synthetic data (numpy; a copy of the parts of ``repro.data.synthetic``
the port needs, so it imports nothing of the JAX package): the Fig-1
image task, the plain prototype task beside it, and the Zipf-Markov
token stream the LM prompts come from.
The same seed gives the same arrays as the JAX package.

CIFAR-10 is replaced by a class-structured synthetic task with the same
tensor shapes (32×32×3, 10 classes): class ``c``'s prototype is mostly
the shared confuser of its energy group plus a small unique part, so
the weighting of the clients decides which class boundaries get
resolved.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticImageDataset(NamedTuple):
    images: np.ndarray  # (D, H, W, C) float32
    labels: np.ndarray  # (D,) int32
    n_classes: int


def make_image_classification(
    seed: int,
    n_examples: int,
    *,
    n_classes: int = 10,
    image_shape: tuple[int, int, int] = (32, 32, 3),
    noise: float = 0.35,
    prototype_smoothness: int = 4,
) -> SyntheticImageDataset:
    """Gaussian-prototype image classification (CIFAR-shaped): each
    class a smooth prototype (a low-resolution random field upsampled),
    samples the prototype of their label plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    h, w, c = image_shape
    lo = max(h // prototype_smoothness, 1)
    protos_lo = rng.normal(size=(n_classes, lo, lo, c)).astype(np.float32)
    reps = (h + lo - 1) // lo
    protos = np.repeat(np.repeat(protos_lo, reps, axis=1), reps,
                       axis=2)[:, :h, :w, :]
    labels = rng.integers(0, n_classes, size=n_examples).astype(np.int32)
    images = protos[labels] + noise * rng.normal(
        size=(n_examples, h, w, c)).astype(np.float32)
    return SyntheticImageDataset(images=images.astype(np.float32),
                                 labels=labels, n_classes=n_classes)


def make_confusable_image_classification(
    seed: int,
    n_examples: int,
    *,
    n_classes: int = 10,
    n_groups: int = 4,
    image_shape: tuple[int, int, int] = (32, 32, 3),
    similarity: float = 0.9,
    noise: float = 0.8,
) -> SyntheticImageDataset:
    """Cross-group confusable class task — the Fig-1 reproduction dataset.

    Class ``c``'s prototype = ``similarity``·(shared confuser of group
    c mod n_groups) + (1−similarity)·(unique part); samples are the
    prototype plus Gaussian noise.
    """
    rng = np.random.default_rng(seed)
    h, w, c = image_shape
    lo = 4
    shared = rng.normal(size=(n_groups, lo, lo, c)).astype(np.float32)
    unique = rng.normal(size=(n_classes, lo, lo, c)).astype(np.float32)

    def up(a):
        reps_h, reps_w = (h + lo - 1) // lo, (w + lo - 1) // lo
        return np.repeat(np.repeat(a, reps_h, 1), reps_w, 2)[:, :h, :w, :]

    protos = up(similarity * shared[np.arange(n_classes) % n_groups]
                + (1 - similarity) * unique)
    labels = rng.integers(0, n_classes, n_examples).astype(np.int32)
    images = protos[labels] + noise * rng.normal(
        size=(n_examples, h, w, c)).astype(np.float32)
    return SyntheticImageDataset(images=images.astype(np.float32),
                                 labels=labels, n_classes=n_classes)


class SyntheticLMDataset(NamedTuple):
    tokens: np.ndarray  # (D, seq_len+1) int32 — shifted inside the model
    vocab: int


def make_lm_tokens(
    seed: int,
    n_sequences: int,
    seq_len: int,
    vocab: int,
    *,
    zipf_a: float = 1.2,
    markov_order: bool = True,
) -> SyntheticLMDataset:
    """Zipf-Markov synthetic token stream.

    Unigram distribution ~ Zipf(a); with ``markov_order`` each token is,
    with probability 0.5, replaced by a deterministic shift of the
    previous one (a cheap bigram structure).
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    base = 1.0 / ranks**zipf_a
    base /= base.sum()
    toks = np.empty((n_sequences, seq_len + 1), dtype=np.int32)
    uni = rng.choice(vocab, size=(n_sequences, seq_len + 1), p=base).astype(np.int32)
    if markov_order:
        shift = (uni[:, :-1] * 31 + 7) % vocab
        use = rng.random((n_sequences, seq_len)) < 0.5
        uni[:, 1:] = np.where(use, shift, uni[:, 1:])
    toks[:] = uni
    return SyntheticLMDataset(tokens=toks, vocab=vocab)
