"""The Fig-1 synthetic image task (numpy; a copy of the part of
``repro.data.synthetic`` the slice needs, so the port imports nothing of
the JAX package).

CIFAR-10 is replaced by a class-structured synthetic task with the same
tensor shapes (32×32×3, 10 classes): class ``c``'s prototype is mostly
the shared confuser of its energy group plus a small unique part, so
the weighting of the clients decides which class boundaries get
resolved. The same seed gives the same arrays as the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticImageDataset(NamedTuple):
    images: np.ndarray  # (D, H, W, C) float32
    labels: np.ndarray  # (D,) int32
    n_classes: int


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
