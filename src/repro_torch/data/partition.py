"""Federated partitioning with label skew aligned to energy groups
(numpy; a copy of ``repro.data.partition.group_label_skew_partition``).
"""

from __future__ import annotations

import numpy as np


def group_label_skew_partition(
    seed: int,
    labels: np.ndarray,
    n_clients: int,
    n_groups: int,
    skew: float = 0.8,
) -> list[np.ndarray]:
    """Client i ∈ group i mod G draws a fraction ``skew`` of its data
    from classes ≡ g (mod G) and the rest uniformly. With energy periods
    also assigned per group (paper eq. 37), energy-agnostic
    participation biases the model toward the energy-rich group's
    classes — the failure mode of the paper's Benchmark 1.
    """
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [list(np.flatnonzero(labels == k)) for k in range(n_classes)]
    for lst in idx_by_class:
        rng.shuffle(lst)
    per_client = len(labels) // n_clients
    out = []
    for i in range(n_clients):
        g = i % n_groups
        fav = [k for k in range(n_classes) if k % n_groups == g]
        take = []
        n_fav = int(skew * per_client)
        for j in range(n_fav):
            k = fav[j % len(fav)]
            if idx_by_class[k]:
                take.append(idx_by_class[k].pop())
        while len(take) < per_client:
            k = int(rng.integers(0, n_classes))
            if idx_by_class[k]:
                take.append(idx_by_class[k].pop())
        out.append(np.sort(np.asarray(take, dtype=np.int64)))
    return out
