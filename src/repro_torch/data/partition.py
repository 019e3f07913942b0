"""Federated partitioning of a dataset across N clients (numpy; a copy
of ``repro.data.partition``, so its splits are the JAX package's, index
for index).

The paper distributes CIFAR-10 "over 40 users uniformly at random"
(IID, :func:`iid_partition`). :func:`dirichlet_partition` and
:func:`group_label_skew_partition` are the heterogeneous splits that
make Benchmark 1's bias visible; their index lists feed
``GlobalBatcher(client_index=...)``.
"""

from __future__ import annotations

import numpy as np


def iid_partition(seed: int, n_examples: int, n_clients: int) -> list[np.ndarray]:
    """Uniformly-at-random equal split (paper §V)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_examples)
    return [np.sort(s) for s in np.array_split(perm, n_clients)]


def dirichlet_partition(
    seed: int, labels: np.ndarray, n_clients: int, alpha: float = 0.3
) -> list[np.ndarray]:
    """Label-Dirichlet split (standard non-IID federated benchmark)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.flatnonzero(labels == k) for k in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for k in range(n_classes):
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx_by_class[k])).astype(int)
        for c, shard in enumerate(np.split(idx_by_class[k], cuts)):
            client_idx[c].extend(shard.tolist())
    return [np.sort(np.asarray(ix, dtype=np.int64)) for ix in client_idx]


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
