"""Per-client minibatch sampling on the device (port of
``repro.data.loader.ClientBatcher``)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch._device import resolve_device


class ClientBatcher:
    """Per-client uniform sampling ξ_i^t from equal-size client shards.

    Client data is stacked into ``(N, D_max, ...)`` tensors on the device
    (short shards padded by resampling with a numpy generator seeded by
    ``seed``, as the JAX package does; ``true_sizes`` keeps the real D_i
    for p_i). ``sample(key)`` draws its indices with
    :func:`repro_torch.random.randint`, so a key gives the same
    minibatches as the JAX package's batcher.
    """

    def __init__(self, arrays_per_client: list[dict], batch_size: int,
                 seed: int = 0, device=None):
        if not arrays_per_client:
            raise ValueError("need at least one client")
        self.device = resolve_device(device)
        self.n_clients = len(arrays_per_client)
        self.batch_size = batch_size
        sizes = [len(next(iter(d.values()))) for d in arrays_per_client]
        self.true_sizes = np.asarray(sizes, dtype=np.int64)
        cap = max(sizes)
        rng = np.random.default_rng(seed)
        stacked: dict[str, np.ndarray] = {}
        for name in arrays_per_client[0]:
            per = []
            for d, size in zip(arrays_per_client, sizes):
                arr = np.asarray(d[name])
                if size < cap:  # pad by resampling with replacement
                    extra = arr[rng.integers(0, size, cap - size)]
                    arr = np.concatenate([arr, extra], axis=0)
                per.append(arr)
            stacked[name] = np.stack(per, axis=0)
        self.data = {k: torch.from_numpy(v).to(self.device)
                     for k, v in stacked.items()}
        self.shard_size = cap
        self._rows = torch.arange(self.n_clients, device=self.device)[:, None]

    @property
    def p(self) -> torch.Tensor:
        """p_i = D_i / D from the true (pre-padding) shard sizes."""
        return torch.as_tensor(self.true_sizes / self.true_sizes.sum(),
                               dtype=torch.float32).to(self.device)

    def sample(self, key) -> dict:
        """``{name: (N, batch, ...)}``, one minibatch per client."""
        idx = trandom.randint(key, (self.n_clients, self.batch_size), 0,
                              self.shard_size).to(torch.int64)
        return {k: v[self._rows, idx] for k, v in self.data.items()}
