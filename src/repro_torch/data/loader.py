"""Batching on the device (port of ``repro.data.loader``): per-client
samplers for the simulator path (:class:`ClientBatcher`) and the global
batcher of the SPMD LM train step (:class:`GlobalBatcher`). Indices are
drawn with :func:`repro_torch.random.randint`, so a key gives the JAX
package's batches."""

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


class GlobalBatcher:
    """Global-batch sampler for the SPMD path.

    The global batch of size B is laid out as ``n_clients`` contiguous
    slots of B/N examples; ``client_ids`` (int32) marks ownership so the
    train step can apply per-example energy coefficients. Without
    ``client_index`` every client samples from the whole dataset (IID);
    with it, client i samples from its own index list (short lists padded
    by resampling from a numpy generator seeded 0, as the JAX package
    does).
    """

    def __init__(self, data: dict, n_clients: int, global_batch: int,
                 client_index: list[np.ndarray] | None = None, device=None):
        if global_batch % n_clients != 0:
            raise ValueError(f"global_batch {global_batch} % n_clients {n_clients} != 0")
        self.device = resolve_device(device)
        self.n_clients = n_clients
        self.global_batch = global_batch
        self.per_client = global_batch // n_clients
        self.data = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                     for k, v in data.items()}
        if client_index is None:
            self._index = None
            self._n = len(next(iter(data.values())))
        else:
            cap = max(len(ix) for ix in client_index)
            rng = np.random.default_rng(0)
            padded = []
            for ix in client_index:
                if len(ix) < cap:
                    ix = np.concatenate([ix, rng.choice(ix, cap - len(ix))])
                padded.append(ix)
            self._index = torch.from_numpy(
                np.stack(padded).astype(np.int64)).to(self.device)  # (N, cap)
            self._n = cap
        self.client_ids = torch.arange(
            n_clients, dtype=torch.int32,
            device=self.device).repeat_interleave(self.per_client)

    def sample(self, key) -> dict:
        """``{name: (B, ...)}`` plus ``client_ids``."""
        idx = trandom.randint(key, (self.n_clients, self.per_client), 0,
                              self._n).to(torch.int64)
        if self._index is not None:
            idx = torch.gather(self._index, 1, idx)
        flat = idx.reshape(-1)
        batch = {k: v[flat] for k, v in self.data.items()}
        batch["client_ids"] = self.client_ids
        return batch
