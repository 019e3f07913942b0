"""Partition rules of the port (:mod:`.rules`), the JAX package's
``repro.sharding``: parameter, batch and decode-state specs, and
:func:`shard_leaf`, a rank's block of a leaf under a spec."""

from repro_torch.sharding.rules import (
    PartitionSpec,
    auto_spec,
    batch_specs,
    param_specs,
    shard_leaf,
    state_specs,
)

__all__ = ["PartitionSpec", "param_specs", "batch_specs", "state_specs",
           "auto_spec", "shard_leaf"]
