"""Tree-native optimizers and schedules (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    apply_updates,
    chain_clip,
    momentum,
    resolve_lr,
    sgd,
)
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    inverse_time_schedule,
    warmup_cosine_schedule,
)

__all__ = [
    "Optimizer",
    "sgd",
    "momentum",
    "adam",
    "adamw",
    "apply_updates",
    "chain_clip",
    "resolve_lr",
    "constant_schedule",
    "cosine_schedule",
    "inverse_time_schedule",
    "warmup_cosine_schedule",
]
