"""Config registry of the port: the architectures whose block kinds are
ported. So far stablelm-1.6b (the ``attn_mlp`` block); the other nine
configs of the JAX package come with their block kinds (ROADMAP Queue 1
item 12).
"""

from repro_torch.configs import stablelm_1p6b
from repro_torch.configs.base import ArchConfig

REGISTRY = {c.CONFIG.name: c.CONFIG for c in (stablelm_1p6b,)}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}") from None


def arch_names():
    return sorted(REGISTRY)


__all__ = ["ArchConfig", "REGISTRY", "get_config", "arch_names"]
