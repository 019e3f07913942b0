"""Config registry of the port: the architectures whose block kinds are
ported. stablelm-1.6b (``attn_mlp``), zamba2-2.7b (``mamba2`` with a
shared ``attn_mlp``) and xlstm-1.3b (``mlstm`` and ``slstm``); the other
seven configs of the JAX package come with their block kinds (ROADMAP
Queue 1 step 8).
"""

from repro_torch.configs import stablelm_1p6b, xlstm_1p3b, zamba2_2p7b
from repro_torch.configs.base import ArchConfig

REGISTRY = {c.CONFIG.name: c.CONFIG
            for c in (zamba2_2p7b, xlstm_1p3b, stablelm_1p6b)}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}") from None


def arch_names():
    return sorted(REGISTRY)


__all__ = ["ArchConfig", "REGISTRY", "get_config", "arch_names"]
