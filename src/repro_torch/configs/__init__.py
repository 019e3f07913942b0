"""Config registry of the port: the JAX package's ten architectures.
The dense decoders stablelm-1.6b, minitron-4b, deepseek-coder-33b and
command-r-35b (``attn_mlp``), the MoE decoders phi3.5-moe-42b-a6.6b and
llama4-scout-17b-a16e (``attn_moe``), zamba2-2.7b (``mamba2`` with a
shared ``attn_mlp``), xlstm-1.3b (``mlstm`` and ``slstm``), qwen2-vl-2b
(``attn_mlp`` with M-RoPE and vision tokens) and whisper-tiny (the
encoder-decoder: ``enc_attn_mlp`` and ``xattn``, sinusoidal positions).
"""

from repro_torch.configs import (
    command_r_35b,
    deepseek_coder_33b,
    llama4_scout_17b,
    minitron_4b,
    phi35_moe_42b,
    qwen2_vl_2b,
    stablelm_1p6b,
    whisper_tiny,
    xlstm_1p3b,
    zamba2_2p7b,
)
from repro_torch.configs.base import ArchConfig

REGISTRY = {c.CONFIG.name: c.CONFIG
            for c in (phi35_moe_42b, llama4_scout_17b, minitron_4b,
                      deepseek_coder_33b, command_r_35b, zamba2_2p7b,
                      xlstm_1p3b, stablelm_1p6b, qwen2_vl_2b, whisper_tiny)}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}") from None


def arch_names():
    return sorted(REGISTRY)


__all__ = ["ArchConfig", "REGISTRY", "get_config", "arch_names"]
