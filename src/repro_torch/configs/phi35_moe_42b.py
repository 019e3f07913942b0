"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE decoder.

[hf:microsoft/Phi-3.5-MoE-instruct] 32L, d_model=4096, 32 heads (GQA
kv=8), d_ff=6400 per expert, vocab=32064, 16 experts top-2 (~42B total,
~6.6B active).
The same config as the JAX package's.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    rope_theta=10000.0,
    long_context_window=8192,
    norm="rmsnorm",
    act="silu",
    dtype_name="bfloat16",
    remat=True,
    citation="[hf:microsoft/Phi-3.5-MoE-instruct]",
)
