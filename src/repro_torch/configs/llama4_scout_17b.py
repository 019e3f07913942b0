"""llama4-scout-17b-a16e — 16-expert top-1 MoE with shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E] 48L, d_model=5120, 40 heads (GQA
kv=8), d_ff=8192 per expert, vocab=202048, MoE 16 experts top-1 + an
always-on shared expert (llama4 routing), early-fusion multimodal (the
text path is modelled). The same config as the JAX package's.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    shared_expert=True,
    rope_theta=500000.0,
    long_context_window=8192,
    norm="rmsnorm",
    act="silu",
    dtype_name="bfloat16",
    remat=True,
    citation="[hf:meta-llama/Llama-4-Scout-17B-16E]",
)
