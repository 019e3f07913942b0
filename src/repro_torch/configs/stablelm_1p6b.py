"""stablelm-1.6b — small dense decoder (StableLM 2).

[hf:stabilityai/stablelm-2-1_6b] 24L, d_model=2048, 32 heads (MHA,
kv=32), d_ff=5632, vocab=100352. LayerNorm (with bias) per the model
card; gated SiLU FFN. The same config as the JAX package's.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab=100352,
    rope_theta=10000.0,
    long_context_window=8192,
    norm="layernorm",
    act="silu",
    use_bias=True,
    dtype_name="bfloat16",
    remat=True,
    citation="[hf:stabilityai/stablelm-2-1_6b]",
)
