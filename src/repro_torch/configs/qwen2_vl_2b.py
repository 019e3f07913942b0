"""qwen2-vl-2b — VLM decoder with M-RoPE (transformer backbone only).

[arXiv:2409.12191] 28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960,
vocab=151936, M-RoPE sections (16, 24, 24) over head_dim=128, dynamic
resolution. The ViT vision encoder and projector are not modelled: the
caller passes precomputed patch embeddings (B, 256, 1536), which the
model splices over the first token embeddings (``vision_embeds``).
The same config as the JAX package's.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    m_rope=True,
    mrope_sections=(16, 24, 24),
    n_vision_tokens=256,
    rope_theta=1000000.0,
    long_context_window=8192,
    norm="rmsnorm",
    act="silu",
    use_bias=True,  # qwen2 qkv biases
    dtype_name="bfloat16",
    remat=True,
    citation="[arXiv:2409.12191]",
)
