"""command-r-35b — large dense decoder, GQA, no biases.

[hf:CohereForAI/c4ai-command-r-v01] 40L, d_model=8192, 64 heads (GQA
kv=8), d_ff=22528, vocab=256000, no-bias.
The same config as the JAX package's.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    arch_type="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab=256000,
    rope_theta=8000000.0,
    long_context_window=8192,
    norm="layernorm",  # command-r uses LayerNorm (no bias)
    act="silu",
    use_bias=False,
    dtype_name="bfloat16",
    remat=True,
    citation="[hf:CohereForAI/c4ai-command-r-v01]",
)
