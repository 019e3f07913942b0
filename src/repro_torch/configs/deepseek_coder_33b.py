"""deepseek-coder-33b — llama-architecture dense decoder.

[arXiv:2401.14196] 62L, d_model=7168, 56 heads (GQA kv=8), d_ff=19200,
vocab=32256.
The same config as the JAX package's.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    rope_theta=100000.0,
    long_context_window=8192,
    norm="rmsnorm",
    act="silu",
    dtype_name="bfloat16",
    remat=True,
    citation="[arXiv:2401.14196]",
)
