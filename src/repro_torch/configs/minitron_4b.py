"""minitron-4b — width/depth-pruned Nemotron dense decoder.

[arXiv:2407.14679] 32L, d_model=3072, 24 heads (GQA kv=8), d_ff=9216,
vocab=256000.
The same config as the JAX package's.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    arch_type="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256000,
    rope_theta=10000.0,
    long_context_window=8192,
    norm="rmsnorm",
    act="silu",
    gated_mlp=False,  # nemotron uses squared-relu non-gated FFN
    dtype_name="bfloat16",
    remat=True,
    citation="[arXiv:2407.14679]",
)
