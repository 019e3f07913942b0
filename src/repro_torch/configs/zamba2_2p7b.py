"""zamba2-2.7b — Mamba2 backbone with a shared attention block.

[arXiv:2411.15242] 54 blocks, d_model=2560, shared attention 32 heads
(MHA kv=32), shared-block d_ff=10240, vocab=32000, ssm_state=64.
Layout: 9 super-blocks × (5 Mamba2 blocks + 1 SHARED attn+MLP block) —
the shared block has ONE parameter set reused at every super-block
(Zamba2's parameter-sharing trick; we use one shared block instead of
Zamba2's two alternating ones — DESIGN.md notes the deviation). Decode
state: per-invocation KV caches for the 9 shared-block call sites +
Mamba2 conv/SSD states. The same config as
the JAX package's.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    superblock=(("mamba2", 5, False), ("attn_mlp", 1, True)),
    n_super=9,
    rope_theta=10000.0,
    long_context_window=4096,  # shared attn gets SWA under long_500k
    norm="rmsnorm",
    act="silu",
    gla_chunk=64,
    dtype_name="bfloat16",
    remat=True,
    citation="[arXiv:2411.15242]",
)
