"""xlstm-1.3b — sLSTM + mLSTM block stack (xLSTM[7:1]).

[arXiv:2405.04517] 48 blocks, d_model=2048, 4 heads (kv=4), d_ff=0 (the
blocks carry their own up/down projections), vocab=50304. Layout: 6
super-blocks × (7 mLSTM + 1 sLSTM), the paper's 7:1 ratio. mLSTM runs on
the GLA engine (matrix memory = gated linear recurrence; the prefill
through the scan kernel K4 with ``use_flash``); sLSTM is a true
sequential scan (hidden-to-hidden recurrence). The same config as the
JAX package's.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_heads=4,
    superblock=(("mlstm", 7, False), ("slstm", 1, False)),
    n_super=6,
    norm="rmsnorm",
    act="gelu",
    gla_chunk=64,
    dtype_name="bfloat16",
    remat=True,
    citation="[arXiv:2405.04517]",
)
