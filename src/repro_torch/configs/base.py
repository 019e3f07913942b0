"""ArchConfig — the config dataclass every architecture instantiates.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package). The fields, ``replace``, ``reduced`` and the derived
properties are the JAX package's; only ``dtype`` differs: it is a torch
dtype. A config fully determines parameter shapes and init, the block
stack (``superblock`` × ``n_super``), the attention flavour and the
decode-cache layout. The port runs every block kind of the JAX package
(see :mod:`repro_torch.models.blocks`); fields it does not read (the
dry-run's ``unroll_layers``, ``long_context_window``) are carried so
that a config reads the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Superblock = Tuple[Tuple[str, int, bool], ...]  # (kind, count, shared)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    citation: str = ""

    head_dim: int = 0              # 0 → d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    slstm_heads: int = 4
    slstm_ff: int = 0
    gla_chunk: int = 64
    # Stack layout; () → derived from arch_type
    superblock: Superblock = ()
    n_super: int = 1
    # Attention details
    sliding_window: int = 0        # 0 = full causal attention
    long_context_window: int = 8192  # SWA window used only for long_500k
    rope_theta: float = 1e4
    m_rope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    pos_embed: str = "rope"        # rope | sinusoidal | none
    # Encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500
    # VLM
    n_vision_tokens: int = 0
    # Misc
    use_bias: bool = False
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    dtype_name: str = "float32"
    remat: bool = False
    loss_chunk: int = 0
    remat_policy: str = "full"
    use_flash: bool = False
    unroll_layers: bool = False

    # ------------------------------------------------------------- derived

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}[self.dtype_name]

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_superblock(self) -> Superblock:
        if self.superblock:
            return self.superblock
        kind = "attn_moe" if self.arch_type == "moe" else "attn_mlp"
        return ((kind, self.n_layers, False),)

    @property
    def total_layers(self) -> int:
        return self.n_super * sum(c for _, c, _ in self.resolved_superblock)

    # ------------------------------------------------------------ variants

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims (CPU-runnable)."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        head_dim = max(d_model // n_heads, 8)
        # Shrink each superblock segment to ≤1 block, ≤2 supers.
        sb = tuple((k, 1, sh) for k, _, sh in self.resolved_superblock)
        # M-RoPE sections must sum to head_dim/2 — re-derive for tiny dims.
        half = head_dim // 2
        t_sec = max(half // 4, 1)
        h_sec = (half - t_sec) // 2
        mrope = (t_sec, h_sec, half - t_sec - h_sec)
        return self.replace(
            n_layers=min(self.n_layers, 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            slstm_heads=min(self.slstm_heads, 2),
            superblock=sb,
            n_super=min(self.n_super, 2),
            enc_len=min(self.enc_len, 16),
            n_enc_layers=min(self.n_enc_layers, 2),
            n_vision_tokens=min(self.n_vision_tokens, 4),
            mrope_sections=mrope,
            dtype_name="float32",
            gla_chunk=8,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            long_context_window=16,
            remat=False,
        )
