"""Residual blocks — the units the stacks loop over.

Port of ``repro.models.blocks``: the ``attn_mlp`` block (pre-norm
attention + MLP), the ``attn_moe`` block (pre-norm attention +
Mixture-of-Experts FFN, :mod:`repro_torch.models.moe`), the recurrent
kinds ``mamba2``, ``mlstm`` and ``slstm`` (:mod:`repro_torch.models.ssm`),
and whisper's encoder-decoder kinds: ``enc_attn_mlp`` (bidirectional,
no decode) and ``xattn`` (causal self-attention, cross attention over
the encoder memory, MLP). Each kind provides::

    init_<kind>(key, cfg)                     -> params
    apply_<kind>(params, x, ctx, cfg)         -> (x, aux)
    state_<kind>(cfg, batch, cache_len, dtype, device) -> decode state
    decode_<kind>(params, x, state, pos, ctx, cfg)     -> (x, state)

``ctx`` is a dict with: positions, memory (the encoder output, or
None), window, use_flash (the prefill's causal self-attention through
K3 and its scan through K4). A decode step writes the block's state in
place and returns it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import random as trandom
from repro_torch.models import ssm
from repro_torch.models.attention import (
    attention,
    decode_attention,
    init_attention,
    init_kv_cache,
)
from repro_torch.models.common import (
    activation,
    apply_norm,
    dense,
    dense_init,
    norm_init,
)
from repro_torch.models.moe import apply_moe, init_moe

# ------------------------------------------------------------------- MLP

def init_mlp(key, d_model, d_ff, dtype, use_bias=False, gated=True):
    k1, k2, k3 = trandom.split(key, 3)
    p = {"up": dense_init(k2, d_model, d_ff, dtype, use_bias),
         "down": dense_init(k3, d_ff, d_model, dtype, use_bias)}
    if gated:
        p["gate"] = dense_init(k1, d_model, d_ff, dtype, use_bias)
    return p


def apply_mlp(params, x, act="silu"):
    act_fn = activation(act)
    h = dense(params["up"], x)
    if "gate" in params:
        h = act_fn(dense(params["gate"], x)) * h
    else:
        h = act_fn(h)
    return dense(params["down"], h)


def _attn_kwargs(cfg):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                m_rope=cfg.m_rope, mrope_sections=cfg.mrope_sections)


def _decode_attn_kwargs(cfg):
    # decode applies rotary internally at `pos`; configs without rotary
    # positions get positions=None on the prefill path.
    return dict(_attn_kwargs(cfg), use_rope=(cfg.pos_embed == "rope"))


# --------------------------------------------------------------- attn_mlp

def init_attn_mlp(key, cfg):
    k1, k2, _, _ = trandom.split(key, 4)
    return {
        "ln1": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
        "attn": init_attention(k1, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, cfg.dtype, cfg.use_bias),
        "ln2": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
        "mlp": init_mlp(k2, cfg.d_model, cfg.d_ff, cfg.dtype, cfg.use_bias,
                        gated=cfg.gated_mlp),
    }


def apply_attn_mlp(params, x, ctx, cfg, causal=True):
    h = apply_norm(params["ln1"], x, cfg.norm)
    h = attention(params["attn"], h, positions=ctx.get("positions"),
                  causal=causal, window=ctx.get("window", 0),
                  use_flash=ctx.get("use_flash", False), **_attn_kwargs(cfg))
    x = x + h
    h = apply_norm(params["ln2"], x, cfg.norm)
    x = x + apply_mlp(params["mlp"], h, act=cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def state_attn_mlp(cfg, batch, cache_len, dtype, device=None):
    return init_kv_cache(batch, cfg.n_kv_heads, cfg.resolved_head_dim,
                         cache_len, dtype, device)


def decode_attn_mlp(params, x, state, pos, ctx, cfg):
    h = apply_norm(params["ln1"], x, cfg.norm)
    h, state = decode_attention(params["attn"], h, state, pos,
                                window=ctx.get("window", 0),
                                **_decode_attn_kwargs(cfg))
    x = x + h
    h = apply_norm(params["ln2"], x, cfg.norm)
    x = x + apply_mlp(params["mlp"], h, act=cfg.act)
    return x, state


# --------------------------------------------------------------- attn_moe

def init_attn_moe(key, cfg):
    k1, k2 = trandom.split(key)
    return {
        "ln1": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
        "attn": init_attention(k1, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, cfg.dtype, cfg.use_bias),
        "ln2": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
        "moe": init_moe(k2, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype,
                        cfg.use_bias, shared_expert=cfg.shared_expert),
    }


def _moe(params, h, cfg):
    return apply_moe(params["moe"], h, n_experts=cfg.n_experts,
                     top_k=cfg.top_k, act=cfg.act,
                     capacity_factor=cfg.moe_capacity_factor,
                     shared_expert=cfg.shared_expert)


def apply_attn_moe(params, x, ctx, cfg):
    h = apply_norm(params["ln1"], x, cfg.norm)
    h = attention(params["attn"], h, positions=ctx.get("positions"),
                  causal=True, window=ctx.get("window", 0),
                  use_flash=ctx.get("use_flash", False), **_attn_kwargs(cfg))
    x = x + h
    y, aux = _moe(params, apply_norm(params["ln2"], x, cfg.norm), cfg)
    return x + y, aux


state_attn_moe = state_attn_mlp


def decode_attn_moe(params, x, state, pos, ctx, cfg):
    """One token a row: the batch is the MoE layer's tokens, so its
    capacity is the batch's (at B = 8 one assignment an expert for both
    MoE configs), as in the JAX package."""
    h = apply_norm(params["ln1"], x, cfg.norm)
    h, state = decode_attention(params["attn"], h, state, pos,
                                window=ctx.get("window", 0),
                                **_decode_attn_kwargs(cfg))
    x = x + h
    y, _ = _moe(params, apply_norm(params["ln2"], x, cfg.norm), cfg)
    return x + y, state


# ----------------------------------------------------------------- mamba2

def init_mamba2_block(key, cfg):
    return {
        "ln": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
        "mixer": ssm.init_mamba2(key, cfg.d_model, cfg.ssm_state, cfg.dtype,
                                 head_dim=cfg.ssm_head_dim),
    }


def apply_mamba2_block(params, x, ctx, cfg):
    h = apply_norm(params["ln"], x, cfg.norm)
    y = ssm.apply_mamba2(params["mixer"], h, d_state=cfg.ssm_state,
                         head_dim=cfg.ssm_head_dim, chunk=cfg.gla_chunk,
                         use_kernel=ctx.get("use_flash", False))
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


def state_mamba2_block(cfg, batch, cache_len, dtype, device=None):
    return ssm.init_mamba2_state(batch, cfg.d_model, cfg.ssm_state, dtype,
                                 head_dim=cfg.ssm_head_dim, device=device)


def decode_mamba2_block(params, x, state, pos, ctx, cfg):
    h = apply_norm(params["ln"], x, cfg.norm)
    y, state = ssm.decode_mamba2(params["mixer"], h, state,
                                 d_state=cfg.ssm_state,
                                 head_dim=cfg.ssm_head_dim)
    return x + y, state


# ------------------------------------------------------------------ mlstm

def init_mlstm_block(key, cfg):
    return {
        "ln": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
        "mixer": ssm.init_mlstm(key, cfg.d_model, cfg.n_heads, cfg.dtype),
    }


def apply_mlstm_block(params, x, ctx, cfg):
    h = apply_norm(params["ln"], x, cfg.norm)
    y = ssm.apply_mlstm(params["mixer"], h, n_heads=cfg.n_heads,
                        chunk=cfg.gla_chunk,
                        use_kernel=ctx.get("use_flash", False))
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


def state_mlstm_block(cfg, batch, cache_len, dtype, device=None):
    return ssm.init_mlstm_state(batch, cfg.d_model, cfg.n_heads, dtype,
                                device=device)


def decode_mlstm_block(params, x, state, pos, ctx, cfg):
    h = apply_norm(params["ln"], x, cfg.norm)
    y, state = ssm.decode_mlstm(params["mixer"], h, state, n_heads=cfg.n_heads)
    return x + y, state


# ------------------------------------------------------------------ slstm

def init_slstm_block(key, cfg):
    k1, k2 = trandom.split(key)
    ff = cfg.slstm_ff or max(64, (4 * cfg.d_model // 3 + 63) // 64 * 64)
    return {
        "ln1": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
        "mixer": ssm.init_slstm(k1, cfg.d_model, cfg.slstm_heads, cfg.dtype),
        "ln2": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
        "mlp": init_mlp(k2, cfg.d_model, ff, cfg.dtype, cfg.use_bias,
                        gated=False),
    }


def apply_slstm_block(params, x, ctx, cfg):
    h = apply_norm(params["ln1"], x, cfg.norm)
    x = x + ssm.apply_slstm(params["mixer"], h, n_heads=cfg.slstm_heads)
    h = apply_norm(params["ln2"], x, cfg.norm)
    x = x + apply_mlp(params["mlp"], h, act=cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def state_slstm_block(cfg, batch, cache_len, dtype, device=None):
    return ssm.init_slstm_state(batch, cfg.d_model, cfg.slstm_heads,
                                device=device)


def decode_slstm_block(params, x, state, pos, ctx, cfg):
    h = apply_norm(params["ln1"], x, cfg.norm)
    y, state = ssm.decode_slstm(params["mixer"], h, state,
                                n_heads=cfg.slstm_heads)
    x = x + y
    h = apply_norm(params["ln2"], x, cfg.norm)
    x = x + apply_mlp(params["mlp"], h, act=cfg.act)
    return x, state


# --------------------------------------------- encoder block (no mask)

def init_enc_attn_mlp(key, cfg):
    return init_attn_mlp(key, cfg)


def apply_enc_attn_mlp(params, x, ctx, cfg):
    return apply_attn_mlp(params, x, ctx, cfg, causal=False)


# ------------------------------------- enc-dec decoder block (whisper)

def init_xattn(key, cfg):
    k1, k2, k3 = trandom.split(key, 3)
    return {
        "ln1": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
        "self": init_attention(k1, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, cfg.dtype, cfg.use_bias),
        "ln2": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
        "cross": init_attention(k2, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, cfg.dtype, cfg.use_bias),
        "ln3": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
        "mlp": init_mlp(k3, cfg.d_model, cfg.d_ff, cfg.dtype, cfg.use_bias,
                        gated=cfg.gated_mlp),
    }


def apply_xattn(params, x, ctx, cfg):
    h = apply_norm(params["ln1"], x, cfg.norm)
    x = x + attention(params["self"], h, positions=ctx.get("positions"),
                      causal=True, window=ctx.get("window", 0),
                      use_flash=ctx.get("use_flash", False),
                      **_attn_kwargs(cfg))
    h = apply_norm(params["ln2"], x, cfg.norm)
    x = x + attention(params["cross"], h, kv_override=ctx["memory"],
                      **_attn_kwargs(cfg))
    h = apply_norm(params["ln3"], x, cfg.norm)
    x = x + apply_mlp(params["mlp"], h, act=cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


state_xattn = state_attn_mlp


def decode_xattn(params, x, state, pos, ctx, cfg):
    h = apply_norm(params["ln1"], x, cfg.norm)
    h, state = decode_attention(params["self"], h, state, pos,
                                window=ctx.get("window", 0),
                                **_decode_attn_kwargs(cfg))
    x = x + h
    h = apply_norm(params["ln2"], x, cfg.norm)
    h, _ = decode_attention(params["cross"], h, None, pos,
                            kv_override=ctx["memory"], **_attn_kwargs(cfg))
    x = x + h
    h = apply_norm(params["ln3"], x, cfg.norm)
    x = x + apply_mlp(params["mlp"], h, act=cfg.act)
    return x, state


# -------------------------------------------------------------- registry

class BlockDef(NamedTuple):
    init: Callable
    apply: Callable
    state: Optional[Callable] = None
    decode: Optional[Callable] = None


BLOCKS = {
    "attn_mlp": BlockDef(init_attn_mlp, apply_attn_mlp, state_attn_mlp,
                         decode_attn_mlp),
    "attn_moe": BlockDef(init_attn_moe, apply_attn_moe, state_attn_moe,
                         decode_attn_moe),
    "mamba2": BlockDef(init_mamba2_block, apply_mamba2_block,
                       state_mamba2_block, decode_mamba2_block),
    "mlstm": BlockDef(init_mlstm_block, apply_mlstm_block, state_mlstm_block,
                      decode_mlstm_block),
    "slstm": BlockDef(init_slstm_block, apply_slstm_block, state_slstm_block,
                      decode_slstm_block),
    "enc_attn_mlp": BlockDef(init_enc_attn_mlp, apply_enc_attn_mlp),
    "xattn": BlockDef(init_xattn, apply_xattn, state_xattn, decode_xattn),
}


def get_block(kind: str) -> BlockDef:
    if kind in BLOCKS:
        return BLOCKS[kind]
    raise ValueError(f"unknown block kind {kind!r}")
