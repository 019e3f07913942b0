"""Language-model stacks: init / forward / decode, for serving.

Port of ``repro.models.transformer`` for stacks of ported block kinds
(:mod:`repro_torch.models.blocks`). The parameter tree is the JAX
package's, with the stacked leading layer axis
(``params["stack"]["seg0"]["attn"]["wq"]["w"]`` is ``(n_layers, d_model,
H·Dh)``), so :func:`repro_torch.convert.params_from_jax` carries a JAX
tree over leaf for leaf. Where the JAX package scans over the layer
axis, the port runs a Python loop over it: this is the serving path, so
there is no remat and no scan to trace.

What the port does not run yet raises ``NotImplementedError`` naming
ROADMAP Queue 1 item 12: super-block repeats (``n_super > 1``), shared
segments, the encoder-decoder and vision inputs, sinusoidal positions,
M-RoPE, and block kinds other than ``attn_mlp``.

Public entry points:
  init_lm / forward / hidden_states         — prefill
  init_decode_state / decode_step           — serving (1 token, KV cache)
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import NOT_PORTED, get_block
from repro_torch.models.common import (
    apply_norm,
    dense_init,
    norm_init,
    normal_init,
)


def check_ported(cfg: ArchConfig):
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    missing = []
    if cfg.n_super != 1:
        missing.append(f"n_super={cfg.n_super}")
    if cfg.enc_dec:
        missing.append("the encoder-decoder")
    if cfg.n_vision_tokens:
        missing.append("vision tokens")
    if cfg.m_rope:
        missing.append("M-RoPE")
    if cfg.pos_embed not in ("rope", "none"):
        missing.append(f"pos_embed={cfg.pos_embed!r}")
    for kind, _, shared in cfg.resolved_superblock:
        get_block(kind)
        if shared:
            missing.append(f"shared segment {kind!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet ({NOT_PORTED})")


def _default_positions(cfg: ArchConfig, b, s, device):
    if cfg.pos_embed != "rope":
        return None
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _seg_key(idx: int) -> str:
    return f"seg{idx}"


def _tree_index(tree, i):
    return tree_map(lambda a: a[i], tree)


# ------------------------------------------------------------------- init

def _init_stacked(keys, init_one):
    """``init_one`` over the leading axis of ``keys``, stacked — what the
    JAX package's ``vmap(init_one)(keys)`` gives, built layer by layer
    into preallocated leaves so a full-width stack is not held twice."""
    first = init_one(keys[0])
    stacked = tree_map(lambda l: l.new_empty((keys.shape[0],) + l.shape), first)
    for i in range(keys.shape[0]):
        layer = first if i == 0 else init_one(keys[i])
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, layer)
    return stacked


def _init_segments(key, cfg: ArchConfig, superblock):
    params = {}
    keys = trandom.split(key, len(superblock))
    for idx, (kind, count, _) in enumerate(superblock):
        init = get_block(kind).init
        params[_seg_key(idx)] = _init_stacked(
            trandom.split(keys[idx], count), lambda k: init(k, cfg))
    return params


def init_lm(key, cfg: ArchConfig):
    """Parameters on ``key``'s device, drawn with the JAX package's
    threefry bits (normal draws agree to f32 ``rtol=1e-5``)."""
    check_ported(cfg)
    k_embed, k_stack, k_head, _ = trandom.split(key, 4)
    params = {
        "embed": {"w": normal_init(k_embed, (cfg.vocab, cfg.d_model),
                                   cfg.dtype, cfg.d_model ** -0.5)},
        "stack": _init_segments(k_stack, cfg, cfg.resolved_superblock),
        "final_norm": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(k_head, cfg.d_model, cfg.vocab,
                                       cfg.dtype)
    return params


# ------------------------------------------------------------------ apply

def apply_stack(params, cfg: ArchConfig, x, ctx):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for idx, (kind, _, _) in enumerate(cfg.resolved_superblock):
        apply = get_block(kind).apply
        seg = params[_seg_key(idx)]
        for i in range(tree_leaves(seg)[0].shape[0]):
            x, a = apply(_tree_index(seg, i), x, ctx, cfg)
            aux = aux + a
    return x, aux


def _make_ctx(cfg: ArchConfig, positions, window=None):
    return {
        "positions": positions,
        "window": cfg.sliding_window if window is None else window,
        "use_flash": cfg.use_flash,
    }


def _embed(params, cfg, tokens):
    return params["embed"]["w"][tokens]


def _head(params, cfg, x):
    x = apply_norm(params["final_norm"], x, cfg.norm)
    w = (params["embed"]["w"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    return x @ w


def hidden_states(params, cfg: ArchConfig, tokens, *, positions=None,
                  window=None):
    """tokens: (B, S) -> (hidden (B,S,D), aux) — stack output, pre-head."""
    check_ported(cfg)
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    if positions is None:
        positions = _default_positions(cfg, b, s, tokens.device)
    ctx = _make_ctx(cfg, positions, window=window)
    return apply_stack(params["stack"], cfg, x, ctx)


def forward(params, cfg: ArchConfig, tokens, *, positions=None, window=None):
    """tokens: (B, S) -> (logits (B,S,V), aux)."""
    x, aux = hidden_states(params, cfg, tokens, positions=positions,
                           window=window)
    return _head(params, cfg, x), aux


# ----------------------------------------------------------------- decode

def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int, dtype=None,
                      device=None):
    """Zero decode state mirroring the stack layout: per segment, each
    leaf of the block's state with a leading layer axis."""
    check_ported(cfg)
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    states = {}
    for idx, (kind, count, _) in enumerate(cfg.resolved_superblock):
        state = get_block(kind).state
        if state is None:
            continue
        base = state(cfg, batch, cache_len, dtype, device)
        states[_seg_key(idx)] = tree_map(
            lambda l: torch.zeros((count,) + l.shape, dtype=l.dtype,
                                  device=device), base)
    return states


def decode_stack(params, cfg: ArchConfig, x, states, pos, ctx):
    """Every layer's state is a view into the stacked state tensors, and
    the blocks write their cache slots in place, so the stacked states
    come back updated without a copy."""
    for idx, (kind, _, _) in enumerate(cfg.resolved_superblock):
        decode = get_block(kind).decode
        key = _seg_key(idx)
        seg = params[key]
        for i in range(tree_leaves(seg)[0].shape[0]):
            x, _ = decode(_tree_index(seg, i), x, _tree_index(states[key], i),
                          pos, ctx, cfg)
    return x, states


def decode_step(params, cfg: ArchConfig, tokens, states, pos, *,
                memory=None, window=None):
    """One serving step. tokens: (B, 1); pos: int, the absolute position.
    Returns (logits (B, vocab), states), the states updated in place."""
    check_ported(cfg)
    if memory is not None:
        raise NotImplementedError(f"encoder memory is not ported yet ({NOT_PORTED})")
    x = _embed(params, cfg, tokens)
    ctx = _make_ctx(cfg, None, window=window)
    x, states = decode_stack(params["stack"], cfg, x, states, pos, ctx)
    logits = _head(params, cfg, x)
    return logits[:, 0], states


def decode_cache_len(cfg: ArchConfig, seq_len: int, window=None) -> int:
    """Cache length: ring-buffer window for SWA, else the full context."""
    w = cfg.sliding_window if window is None else window
    return min(seq_len, w) if w and w > 0 else seq_len
