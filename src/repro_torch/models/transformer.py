"""Language-model stacks: init / forward / loss / decode.

Port of ``repro.models.transformer`` for stacks of ported block kinds
(:mod:`repro_torch.models.blocks`). The stack is ``cfg.resolved_superblock``,
an ordered tuple of ``(block_kind, count, shared)`` segments repeated
``cfg.n_super`` times. The parameter tree is the JAX package's: a
segment's leaves carry the leading layer axes ``(count,)``, or
``(n_super, count)`` when the super-block repeats
(``params["stack"]["seg0"]["attn"]["wq"]["w"]`` is ``(n_layers, d_model,
H·Dh)`` for a dense stack), and a shared segment (zamba2's shared
attention block) keeps ONE parameter set, used once a super-block,
while its decode state (KV cache) has one entry a call site. So
:func:`repro_torch.convert.params_from_jax` carries a JAX tree over
leaf for leaf. Where the JAX package scans over the layer and
super-block axes, the port runs Python loops over them, each stacked
leaf unbound once a forward (a per-layer index would cost the backward a
zero-filled, full-size gradient per layer; ``unbind``'s backward is one
``stack``). With ``cfg.remat`` and gradients enabled each layer runs
under ``torch.utils.checkpoint``, as the JAX package wraps it in
``jax.checkpoint``: policy ``"full"`` saves only the layer's inputs,
``"dots"`` also the outputs of products without batch dimensions (the
dense layers; JAX's ``dots_with_no_batch_dims_saveable``); the
recomputation runs under the forward's mesh context, in whatever thread
autograd runs it. Recomputing
runs the same ops on the same inputs, so the loss and gradients are
those of a run without remat, bit for bit.

Every config of the JAX package runs: vision tokens spliced over the
first embeddings and M-RoPE's three position rows (qwen2-vl-2b), and
the encoder-decoder with sinusoidal positions (whisper-tiny), whose
encoder runs once a prefill and whose memory a decode step takes.

Under a mesh of ranks (:func:`repro_torch.models.common.use_mesh`) the
entry points run unchanged on this rank's rows; an MoE stack's experts
are split over the ``"model"`` ranks (:func:`place_params`, or
:func:`init_lm` with ``mesh=``), and the MoE layers take the
expert-parallel path (:mod:`repro_torch.models.moe`).

Public entry points:
  init_lm / place_params                    — parameters (a rank's)
  forward / per_example_loss                — training & prefill
  hidden_states                             — the stack output, pre-head
  init_decode_state / decode_step           — serving (1 token, KV cache)
  encode                                    — whisper encoder
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import random as trandom
from repro_torch._device import resolve_device
from repro_torch._tree import (
    tree_flatten,
    tree_flatten_with_path,
    tree_map,
    tree_unflatten,
)
from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe
from repro_torch.models.blocks import get_block
from repro_torch.models.common import (
    apply_norm,
    current_mesh,
    dense_init,
    mesh_context,
    norm_init,
    normal_init,
    use_mesh,
    within_context,
)
from repro_torch.sharding.rules import shard_leaf


def _sinusoidal_freqs(d_model, device=None):
    """The d_model/2 f32 frequencies ``exp(-log(1e4)·i/half)``, in the JAX
    package's order of f32 operations. The two libraries' f32 ``exp``
    may round a frequency to neighbouring floats."""
    half = d_model // 2
    log_1e4 = torch.tensor(math.log(10000.0), dtype=torch.float32)
    return torch.exp(-log_1e4 * torch.arange(half, dtype=torch.float32,
                                             device=device) / half)


def sinusoidal(positions, d_model):
    """positions: (...,) int -> (..., d_model) float32 sinusoidal embeds,
    ``[sin, cos]`` of the positions times :func:`_sinusoidal_freqs`."""
    freqs = _sinusoidal_freqs(d_model, positions.device)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _encoder_superblock(cfg: ArchConfig):
    return (("enc_attn_mlp", cfg.n_enc_layers, False),)


def _default_positions(cfg: ArchConfig, b, s, device):
    if cfg.pos_embed != "rope":
        return None
    pos = torch.arange(s, device=device)[None, :].expand(b, s)
    if cfg.m_rope:
        return pos[None].expand(3, b, s)
    return pos


def _seg_key(idx: int) -> str:
    return f"seg{idx}"


def _tree_unbind(tree):
    """The layers of a stacked tree, each leaf unbound once along its
    leading axis."""
    leaves, treedef = tree_flatten(tree)
    return [tree_unflatten(treedef, list(layer))
            for layer in zip(*(torch.unbind(a, 0) for a in leaves))]


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


def _init_segments(key, cfg: ArchConfig, superblock, n_super):
    params = {}
    keys = trandom.split(key, len(superblock))
    for idx, (kind, count, shared) in enumerate(superblock):
        init = get_block(kind).init
        init_one = lambda k, init=init: init(k, cfg)
        if shared:
            params[_seg_key(idx)] = init_one(keys[idx])
            continue
        lead = (n_super, count) if n_super > 1 else (count,)
        ks = trandom.split(keys[idx], lead).reshape(-1, 2)
        params[_seg_key(idx)] = tree_map(
            lambda l: l.reshape(lead + l.shape[1:]), _init_stacked(ks, init_one))
    return params


def init_lm(key, cfg: ArchConfig, *, mesh=None):
    """Parameters on ``key``'s device, drawn with the JAX package's
    threefry bits (normal draws agree to f32 ``rtol=1e-5``). With a
    ``mesh`` of ranks, this rank's: an MoE layer's experts are its block
    over ``"model"`` alone, drawn with their bits in the whole draw, so
    ``init_lm(key, cfg, mesh=mesh)`` equals ``place_params(init_lm(key,
    cfg), mesh)`` without holding the other experts."""
    if mesh is not None:
        with use_mesh(mesh):
            return init_lm(key, cfg)
    k_embed, k_stack, k_head, k_enc = trandom.split(key, 4)
    params = {
        "embed": {"w": normal_init(k_embed, (cfg.vocab, cfg.d_model),
                                   cfg.dtype, cfg.d_model ** -0.5)},
        "stack": _init_segments(k_stack, cfg, cfg.resolved_superblock,
                                cfg.n_super),
        "final_norm": norm_init(cfg.d_model, cfg.dtype, cfg.norm, key.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(k_head, cfg.d_model, cfg.vocab,
                                       cfg.dtype)
    if cfg.enc_dec:
        params["encoder"] = {
            "stack": _init_segments(k_enc, cfg, _encoder_superblock(cfg), 1),
            "final_norm": norm_init(cfg.d_model, cfg.dtype, cfg.norm,
                                    key.device),
        }
    return params


def place_params(params, mesh):
    """This rank's parameters under ``mesh``: each MoE layer's expert
    leaves (``moe/w_gate``, ``moe/w_up``, ``moe/w_down``) cut to the
    rank's block of their expert axis over ``"model"``, as the JAX
    package's in_spec ``P("model", None, None)`` places them, each a copy;
    every other leaf as it is (the same tensor). A mesh whose ``"model"``
    axis does not divide the experts leaves them whole: the MoE layer
    then takes the global path (:mod:`repro_torch.models.moe`).
    :func:`repro_torch.convert.params_from_jax` then this carries a JAX
    tree into a rank."""
    leaves, treedef = tree_flatten_with_path(params)

    def one(path, leaf):
        if not (len(path) > 1 and path[-2] == "moe"
                and path[-1] in moe.EXPERT_LEAVES):
            return leaf
        if moe.expert_slice(leaf.shape[-3], mesh) is None:
            return leaf
        spec = (None,) * (leaf.dim() - 3) + ("model",)
        return shard_leaf(leaf, spec, mesh).clone()

    return tree_unflatten(treedef, [one(p, l) for p, l in leaves])


# ------------------------------------------------------------------ apply

#: Products without batch dimensions: the ops the ``"dots"`` remat
#: policy saves (``x @ w`` of a dense layer dispatches to ``mm``).
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """``fn`` recomputed in the backward when ``cfg.remat`` (the JAX
    package's ``jax.checkpoint``); a call without gradients runs ``fn``
    as it is."""
    if not cfg.remat:
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # The recomputation runs in autograd's thread (a CUDA tensor's
        # backward has one of its own), under the forward's mesh.
        context = mesh_context()

        def run(*args):
            with within_context(context):
                return fn(*args)

        # The blocks draw no random numbers: no RNG state to replay.
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return remat


def _per_super(tree, shared, n_super, per_call=False):
    """A segment's tree (its parameters or decode state) as one list of
    layers a super-block, each a view: a repeated segment's layers
    (leading axes ``(n_super, count)``, or ``(count,)``); a shared
    segment's one tree, the same in every super-block, or with
    ``per_call`` (a decode state, one a call site) its entry of a leading
    ``(n_super,)`` axis when the super-block repeats."""
    if shared:
        if per_call and n_super > 1:
            return [[t] for t in _tree_unbind(tree)]
        return [[tree]] * n_super
    if n_super > 1:
        return [_tree_unbind(t) for t in _tree_unbind(tree)]
    return [_tree_unbind(tree)]


def apply_stack(params, cfg: ArchConfig, x, ctx, superblock=None,
                n_super=None):
    """Every super-block in turn, its segments in order; remat (when on)
    wraps each call of a block, shared or not. ``superblock`` and
    ``n_super`` default to the config's (the encoder passes its own)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    superblock = superblock or cfg.resolved_superblock
    n_super = n_super or cfg.n_super
    segments = []
    for idx, (kind, _, shared) in enumerate(superblock):
        apply = get_block(kind).apply
        layer = _remat(cfg, lambda p, x, apply=apply: apply(p, x, ctx, cfg))
        segments.append((layer, _per_super(params[_seg_key(idx)], shared,
                                           n_super)))
    for sup in range(n_super):
        for layer, layers in segments:
            for p in layers[sup]:
                x, a = layer(p, x)
                aux = aux + a
    return x, aux


def _make_ctx(cfg: ArchConfig, positions, memory=None, window=None):
    return {
        "positions": positions,
        "memory": memory,
        "window": cfg.sliding_window if window is None else window,
        "use_flash": cfg.use_flash,
    }


def encode(params, cfg: ArchConfig, audio_feats):
    """Whisper encoder over stub frontend features (B, enc_len, d_model):
    sinusoidal positions, the bidirectional ``enc_attn_mlp`` layers, the
    encoder's final norm."""
    x = audio_feats.to(cfg.dtype)
    pos = sinusoidal(torch.arange(x.shape[1], device=x.device), cfg.d_model)
    x = x + pos.to(cfg.dtype)[None]
    x, _ = apply_stack(params["encoder"]["stack"], cfg, x,
                       _make_ctx(cfg, None),
                       superblock=_encoder_superblock(cfg), n_super=1)
    return apply_norm(params["encoder"]["final_norm"], x, cfg.norm)


def _embed(params, cfg, tokens):
    # F.embedding, not an index: its backward sums each row's gradients
    # in a fixed order (an indexed read's backward is an accumulating
    # index_put, which the CPU runs in parallel in no fixed order).
    return F.embedding(tokens, params["embed"]["w"])


def _head(params, cfg, x):
    x = apply_norm(params["final_norm"], x, cfg.norm)
    w = (params["embed"]["w"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    return x @ w


def hidden_states(params, cfg: ArchConfig, tokens, *, vision_embeds=None,
                  audio_feats=None, positions=None, window=None):
    """tokens: (B, S) -> (hidden (B,S,D), aux) — stack output, pre-head.

    vision_embeds (B, nv, D) replace the first nv token embeddings (a
    vision-token config); audio_feats (B, enc_len, D) go through
    :func:`encode`, whose output the decoder's cross attention reads (an
    encoder-decoder config). positions: (B, S), or (3, B, S) for M-RoPE;
    by default every row is ``arange(S)``."""
    b, s = tokens.shape
    if cfg.n_experts and current_mesh() is not None:
        moe.check_expert_shards(params["stack"], cfg.n_experts, b)
    x = _embed(params, cfg, tokens)
    if cfg.n_vision_tokens and vision_embeds is not None:
        nv = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
    if cfg.pos_embed == "sinusoidal":
        pos = sinusoidal(torch.arange(s, device=x.device), cfg.d_model)
        x = x + pos.to(x.dtype)[None]
    memory = None
    if cfg.enc_dec:
        if audio_feats is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             f"audio_feats (B, enc_len, d_model)")
        memory = encode(params, cfg, audio_feats)
    if positions is None:
        positions = _default_positions(cfg, b, s, tokens.device)
    ctx = _make_ctx(cfg, positions, memory=memory, window=window)
    return apply_stack(params["stack"], cfg, x, ctx)


def forward(params, cfg: ArchConfig, tokens, *, vision_embeds=None,
            audio_feats=None, positions=None, window=None):
    """tokens: (B, S) -> (logits (B,S,V), aux)."""
    x, aux = hidden_states(params, cfg, tokens, vision_embeds=vision_embeds,
                           audio_feats=audio_feats, positions=positions,
                           window=window)
    return _head(params, cfg, x), aux


def _ce_from_logits(logits, labels):
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def _chunked_ce(params, cfg, hidden, labels, chunk):
    """CE over sequence chunks of the LM head, a Python loop where the
    JAX package scans: each chunk's logits are (B, chunk, V)."""
    b, s, d = hidden.shape
    assert s % chunk == 0, (s, chunk)
    sums = [torch.sum(_ce_from_logits(_head(params, cfg, hidden[:, i:i + chunk]),
                                      labels[:, i:i + chunk]), dim=-1)
            for i in range(0, s, chunk)]
    return torch.sum(torch.stack(sums), dim=0) / s  # (B,) mean over positions


def per_example_loss(params, cfg: ArchConfig, batch, window=None):
    """Causal-LM cross entropy -> ((B,) per-example losses, aux)."""
    labels = batch["labels"]
    modality = dict(vision_embeds=batch.get("vision_embeds"),
                    audio_feats=batch.get("audio_feats"))
    if cfg.loss_chunk and labels.shape[1] % cfg.loss_chunk == 0 \
            and "loss_mask" not in batch:
        hidden, aux = hidden_states(params, cfg, batch["tokens"],
                                    window=window, **modality)
        return _chunked_ce(params, cfg, hidden, labels, cfg.loss_chunk), aux
    logits, aux = forward(params, cfg, batch["tokens"], window=window,
                          **modality)
    ce = _ce_from_logits(logits, labels)  # (B, S)
    if "loss_mask" in batch:
        m = batch["loss_mask"].to(torch.float32)
        return (torch.sum(ce * m, dim=-1)
                / torch.clamp(torch.sum(m, dim=-1), min=1.0)), aux
    return torch.mean(ce, dim=-1), aux


# ----------------------------------------------------------------- decode

def _state_lead_dims(superblock, n_super, idx):
    """A segment's leading state axes: a shared segment has one state a
    call site, ``(n_super,)``; a repeated one one a layer."""
    _, count, shared = superblock[idx]
    if n_super > 1:
        return (n_super,) if shared else (n_super, count)
    return () if shared else (count,)


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int, dtype=None,
                      device=None):
    """Zero decode state mirroring the stack layout: per segment, each
    leaf of the block's state with the segment's leading axes."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    superblock = cfg.resolved_superblock
    states = {}
    for idx, (kind, _, _) in enumerate(superblock):
        state = get_block(kind).state
        if state is None:
            continue
        base = state(cfg, batch, cache_len, dtype, device)
        lead = _state_lead_dims(superblock, cfg.n_super, idx)
        states[_seg_key(idx)] = tree_map(
            lambda l: torch.zeros(lead + l.shape, dtype=l.dtype,
                                  device=device), base)
    return states


def decode_stack(params, cfg: ArchConfig, x, states, pos, ctx):
    """Every layer's state is a view into the stacked state tensors, and
    the blocks write their states in place, so the stacked states come
    back updated without a copy."""
    segments = []
    for idx, (kind, _, shared) in enumerate(cfg.resolved_superblock):
        key = _seg_key(idx)
        segments.append((get_block(kind).decode,
                         _per_super(params[key], shared, cfg.n_super),
                         _per_super(states[key], shared, cfg.n_super,
                                    per_call=True)))
    for sup in range(cfg.n_super):
        for decode, layers, layer_states in segments:
            for p, st in zip(layers[sup], layer_states[sup]):
                x, _ = decode(p, x, st, pos, ctx, cfg)
    return x, states


def decode_step(params, cfg: ArchConfig, tokens, states, pos, *,
                memory=None, window=None):
    """One serving step. tokens: (B, 1); pos: int, the absolute position;
    memory: the encoder output of an encoder-decoder config
    (:func:`encode`). Returns (logits (B, vocab), states), the states
    updated in place."""
    if cfg.n_experts and current_mesh() is not None:
        moe.check_expert_shards(params["stack"], cfg.n_experts,
                                tokens.shape[0])
    x = _embed(params, cfg, tokens)
    if cfg.pos_embed == "sinusoidal":
        pos_t = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        x = x + sinusoidal(pos_t, cfg.d_model).to(x.dtype)[None]
    ctx = _make_ctx(cfg, None, memory=memory, window=window)
    x, states = decode_stack(params["stack"], cfg, x, states, pos, ctx)
    logits = _head(params, cfg, x)
    return logits[:, 0], states


def decode_cache_len(cfg: ArchConfig, seq_len: int, window=None) -> int:
    """Cache length: ring-buffer window for SWA, else the full context."""
    w = cfg.sliding_window if window is None else window
    return min(seq_len, w) if w and w > 0 else seq_len
