"""GQA attention: the prefill path and the decode path with a KV cache.

Port of ``repro.models.attention``: grouped-query attention with RoPE or
M-RoPE (qwen2-vl), causal or bidirectional (the whisper encoder), cross
attention over an encoder memory (the whisper decoder, ``kv_override``),
an optional sliding window, the flash-attention kernel K3 on the prefill
path (``use_flash``), and one-token decode through a full cache or a
ring buffer. As in the JAX package, only causal self-attention goes
through K3; bidirectional and cross attention take :func:`_sdpa`.
Training differentiates the plain path (:func:`_sdpa`); K3 has no
backward, in the JAX package as here, so a flash prefill that needs
gradients raises.

Tensor convention as in the JAX package: x (B, S, D); q (B, S, H, Dh);
kv (B, S, Hkv, Dh).
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import apply_mrope, apply_rope, dense, dense_init

NEG_INF = -1e30


def init_attention(key, d_model, n_heads, n_kv_heads, head_dim, dtype,
                   use_bias=False):
    kq, kk, kv, ko = trandom.split(key, 4)
    return {
        "wq": dense_init(kq, d_model, n_heads * head_dim, dtype, use_bias),
        "wk": dense_init(kk, d_model, n_kv_heads * head_dim, dtype, use_bias),
        "wv": dense_init(kv, d_model, n_kv_heads * head_dim, dtype, use_bias),
        "wo": dense_init(ko, n_heads * head_dim, d_model, dtype, use_bias),
    }


def _split_heads(x, n, dh):
    return x.reshape(x.shape[:-1] + (n, dh))


def _rope(q, k, positions, theta, m_rope, mrope_sections):
    if positions is None:
        return q, k
    if m_rope:
        return (apply_mrope(q, positions, theta, mrope_sections),
                apply_mrope(k, positions, theta, mrope_sections))
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)


class _MatmulF32(torch.autograd.Function):
    """``bmm`` of two bf16 (or f16) operands with an f32 result, and its
    gradient by JAX's transpose rule for ``dot_general`` with
    ``preferred_element_type=float32``: the f32 cotangent times the other
    operand (upcast, so the product is f32), each gradient cast back to
    its operand's dtype. On the card the forward goes to the tensor cores
    with an f32 output (``out_dtype``), so neither operand is copied to
    f32; the CPU has no such product, and upcasts, which gives the same
    numbers."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.to(torch.float32), b.to(torch.float32))

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(ct, b.to(torch.float32).transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.to(torch.float32).transpose(1, 2), ct).to(b.dtype)
        return ga, gb


def _mm_f32(a, b):
    """Batched product with an f32 result: the products of bf16 values
    are exact and the sum is f32, as JAX's
    ``preferred_element_type=float32`` (:class:`_MatmulF32`)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _MatmulF32.apply(a, b)


def _sdpa(q, k, v, mask):
    """Plain scaled-dot-product GQA attention, at the JAX package's
    rounding points: q scaled in its own dtype, logits in f32, the
    probabilities cast to v's dtype before the PV product, which sums in
    f32, and the result cast to q's dtype.

    q: (B,S,H,Dh), k/v: (B,T,Hkv,Dh); mask: additive, broadcastable to
    (B, Hkv, G, S, T) from its trailing axes, or None.
    """
    return _sdpa_heads(q, k.transpose(1, 2), v.transpose(1, 2), mask)


def _sdpa_heads(q, k, v, mask):
    """:func:`_sdpa` with k/v head-major, (B, Hkv, T, Dh), the layout of
    the decode cache. A contiguous k/v is read in place by one batched
    product over B·Hkv, so the decode step never copies the cache: not
    to f32 (the JAX package's ``_sdpa`` keeps K/V in their dtype for the
    same reason) and not to another layout."""
    b, s, h, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    # JAX rounds the Python scale to q's dtype before the multiply.
    scale = torch.tensor(dh ** -0.5, dtype=q.dtype).item()
    qs = (q * scale).reshape(b, s, hkv, g, dh).permute(0, 2, 3, 1, 4)
    qs = qs.reshape(b * hkv, g * s, dh)
    logits = _mm_f32(qs, k.reshape(b * hkv, t, dh).transpose(1, 2))
    logits = logits.reshape(b, hkv, g, s, t)
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = _mm_f32(probs.reshape(b * hkv, g * s, t), v.reshape(b * hkv, t, dh))
    out = out.reshape(b, hkv, g, s, dh).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h, dh).to(q.dtype)


def causal_mask(s, t_len=None, window=0, offset=0, device=None):
    """Additive (S, T) mask. ``offset`` = absolute position of query 0
    relative to key 0. ``window > 0`` keeps only keys within ``window``
    positions behind the query (sliding window)."""
    t_len = t_len or s
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(t_len, device=device)[None, :]
    ok = kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def attention(params, x, *, n_heads, n_kv_heads, head_dim,
              positions=None, rope_theta=1e4, m_rope=False,
              mrope_sections=(16, 24, 24), causal=True, window=0,
              kv_override=None, use_flash=False):
    """Full-sequence attention (prefill, the encoder, cross attention).
    With ``use_flash``, ``causal`` and no ``kv_override`` it runs the
    flash-attention kernel K3, exactly where the JAX package calls its
    Pallas kernel; otherwise :func:`_sdpa`.

    kv_override: (B, T, D) memory for cross attention (the whisper
    decoder); when set, keys and values come from it, without rotary and
    unmasked (``causal`` is ignored)."""
    b, s, _ = x.shape
    q = _split_heads(dense(params["wq"], x), n_heads, head_dim)
    kv_in = x if kv_override is None else kv_override
    k = _split_heads(dense(params["wk"], kv_in), n_kv_heads, head_dim)
    v = _split_heads(dense(params["wv"], kv_in), n_kv_heads, head_dim)
    if kv_override is None:
        q, k = _rope(q, k, positions, rope_theta, m_rope, mrope_sections)

    if use_flash and kv_override is None and causal:
        if any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "the flash-attention kernel has no backward; train with "
                "use_flash=False (plain attention), as the JAX package does")
        out = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True, window=window)
    else:
        mask = None
        if kv_override is None and causal:
            mask = causal_mask(s, k.shape[1], window=window, device=x.device)
        out = _sdpa(q, k, v, mask)
    return dense(params["wo"], out.reshape(b, s, n_heads * head_dim))


# ------------------------------------------------------------------ decode

def init_kv_cache(batch, n_kv_heads, head_dim, cache_len, dtype, device=None):
    """cache_len = full seq for dense attention, window for SWA (ring).

    Head-major, (B, Hkv, cache_len, Dh), where the JAX package's cache
    is (B, cache_len, Hkv, Dh): :func:`_sdpa_heads` then reads each
    head's keys and values in place."""
    shape = (batch, n_kv_heads, cache_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params, x, cache, pos, *, n_heads, n_kv_heads, head_dim,
                     rope_theta=1e4, m_rope=False, mrope_sections=(16, 24, 24),
                     window=0, kv_override=None, use_rope=True):
    """One-token decode. x: (B, 1, D); pos: int, the absolute position.

    Full attention: cache length = max context; slot ``pos`` is written.
    Sliding window: the cache is a ring buffer of length ``window``;
    slot ``pos % window`` is overwritten. Returns (y, cache). With M-RoPE
    the three position rows are all ``pos``, as in the JAX package.

    kv_override: (B, T, D) encoder memory. The step then attends over
    the memory's keys and values, formed anew each step as the JAX
    package does, and returns ``cache`` untouched.

    The new k and v are written into ``cache`` in place and the same
    tensors are returned. The JAX package returns an updated copy
    (``dynamic_update_slice`` under a donating jit, which updates in
    place too); copying here would move the whole cache every step.
    """
    b = x.shape[0]
    q = _split_heads(dense(params["wq"], x), n_heads, head_dim)
    if kv_override is not None:
        k = _split_heads(dense(params["wk"], kv_override), n_kv_heads, head_dim)
        v = _split_heads(dense(params["wv"], kv_override), n_kv_heads, head_dim)
        out = _sdpa(q, k, v, None)
        return dense(params["wo"], out.reshape(b, 1, n_heads * head_dim)), cache

    k_new = _split_heads(dense(params["wk"], x), n_kv_heads, head_dim)
    v_new = _split_heads(dense(params["wv"], x), n_kv_heads, head_dim)
    if use_rope:
        posv = torch.full((b, 1), pos, device=x.device)
        if m_rope:
            posv3 = posv.expand((3,) + posv.shape)
            q = apply_mrope(q, posv3, rope_theta, mrope_sections)
            k_new = apply_mrope(k_new, posv3, rope_theta, mrope_sections)
        else:
            q = apply_rope(q, posv, rope_theta)
            k_new = apply_rope(k_new, posv, rope_theta)

    cache_len = cache["k"].shape[2]
    slot = (pos % cache_len) if window > 0 else pos
    cache["k"][:, :, slot] = k_new[:, 0]
    cache["v"][:, :, slot] = v_new[:, 0]

    # Validity of cache slots: absolute position of slot j.
    j = torch.arange(cache_len, device=x.device)
    if window > 0:
        # Ring buffer: slot j holds the latest absolute position ≤ pos
        # with abs % L == j; valid iff abs > pos − window and abs ≥ 0.
        abs_pos = pos - torch.remainder(pos - j, cache_len)
        valid = (abs_pos >= 0) & (abs_pos >= pos - window + 1)
    else:
        valid = j <= pos
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, :]  # (1, T)
    out = _sdpa_heads(q, cache["k"], cache["v"], mask)
    y = dense(params["wo"], out.reshape(b, 1, n_heads * head_dim))
    return y, cache
