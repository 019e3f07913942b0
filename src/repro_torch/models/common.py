"""Shared model pieces: initializers, the dense layer, norms, rotary.

Port of ``repro.models.common`` without its sharding hints (the port
runs on one card). Parameters are plain nested dicts of tensors; every layer is an
``init_*(key, ...) -> params`` plus a pure apply function. Dense weights
are ``(d_in, d_out)``, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch._tree import tree_leaves


def normal_init(key, shape, dtype, stddev):
    # In place: a full-width draw is not held twice in f32.
    return trandom.normal(key, shape).mul_(stddev).to(dtype)


def lecun_init(key, shape, dtype, fan_in=None):
    fan_in = fan_in or shape[0]
    return normal_init(key, shape, dtype, fan_in ** -0.5)


def dense_init(key, d_in, d_out, dtype, use_bias=False, stddev=None):
    p = {"w": lecun_init(key, (d_in, d_out), dtype) if stddev is None
         else normal_init(key, (d_in, d_out), dtype, stddev)}
    if use_bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=key.device)
    return p


def dense(params, x):
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def norm_init(d, dtype, kind="rmsnorm", device=None):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(params, x, kind="rmsnorm", eps=1e-6):
    """RMSNorm or LayerNorm computed in f32 and cast back to ``x``'s
    dtype, as the JAX package does (its eps is 1e-6 for both kinds)."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:  # layernorm
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(torch.float32)
    if "bias" in params:
        y = y + params["bias"].to(torch.float32)
    return y.to(x.dtype)


def activation(name):
    """``jax.nn.gelu`` defaults to the tanh approximation, so the port's
    gelu does too."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def rope_freqs(head_dim, theta, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta=1e4):
    """Rotary embedding in the rotate-half layout over the full head dim.
    x: (..., S, H, Dh); positions: broadcastable (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, Dh/2)
    ang = ang[..., None, :]  # head axis
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta=1e4, sections=(16, 24, 24)):
    """Qwen2-VL M-RoPE [arXiv:2409.12191]: the Dh/2 frequency slots are
    split into (temporal, height, width) sections, each rotated by its
    own position row. positions3: (3, ..., S). With three equal rows it
    gives :func:`apply_rope`'s bits."""
    dh = x.shape[-1]
    half = dh // 2
    sections = tuple(sections)
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(dh, theta, x.device)  # (half,)
    pos = torch.cat([positions3[i][..., None].to(torch.float32).expand(
        positions3[i].shape + (sec,)) for i, sec in enumerate(sections)],
        dim=-1)  # (..., S, half)
    ang = (pos * freqs)[..., None, :]  # head axis
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def count_params(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))
