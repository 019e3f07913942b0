"""Shared model pieces: the mesh context, initializers, the dense layer,
norms, rotary.

Port of ``repro.models.common``. Parameters are plain nested dicts of
tensors; every layer is an ``init_*(key, ...) -> params`` plus a pure
apply function. Dense weights are ``(d_in, d_out)``, as in the JAX
package.

The mesh context: :func:`use_mesh` is the port's ``with mesh:``, and
:func:`current_mesh` reads it as the JAX package's does. Under a mesh of
ranks (:func:`repro_torch.experiments.placement.make_mesh`) every rank
runs the model on its own rows, replicated over ``"model"``: its block
of the batch over the data axes (:func:`data_rows`) when they divide the
batch, else every row. Only the MoE layer reads the mesh
(:mod:`repro_torch.models.moe`). ``maybe_shard`` has no counterpart: it
never changes a value, and a rank's tensors are its block already.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch._tree import tree_leaves
from repro_torch.sharding.rules import DATA_AXES, block_index

_CONTEXT = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, *, batch=None):
    """Run the model under ``mesh`` (None: no mesh) in this thread.

    ``batch`` is the global batch. When the mesh's data axes divide it,
    a tensor's batch axis holds this rank's block of rows
    (:func:`data_rows`); otherwise, or without ``batch``, every row."""
    previous = getattr(_CONTEXT, "value", None)
    _CONTEXT.value = None if mesh is None else (mesh, batch)
    try:
        yield mesh
    finally:
        _CONTEXT.value = previous


def mesh_context():
    """The innermost :func:`use_mesh` context of this thread, as
    :func:`within_context` takes it back (None without one)."""
    return getattr(_CONTEXT, "value", None)


@contextlib.contextmanager
def within_context(value):
    """Run under a context :func:`mesh_context` captured, in any thread:
    autograd runs a CUDA tensor's backward, and so remat's recomputation
    of a layer, in a thread of its own, which must see the forward's
    mesh."""
    previous = getattr(_CONTEXT, "value", None)
    _CONTEXT.value = value
    try:
        yield
    finally:
        _CONTEXT.value = previous


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    value = getattr(_CONTEXT, "value", None)
    return None if value is None else value[0]


def data_shards(mesh) -> int:
    """The product of the mesh's data axes (1 without any)."""
    sizes = dict(mesh.shape)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def rows_split() -> bool:
    """Whether, under the current mesh, a tensor's batch axis holds this
    rank's block of rows over more than one data shard (:func:`use_mesh`'s
    ``batch`` divides them)."""
    value = getattr(_CONTEXT, "value", None)
    if value is None or value[1] is None:
        return False
    dp = data_shards(value[0])
    return dp > 1 and value[1] % dp == 0


def data_rows(batch: int, mesh) -> slice:
    """This rank's rows of a global batch of ``batch`` under ``mesh``: its
    block over the data axes when they divide ``batch``, else all."""
    dp = data_shards(mesh)
    if dp == 1 or batch % dp:
        return slice(0, batch)
    axes = tuple(a for a in DATA_AXES if a in mesh.shape)
    index, _ = block_index(axes, mesh)
    size = batch // dp
    return slice(index * size, (index + 1) * size)


# ---------------------------------------------------------------- initializers

def normal_init(key, shape, dtype, stddev, rows=None):
    """``stddev``·N(0, 1) of ``shape`` in ``dtype``; ``rows`` (a slice of
    the leading axis) draws those rows alone, with the bits they have in
    the whole draw."""
    # In place: a full-width draw is not held twice in f32.
    return trandom.normal(key, shape, rows=rows).mul_(stddev).to(dtype)


def lecun_init(key, shape, dtype, fan_in=None, rows=None):
    fan_in = fan_in or shape[0]
    return normal_init(key, shape, dtype, fan_in ** -0.5, rows=rows)


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
