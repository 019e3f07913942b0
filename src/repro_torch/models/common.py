"""Shared model pieces: initializers and the dense layer.

Port of the part of ``repro.models.common`` the CNN needs. Parameters
are plain nested dicts of tensors; every layer is an ``init_*(key, ...)
-> params`` plus a pure apply function. Dense weights are ``(d_in,
d_out)``, as in the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom


def normal_init(key, shape, dtype, stddev):
    return (stddev * trandom.normal(key, shape)).to(dtype)


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
