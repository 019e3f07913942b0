"""The paper's experiment model: the McMahan et al. CIFAR CNN.

Port of ``repro.models.cnn``: two 5×5 SAME conv layers (32, 64
channels), each followed by ReLU and 2×2 max-pool, then a dense 64-unit
ReLU layer and a dense head. At 32×32×3 inputs it has 316,554
parameters. The public layout is the JAX package's: NHWC images, HWIO
conv weights, ``(d_in, d_out)`` dense weights; the conv permutes to
NCHW/OIHW only inside :func:`_conv`, and the flatten before ``fc1``
runs in NHWC order, so the same parameter tree gives the same logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch.models.common import dense, dense_init, normal_init


def init_cnn(key, *, in_channels=3, n_classes=10, image_hw=32,
             dtype=torch.float32):
    """Random CNN parameters on ``key``'s device."""
    k1, k2, k3, k4 = trandom.split(key, 4).unbind(0)
    flat = (image_hw // 4) * (image_hw // 4) * 64
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=key.device)
    return {
        "conv1": {"w": normal_init(k1, (5, 5, in_channels, 32), dtype,
                                   (5 * 5 * in_channels) ** -0.5),
                  "b": zeros(32)},
        "conv2": {"w": normal_init(k2, (5, 5, 32, 64), dtype,
                                   (5 * 5 * 32) ** -0.5),
                  "b": zeros(64)},
        "fc1": dense_init(k3, flat, 64, dtype, use_bias=True),
        "head": dense_init(k4, 64, n_classes, dtype, use_bias=True),
    }


def _conv(p, x):
    """5×5 SAME conv, NHWC in and out, HWIO weights."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                 padding="same")
    return y.permute(0, 2, 3, 1) + p["b"]


def _maxpool2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def cnn_forward(params, images):
    """images: (B, H, W, C) -> logits (B, n_classes)."""
    x = torch.relu(_conv(params["conv1"], images))
    x = _maxpool2(x)
    x = torch.relu(_conv(params["conv2"], x))
    x = _maxpool2(x)
    x = x.flatten(1)
    x = torch.relu(dense(params["fc1"], x))
    return dense(params["head"], x)


def cnn_loss(params, images, labels):
    """Mean cross-entropy over the batch (scalar)."""
    logits = cnn_forward(params, images).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None].to(torch.int64))[:, 0]
    return torch.mean(lse - gold)


def cnn_accuracy(params, images, labels):
    logits = cnn_forward(params, images)
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))


def client_grads_fn(batcher):
    """``grads_fn`` for :class:`repro_torch.core.trainer.ClientSimulator`:
    per-client CNN gradients of a minibatch drawn by ``batcher``
    (``torch.func.vmap`` of ``torch.func.grad`` over the client axis),
    the counterpart of ``per_client_grads_fn`` in
    ``examples/paper_cifar.py``."""
    per_client = torch.func.vmap(torch.func.grad(cnn_loss),
                                 in_dims=(None, 0, 0))

    def grads_fn(params, key, t):
        del t
        batch = batcher.sample(key)
        return per_client(params, batch["x"], batch["y"])

    return grads_fn
