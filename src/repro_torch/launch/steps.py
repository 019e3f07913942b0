"""Step-function builders: train / prefill / serve per architecture.

Port of ``repro.launch.steps``. The energy-harvesting weighting (paper
eq. 11/12) enters ``train_step`` through the (mask, scale) scheduler
outputs — see :func:`repro_torch.core.trainer.build_energy_train_step`.
PyTorch runs eagerly, so a builder returns a plain function where the
JAX package's is jitted by its caller.

Under a mesh of ranks (``use_mesh(mesh, batch=B)``,
:mod:`repro_torch.models.common`) the train steps run as the JAX
package's run under ``with mesh:``: each rank passes the global batch,
with the parameters of ``place_params`` or ``init_lm(mesh=)`` (an MoE
stack's experts split over ``"model"``), and its optimizer state is that
of its own parameters (:func:`repro_torch.core.trainer.
build_energy_train_step`).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.trainer import build_energy_train_step
from repro_torch.models import transformer
from repro_torch.optim import adamw, sgd


def make_train_step(cfg: ArchConfig, n_clients: int, *, lr: float = 1e-4,
                    optimizer=None, window=None):
    """Returns (init_state, train_step(state, batch, mask, scale))."""
    if optimizer is None:
        optimizer = adamw(lr)

    def loss_fn(params, batch):
        return transformer.per_example_loss(params, cfg, batch, window=window)

    return build_energy_train_step(
        per_example_loss_fn=loss_fn,
        optimizer=optimizer,
        n_clients=n_clients,
        aux_loss_weight=(0.01 if cfg.n_experts else 0.0),
    )


def make_prefill_step(cfg: ArchConfig, *, window=None):
    """prefill(params, batch) -> last-position logits (B, vocab).

    The LM head is applied to the final position only, so the
    (B, S, vocab) logits tensor never materializes. As in the JAX
    package, the prefill fills no KV cache: a served sequence's cache is
    built by the serve step, one token at a time.
    """

    def prefill(params, batch):
        x, _ = transformer.hidden_states(
            params, cfg, batch["tokens"],
            vision_embeds=batch.get("vision_embeds"),
            audio_feats=batch.get("audio_feats"),
            window=window)
        logits = transformer._head(params, cfg, x[:, -1:])
        return logits[:, 0]

    return prefill


def make_serve_step(cfg: ArchConfig, *, window=None):
    """serve(params, tokens (B,1), states, pos[, memory]) ->
    (next_token (B,) int32, logits (B,vocab), states).

    ``pos`` is a Python int; the states are updated in place
    (:func:`repro_torch.models.attention.decode_attention`); ``memory``
    is an encoder-decoder config's encoder output
    (:func:`repro_torch.models.transformer.encode`)."""

    def serve(params, tokens, states, pos, memory=None):
        logits, new_states = transformer.decode_step(
            params, cfg, tokens, states, pos, memory=memory, window=window)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, new_states

    return serve


def make_sgd_train_step(cfg: ArchConfig, n_clients: int, lr: float = 0.05,
                        window=None):
    """Paper-exact variant: plain SGD server update (eq. 11)."""
    return make_train_step(cfg, n_clients, optimizer=sgd(lr), window=window)
