"""Step-function builders: prefill and serve.

Port of the serving half of ``repro.launch.steps``. The train steps
come with the LM training slice (ROADMAP Queue 1 item 12). PyTorch runs
eagerly, so a builder returns a plain function where the JAX package's
is jitted by its caller.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.blocks import NOT_PORTED


def make_prefill_step(cfg: ArchConfig, *, window=None):
    """prefill(params, batch) -> last-position logits (B, vocab).

    The LM head is applied to the final position only, so the
    (B, S, vocab) logits tensor never materializes. As in the JAX
    package, the prefill fills no KV cache: a served sequence's cache is
    built by the serve step, one token at a time.
    """

    def prefill(params, batch):
        extra = sorted(set(batch) & {"vision_embeds", "audio_feats"})
        if extra:
            raise NotImplementedError(
                f"{', '.join(extra)} not ported yet ({NOT_PORTED})")
        x, _ = transformer.hidden_states(params, cfg, batch["tokens"],
                                         window=window)
        logits = transformer._head(params, cfg, x[:, -1:])
        return logits[:, 0]

    return prefill


def make_serve_step(cfg: ArchConfig, *, window=None):
    """serve(params, tokens (B,1), states, pos) ->
    (next_token (B,) int32, logits (B,vocab), states).

    ``pos`` is a Python int; the states are updated in place
    (:func:`repro_torch.models.attention.decode_attention`)."""

    def serve(params, tokens, states, pos, memory=None):
        logits, new_states = transformer.decode_step(
            params, cfg, tokens, states, pos, memory=memory, window=window)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, new_states

    return serve
