"""Models of the port: the Fig-1 CNN and the LM stack of every block
kind of the JAX package (``attn_mlp``, ``attn_moe``, ``mamba2``,
``mlstm``, ``slstm``, and whisper's ``enc_attn_mlp`` and ``xattn``),
with vision tokens, the whisper encoder and its training loss."""

from repro_torch.models.cnn import (
    client_grads_fn,
    cnn_accuracy,
    cnn_forward,
    cnn_loss,
    init_cnn,
)
from repro_torch.models.common import count_params
from repro_torch.models.moe import (
    apply_moe,
    dispatch_counts,
    dropped_share,
    init_moe,
    reset_dispatch_counts,
)
from repro_torch.models.transformer import (
    decode_cache_len,
    decode_step,
    encode,
    forward,
    init_decode_state,
    init_lm,
    per_example_loss,
)

__all__ = ["init_cnn", "cnn_forward", "cnn_loss", "cnn_accuracy",
           "client_grads_fn", "count_params", "init_lm", "forward",
           "init_decode_state", "decode_step", "decode_cache_len", "encode",
           "per_example_loss", "init_moe", "apply_moe", "dispatch_counts",
           "reset_dispatch_counts", "dropped_share"]
