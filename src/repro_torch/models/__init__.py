"""Models of the port: the Fig-1 CNN and the LM stack of the ported
block kinds (``attn_mlp``, ``attn_moe``, ``mamba2``, ``mlstm``,
``slstm``; the encoder-decoder and vision inputs wait, ROADMAP Queue 1
step 8), with its training loss."""

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
    forward,
    init_decode_state,
    init_lm,
    per_example_loss,
)

__all__ = ["init_cnn", "cnn_forward", "cnn_loss", "cnn_accuracy",
           "client_grads_fn", "count_params", "init_lm", "forward",
           "init_decode_state", "decode_step", "decode_cache_len",
           "per_example_loss", "init_moe", "apply_moe", "dispatch_counts",
           "reset_dispatch_counts", "dropped_share"]
