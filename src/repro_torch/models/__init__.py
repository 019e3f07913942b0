"""Models of the port: the Fig-1 CNN (the LM zoo waits, ROADMAP Queue 1
item 12)."""

from repro_torch.models.cnn import (
    client_grads_fn,
    cnn_accuracy,
    cnn_forward,
    cnn_loss,
    init_cnn,
)

__all__ = ["init_cnn", "cnn_forward", "cnn_loss", "cnn_accuracy",
           "client_grads_fn"]
