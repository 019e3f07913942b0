"""PyTorch/CUDA port of the energy-harvesting distributed-SGD system.

Mirrors the layout of the JAX package ``repro`` module for module, so a
reader finds each function's counterpart under the same path. The port
imports torch and numpy only. Its entry points run on the CUDA card
unless the caller passes ``device="cpu"`` (see :mod:`repro_torch._device`).

Ported so far: the paper's training loop (``core``: energy arrivals,
schedulers, flat aggregation, the ``ClientSimulator``, the quadratic
convergence problems), ``optim``, the Fig-1 CNN (``models``), ``data``,
the threefry generator (``random``), the aggregate kernels
(``kernels.aggregate``) and ``convert`` (JAX pytrees to torch); and the
stablelm-1.6b serving path: ``configs``, the ``attn_mlp`` LM stack
(``models.attention``, ``models.blocks``, ``models.transformer``), the
prefill and serve steps (``launch.steps``) and the flash-attention
kernel (``kernels.flash_attention``).
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
