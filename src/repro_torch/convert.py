"""Carry JAX-package values over into the port, as numpy.

:func:`params_from_jax` turns a parameter tree of the JAX package (its
leaves numpy arrays, or anything ``np.asarray`` reads) into the port's
tree of tensors, same structure, same layouts. :func:`carry_from_jax`
does the same for a flat ``SimCarry``: params, optimizer state,
scheduler state, energy state, key and step counter. Neither imports
JAX: state NamedTuples are matched to the port's by class name.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import energy, scheduling
from repro_torch.core.trainer import SimCarry
from repro_torch.optim import optimizers

_STATES = {cls.__name__: cls for cls in (
    optimizers.SGDState, optimizers.MomentumState, optimizers.AdamState,
    scheduling.AppointmentState, scheduling.WaitForAllState,
    scheduling.BatteryState, energy.UniformArrivalsState, SimCarry)}


def _tensor(x, device):
    arr = np.asarray(x)
    if arr.dtype == np.uint32:  # PRNG key words: the port keeps them in int64
        arr = arr.astype(np.int64)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: carry the
        # 16-bit patterns over and reinterpret them, bit for bit.
        bits = np.array(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _convert(x, device):
    if isinstance(x, dict):
        return {k: _convert(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        try:
            cls = _STATES[type(x).__name__]
        except KeyError:
            raise TypeError(
                f"no port counterpart for state {type(x).__name__}") from None
        return cls(*(_convert(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_convert(v, device) for v in x)
    if x is None:
        return None
    return _tensor(x, device)


def params_from_jax(tree, device=None):
    """A JAX parameter tree (numpy leaves) → the port's tree of tensors."""
    return _convert(tree, resolve_device(device))


def carry_from_jax(carry, device=None) -> SimCarry:
    """A flat JAX ``SimCarry`` → the port's :class:`SimCarry`. Fault
    state is not ported yet, so the carry must hold none."""
    if tuple(carry.fault_state) != ():
        raise NotImplementedError(
            "fault state is not ported yet (ROADMAP Queue 1 item 9)")
    return _convert(carry, resolve_device(device))
