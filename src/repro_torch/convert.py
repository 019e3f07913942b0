"""Carry JAX-package values over into the port, as numpy.

:func:`params_from_jax` turns a parameter tree of the JAX package (its
leaves numpy arrays, or anything ``np.asarray`` reads) into the port's
tree of tensors, same structure, same layouts. :func:`carry_from_jax`
does the same for a ``SimCarry``, flat or a legacy tree carry (bf16
leaves bit for bit): params, optimizer state,
scheduler state, energy state, key, step counter and fault state (``()``,
a stale-update ring, or a tuple of them for a composite).
:func:`train_state_from_jax` carries the SPMD LM train step's
``TrainState`` (params, the Adam/momentum/SGD state, the step counter),
whose key paths the port keeps, so a full-state driver checkpoint reads
the same in both packages. :func:`fault_from_jax` turns a fault
component into the port's. None imports JAX: state NamedTuples and
fault families are matched to the port's by class name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import energy, faults, scheduling
from repro_torch.core.trainer import SimCarry, TrainState
from repro_torch.optim import optimizers

_STATES = {cls.__name__: cls for cls in (
    optimizers.SGDState, optimizers.MomentumState, optimizers.AdamState,
    scheduling.AppointmentState, scheduling.WaitForAllState,
    scheduling.BatteryState, energy.UniformArrivalsState, SimCarry,
    TrainState)}


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
    """A JAX parameter tree (numpy leaves) → the port's tree of tensors,
    each leaf in its own dtype and shape (a recurrent stack mixes f32
    leaves such as ``a_log`` with bf16 ones under leading ``(n_super,
    count)`` axes), bf16 bit for bit."""
    return _convert(tree, resolve_device(device))


def carry_from_jax(carry, device=None) -> SimCarry:
    """A JAX ``SimCarry`` → the port's :class:`SimCarry`: a flat carry,
    or a legacy tree carry with each leaf in its dtype (bf16 bit for
    bit)."""
    return _convert(carry, resolve_device(device))


def train_state_from_jax(state, device=None) -> TrainState:
    """A JAX ``TrainState`` (numpy leaves) → the port's
    :class:`~repro_torch.core.trainer.TrainState`, leaf for leaf (bf16
    leaves bit for bit)."""
    return _convert(state, resolve_device(device))


_FAULTS = {cls.__name__: cls for cls in (
    faults.DropUpdates, faults.CorruptGradients, faults.StaleUpdates,
    faults.OfflineWindows)}


def fault_from_jax(fault):
    """A JAX fault component → the port's (tensors on the CPU, placed by
    the simulator), so both packages can run the same component. None
    stays None."""
    if fault is None:
        return None
    name = type(fault).__name__
    if name == "CompositeFault":
        return faults.CompositeFault(tuple(map(fault_from_jax, fault.parts)))
    try:
        cls = _FAULTS[name]
    except KeyError:
        raise TypeError(f"no port counterpart for fault {name}") from None
    kw = {f.name: getattr(fault, f.name) for f in dataclasses.fields(fault)}
    return cls(**{k: v if k in cls.meta_fields else _tensor(v, "cpu")
                  for k, v in kw.items()})
