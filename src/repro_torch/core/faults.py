"""Client fault injection (delivery faults), as plain torch objects.

Port of ``repro.core.faults``. The paper's premise is clients that are
*intermittently unable to participate*. The energy process models the
benign case — a client with no energy simply does not compute. This
module models the hostile remainder: a client that *did* compute an
update which is then lost, delayed, or corrupted on its way to the
server.

Every fault family is a frozen dataclass whose rates and window tables
are tensor fields, kept on the CPU when built; :meth:`to` returns a copy
on another device, which is how
:class:`repro_torch.core.trainer.ClientSimulator` places it.

Protocol (all methods pure; nothing is written in place):

    init(key, n_clients, n_params) -> state          (() if stateless)
    apply(state, t, key, g) -> (state, g, keep)
    pad_clients(n_total)    -> same family, per-client fields padded

``apply`` sees the flat per-client gradient buffer ``g`` of shape
``(N, P)`` and returns the possibly-transformed buffer plus ``keep`` —
an ``(N,)`` float32 0/1 *delivery* mask (1 = the update reached the
server) or None when the family never drops. The simulator composes
``keep`` into the ``active_mask`` row select
(:func:`repro_torch.core.aggregation.compose_masks`), so a dropped row
contributes an *exact zero* through the masked kernels K1 and K2 even
when its gradient payload is NaN/inf (DESIGN.md §7).
Zero-weighting (``weights * keep``) keeps ``weight_sum`` an honest
record of delivered mass.

Randomness is drawn with the shape-independent per-client helper
:func:`repro_torch.core.energy.client_uniform`, so a padded (ragged) run
faults exactly the same rows as the natural-N run, a fault family at
rate 0 is the bitwise identity on the no-fault trajectory, and the draws
are the JAX package's bits.

Four concrete families + a combinator:

* ``DropUpdates``     — Bernoulli(rate) update loss per client per round.
* ``CorruptGradients``— Bernoulli(rate) row corruption: ``g_i <- g_i *
                        scale`` (scale may be NaN/inf to model poison).
* ``StaleUpdates``    — Bernoulli(rate) delay-``k`` replay: the server
                        receives the update the client sent ``k`` rounds
                        ago (dropped while no history exists, t < k).
* ``OfflineWindows``  — deterministic forced-outage intervals
                        (start/length, optionally repeating).
* ``CompositeFault``  — apply several families in sequence, delivery
                        masks composed multiplicatively.

The module also owns the **fault-family registry**
(:func:`register_fault_family` / :func:`make_fault`), from which the
experiment layer builds its ``faults`` sweep axis.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core.energy import _check_pad, _pad_leaf, client_uniform

#: Domain-separation constant for the per-step fault key: the simulator
#: derives ``k_fault = fold_in(k_grad, FAULT_SALT)`` instead of widening
#: the step's ``split`` arity, so every pre-existing random stream
#: (scheduler, energy, gradients) is bitwise unchanged whether or not a
#: fault component is present. The value ("FAUL") is far above any
#: client index or counter the gradient path folds in.
FAULT_SALT = 0x4641554C


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _as_rate(rate, name: str = "rate") -> torch.Tensor:
    """A Bernoulli rate (scalar or (N,)) as an f32 tensor, checked."""
    conc = _host(rate)
    if ((conc < 0) | (conc > 1)).any():
        raise ValueError(f"{name} must lie in [0, 1], got {conc}")
    return torch.as_tensor(rate, dtype=torch.float32)


class _Fault:
    """``to(device)``: a copy with every tensor field on ``device``; the
    fields are already checked, so the copy skips ``__post_init__``."""

    #: Fields the JAX package keeps as static treedef metadata rather
    #: than leaves: two values of one are two structure groups.
    meta_fields: ClassVar[tuple[str, ...]] = ()

    def to(self, device):
        new = object.__new__(type(self))
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            object.__setattr__(new, f.name, v.to(device)
                               if isinstance(v, torch.Tensor) else v)
        return new


def _per_client(x) -> bool:
    return x.dim() != 0


@dataclasses.dataclass(frozen=True, eq=False)
class DropUpdates(_Fault):
    """Bernoulli update loss: each round, client ``i``'s update is lost
    with probability ``rate_i`` (scalar or per-client)."""

    rate: torch.Tensor

    def __post_init__(self):
        object.__setattr__(self, "rate", _as_rate(self.rate))

    def init(self, key, n_clients: int, n_params: int):
        return ()

    def apply(self, state, t, key, g):
        u = client_uniform(key, g.shape[0])
        keep = (u >= self.rate).to(torch.float32)
        return state, g, keep

    def pad_clients(self, n_total: int):
        if not _per_client(self.rate):
            return self
        pad = _check_pad(self.rate.shape[0], n_total)
        # Padded rows never drop (rate 0) — they are masked out of the
        # aggregation anyway; a valid rate keeps the draw finite.
        return DropUpdates(_pad_leaf(self.rate, pad, 0.0))


@dataclasses.dataclass(frozen=True, eq=False)
class CorruptGradients(_Fault):
    """Bernoulli row corruption: with probability ``rate_i`` the row is
    scaled by ``scale`` before aggregation. ``scale`` may be any float —
    large (scaled attack), NaN/inf (poison), 0 (silent zeroing). The
    update is still *delivered* (keep is None); pair with
    :class:`DropUpdates` via :class:`CompositeFault` to model detected
    corruption."""

    rate: torch.Tensor
    scale: torch.Tensor

    def __post_init__(self):
        object.__setattr__(self, "rate", _as_rate(self.rate))
        object.__setattr__(self, "scale",
                           torch.as_tensor(self.scale, dtype=torch.float32))

    def init(self, key, n_clients: int, n_params: int):
        return ()

    def apply(self, state, t, key, g):
        u = client_uniform(key, g.shape[0])
        hit = u < self.rate
        # A select, not a 0/1 multiply: with a NaN scale, g·0 is NaN.
        g = torch.where(hit[:, None], g * self.scale.to(g.dtype), g)
        return state, g, None

    def pad_clients(self, n_total: int):
        if not _per_client(self.rate):
            return self
        pad = _check_pad(self.rate.shape[0], n_total)
        return CorruptGradients(_pad_leaf(self.rate, pad, 0.0), self.scale)


@dataclasses.dataclass(frozen=True, eq=False)
class StaleUpdates(_Fault):
    """Delay-``k`` replay: with probability ``rate_i`` the server receives
    the update client ``i`` computed ``delay`` rounds ago instead of the
    fresh one. While no history exists (t < delay) a stale-hit row is
    *dropped* (keep 0) rather than replayed as zero. State is a
    ``(delay, N, P)`` float32 ring of past gradient rows, indexed by
    ``t mod delay``.

    ``apply`` returns a new ring (one copy of it a step) and leaves the
    input ring as it was, so a carry the caller holds stays valid.
    """

    rate: torch.Tensor
    delay: int = 1

    meta_fields: ClassVar[tuple[str, ...]] = ("delay",)

    def __post_init__(self):
        object.__setattr__(self, "rate", _as_rate(self.rate))
        if int(self.delay) < 1:
            raise ValueError(f"delay must be >= 1, got {self.delay}")
        object.__setattr__(self, "delay", int(self.delay))

    def init(self, key, n_clients: int, n_params: int):
        return torch.zeros((self.delay, n_clients, n_params),
                           dtype=torch.float32, device=key.device)

    def apply(self, state, t, key, g):
        t = torch.as_tensor(t, device=g.device)
        slot = torch.remainder(t, self.delay).reshape(1).to(torch.int64)
        old = torch.index_select(state, 0, slot)[0]
        u = client_uniform(key, g.shape[0])
        hit = u < self.rate
        replay = hit & (t >= self.delay)
        dropped = hit & (t < self.delay)
        g_out = torch.where(replay[:, None], old.to(g.dtype), g)
        keep = 1.0 - dropped.to(torch.float32)
        # Record what the client *sent* this round (the fresh gradient),
        # after reading the slot it overwrites (the t - delay entry).
        state = state.index_copy(0, slot, g.to(torch.float32)[None])
        return state, g_out, keep

    def pad_clients(self, n_total: int):
        rate = self.rate
        if _per_client(rate):
            rate = _pad_leaf(rate, _check_pad(rate.shape[0], n_total), 0.0)
        return StaleUpdates(rate, delay=self.delay)


@dataclasses.dataclass(frozen=True, eq=False)
class OfflineWindows(_Fault):
    """Deterministic forced-outage intervals: client ``i`` is offline
    (update dropped) on steps ``t`` with ``0 <= (t - start_i) < length_i``,
    repeating every ``period_i`` steps when ``period_i > 0``. All three
    are int32 — scalar (one window profile for everyone) or (N,)."""

    start: torch.Tensor
    length: torch.Tensor
    period: torch.Tensor = 0

    def __post_init__(self):
        for f in ("start", "length", "period"):
            v = _host(getattr(self, f))
            if (v < 0).any():
                raise ValueError(f"{f} must be >= 0, got {v}")
            object.__setattr__(self, f, torch.as_tensor(
                getattr(self, f), dtype=torch.int32))

    def init(self, key, n_clients: int, n_params: int):
        return ()

    def apply(self, state, t, key, g):
        rel = torch.as_tensor(t, device=g.device) - self.start
        # Floor modulo, as jnp's ``%``: torch.remainder takes the
        # divisor's sign.
        pos = torch.where(self.period > 0,
                          torch.remainder(rel, torch.clamp(self.period, min=1)),
                          rel)
        off = (rel >= 0) & (pos < self.length)
        keep = (1.0 - off.to(torch.float32)).expand(g.shape[0]).contiguous()
        return state, g, keep

    def pad_clients(self, n_total: int):
        vals = {}
        for f in ("start", "length", "period"):
            v = getattr(self, f)
            if _per_client(v):
                v = _pad_leaf(v, _check_pad(v.shape[0], n_total), 0)
            vals[f] = v
        # length 0 on padded rows -> never offline (and masked anyway).
        return OfflineWindows(**vals)


@dataclasses.dataclass(frozen=True, eq=False)
class CompositeFault(_Fault):
    """Apply several fault families in sequence (gradient transforms
    chain, delivery masks compose multiplicatively). Each part draws
    from an independently folded subkey, so a composite containing two
    Bernoulli families does not correlate their coin flips."""

    parts: tuple

    def __post_init__(self):
        object.__setattr__(self, "parts", tuple(self.parts))
        if not self.parts:
            raise ValueError("CompositeFault needs at least one part")

    def to(self, device):
        return CompositeFault(tuple(p.to(device) for p in self.parts))

    def init(self, key, n_clients: int, n_params: int):
        return tuple(p.init(trandom.fold_in(key, i), n_clients, n_params)
                     for i, p in enumerate(self.parts))

    def apply(self, state, t, key, g):
        from repro_torch.core.aggregation import compose_masks

        new_state, keep = [], None
        for i, (p, s) in enumerate(zip(self.parts, state)):
            s, g, k = p.apply(s, t, trandom.fold_in(key, i), g)
            new_state.append(s)
            keep = compose_masks(keep, k)
        return tuple(new_state), g, keep

    def pad_clients(self, n_total: int):
        return CompositeFault(tuple(p.pad_clients(n_total)
                                    for p in self.parts))


# ------------------------------------------------ fault-family registry

_FAULT_FAMILIES: dict = {}


def register_fault_family(name: str):
    """Decorator: register a named fault-family factory with signature
    ``(n_clients, **kw) -> fault``. :func:`make_fault` dispatches by
    name; the experiment layer's ``faults`` sweep axis is built from
    this registry."""

    def deco(fn):
        _FAULT_FAMILIES[name] = fn
        return fn

    return deco


def fault_family_names() -> list[str]:
    return sorted(_FAULT_FAMILIES)


def make_fault(kind: str, n_clients: int, **kw):
    """Fault-component factory by registered family name."""
    try:
        factory = _FAULT_FAMILIES[kind]
    except KeyError:
        raise ValueError(
            f"unknown fault kind {kind!r}; have {fault_family_names()}"
        ) from None
    return factory(n_clients, **kw)


@register_fault_family("drop")
def _drop(n_clients, *, rate=0.0):
    return DropUpdates(rate)


@register_fault_family("corrupt")
def _corrupt(n_clients, *, rate=0.0, scale=0.0):
    return CorruptGradients(rate, scale)


@register_fault_family("stale")
def _stale(n_clients, *, rate=0.0, delay=1):
    return StaleUpdates(rate, delay=delay)


@register_fault_family("offline")
def _offline(n_clients, *, start=0, length=0, period=0):
    return OfflineWindows(start, length, period)


@register_fault_family("drop_corrupt")
def _drop_corrupt(n_clients, *, drop_rate=0.0, corrupt_rate=0.0, scale=0.0):
    """Composite convenience family: independent Bernoulli drop + row
    corruption — the channel model of over-the-air aggregation."""
    return CompositeFault((DropUpdates(drop_rate),
                           CorruptGradients(corrupt_rate, scale)))


def pad_faults(fault, n_total: int):
    """Pad a fault component's per-client fields to ``n_total`` rows
    (protocol dispatch to ``pad_clients``; identity at capacity and for
    scalar-field families). Padded rows are neutral — they never fault —
    and are masked out of aggregation regardless (DESIGN.md §7)."""
    if fault is None:
        return None
    try:
        method = fault.pad_clients
    except AttributeError:
        raise TypeError(
            f"{type(fault)!r} does not implement pad_clients(); ragged "
            "client populations need every fault family to define its "
            "padding rule") from None
    return method(n_total)
