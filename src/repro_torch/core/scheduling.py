"""User-scheduling policies (paper §III + §V benchmarks) in torch.

Port of ``repro.core.scheduling``. Every scheduler is a state machine:

    init(key)               -> state
    step(state, t, key, arrivals, active=None) -> (state, Decision)

``Decision.mask`` is ``(N,)`` float32 in {0, 1} (α_i^t, does client i
take part at t) and ``Decision.scale`` the gradient scale the client
applies (T_i^t, γ_i, or 1 for the benchmarks). ``active`` is the
optional (N,) 0/1 mask of clients that exist (ragged populations,
DESIGN.md §7): padded rows get no participation mass from any
scheduler, and population-wide decisions are taken over active rows
only. The server weight of client i is ``p_i · mask_i · scale_i``
(:func:`repro_torch.core.aggregation.client_weights`).

Schedulers: ``EHAppointmentScheduler`` (Algorithm 1),
``BestEffortScheduler`` (Algorithm 2, or Benchmark 1 with
``scaled=False``), ``WaitForAllScheduler`` (Benchmark 2),
``AlwaysOnScheduler`` (the full-participation oracle) and
``BatteryAdaptiveScheduler`` (energy accumulation with adaptive
inverse-rate scaling). The JAX package's ``shard_scheduler`` waits for
client sharding (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.energy import Arrivals, _host, client_randint


class Decision(NamedTuple):
    mask: torch.Tensor   # (N,) float32 in {0,1}
    scale: torch.Tensor  # (N,) float32


def mask_arrivals(arrivals: Arrivals, active) -> Arrivals:
    """Zero the energy of inactive rows (identity when ``active`` is None).
    ×1.0 is exact on active rows, so a padded run stays bit-identical to
    the natural-N run for every existing client."""
    if active is None:
        return arrivals
    return Arrivals(energy=arrivals.energy * active, gap=arrivals.gap)


def _mask_decision(mask: torch.Tensor, active) -> torch.Tensor:
    return mask if active is None else mask * active


class AppointmentState(NamedTuple):
    appt_time: torch.Tensor   # (N,) int32 — booked participation step (-1: none)
    appt_scale: torch.Tensor  # (N,) float32 — T_i^t captured at booking time


@dataclasses.dataclass(eq=False)
class EHAppointmentScheduler:
    """Algorithm 1 — unbiased scheduling for deterministic arrivals.

    On an arrival at t, draw J ~ U{0,…,T_i^t−1}, book an appointment at
    t+J and take part then with scale T_i^t."""

    n_clients: int

    def init(self, key):
        return AppointmentState(
            appt_time=torch.full((self.n_clients,), -1, dtype=torch.int32,
                                 device=key.device),
            appt_scale=torch.zeros((self.n_clients,), dtype=torch.float32,
                                   device=key.device),
        )

    def step(self, state, t, key, arrivals: Arrivals, active=None):
        arrivals = mask_arrivals(arrivals, active)
        t = torch.as_tensor(t, dtype=torch.int32, device=key.device)
        gap = torch.clamp(arrivals.gap, min=1.0)
        j = client_randint(key, self.n_clients, gap)
        arrived = arrivals.energy > 0
        appt_time = torch.where(arrived, t + j, state.appt_time)
        appt_scale = torch.where(arrived, gap, state.appt_scale)
        mask = _mask_decision((appt_time == t).to(torch.float32), active)
        new_state = AppointmentState(appt_time=appt_time, appt_scale=appt_scale)
        return new_state, Decision(mask=mask, scale=appt_scale)


@dataclasses.dataclass(eq=False)
class BestEffortScheduler:
    """Algorithm 2 (scaled=True) / paper Benchmark 1 (scaled=False)."""

    n_clients: int
    scaled: bool = True

    def init(self, key):
        del key
        return ()

    def step(self, state, t, key, arrivals: Arrivals, active=None):
        del t, key
        mask = mask_arrivals(arrivals, active).energy
        if self.scaled:
            scale = torch.clamp(arrivals.gap, min=1.0)
        else:
            scale = torch.ones_like(mask)
        return state, Decision(mask=mask, scale=scale)


class WaitForAllState(NamedTuple):
    battery: torch.Tensor  # (N,) float32 in {0,1} — unit battery


@dataclasses.dataclass(eq=False)
class WaitForAllScheduler:
    """Benchmark 2 — synchronous step only when every battery is full."""

    n_clients: int

    def init(self, key):
        return WaitForAllState(battery=torch.zeros(
            (self.n_clients,), dtype=torch.float32, device=key.device))

    def step(self, state, t, key, arrivals: Arrivals, active=None):
        del t, key
        arrivals = mask_arrivals(arrivals, active)
        battery = torch.clamp(state.battery + arrivals.energy, max=1.0)
        # The all-full barrier is over active clients only: a padded row
        # (which never harvests) must not block the whole population.
        ready = battery if active is None else torch.where(
            active > 0, battery, torch.ones_like(battery))
        fire = torch.min(ready) >= 1.0
        mask = torch.where(fire, torch.ones_like(battery),
                           torch.zeros_like(battery))
        mask = _mask_decision(mask, active)
        battery = battery - mask
        return WaitForAllState(battery=battery), Decision(
            mask=mask, scale=torch.ones_like(battery))


@dataclasses.dataclass(eq=False)
class AlwaysOnScheduler:
    """Full-participation oracle (conventional distributed SGD)."""

    n_clients: int

    def init(self, key):
        del key
        return ()

    def step(self, state, t, key, arrivals: Arrivals, active=None):
        del t, arrivals
        ones = torch.ones((self.n_clients,), dtype=torch.float32,
                          device=key.device)
        return state, Decision(mask=_mask_decision(ones, active), scale=ones)


class BatteryState(NamedTuple):
    battery: torch.Tensor  # (N,) float32 in [0, capacity]
    rate: torch.Tensor     # (N,) float32 — EMA participation-rate estimate
    steps: torch.Tensor    # () int32


@dataclasses.dataclass(eq=False)
class BatteryAdaptiveScheduler:
    """Energy accumulation (the paper's §VI future work).

    Devices bank energy in a battery of ``capacity`` units and take part
    whenever ≥ 1 unit is stored; each scales its gradient by the inverse
    of its own EMA participation-rate estimate (scale 1 during
    ``warmup``, the estimate clipped to [0.02, 1] afterwards)."""

    n_clients: int
    capacity: float = 2.0
    ema: float = 0.05
    warmup: int = 20

    def __post_init__(self):
        # Scalar hyperparameters rounded as the JAX package stores them
        # (float32 / int32 leaves), kept on the host as Python numbers.
        self.capacity = float(np.float32(_host(self.capacity)))
        self.ema = float(np.float32(_host(self.ema)))
        self.warmup = int(_host(self.warmup))

    def init(self, key):
        n, dev = self.n_clients, key.device
        return BatteryState(
            battery=torch.zeros((n,), dtype=torch.float32, device=dev),
            rate=torch.ones((n,), dtype=torch.float32, device=dev),
            steps=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def step(self, state, t, key, arrivals: Arrivals, active=None):
        del t, key
        arrivals = mask_arrivals(arrivals, active)
        battery = torch.clamp(state.battery + arrivals.energy,
                              max=self.capacity)
        mask = _mask_decision((battery >= 1.0).to(torch.float32), active)
        battery = battery - mask
        keep = float(np.float32(1.0) - np.float32(self.ema))
        rate = keep * state.rate + self.ema * mask
        scale = torch.where(state.steps >= self.warmup,
                            1.0 / torch.clamp(rate, 0.02, 1.0),
                            torch.ones_like(rate))
        new = BatteryState(battery=battery, rate=rate, steps=state.steps + 1)
        return new, Decision(mask=mask, scale=scale)


def pad_scheduler(scheduler, n_total: int):
    """Widen a scheduler to ``n_total`` client rows (ragged padding).
    A scheduler defining ``pad_clients(n)`` owns its padding rule; the
    built-ins hold only scalar hyperparameters, so widening ``n_clients``
    is all they need (``init`` sizes per-client state from it)."""
    method = getattr(scheduler, "pad_clients", None)
    if method is not None:
        return method(n_total)
    if int(n_total) < int(scheduler.n_clients):
        raise ValueError(
            f"cannot pad {scheduler.n_clients} clients down to {n_total}")
    return dataclasses.replace(scheduler, n_clients=int(n_total))


def _strict(ctor, name, n, kw, **fixed):
    """Registry entries whose identity admits no extra hyperparameters
    reject them: swallowing `scaled=False` (or a typo) would run another
    algorithm than the one asked for."""
    if kw:
        raise TypeError(f"scheduler {name!r} takes no extra kwargs; "
                        f"got {sorted(kw)}")
    return ctor(n, **fixed)


_REGISTRY = {
    "alg1": lambda n, **kw: _strict(EHAppointmentScheduler, "alg1", n, kw),
    "alg2": lambda n, **kw: _strict(BestEffortScheduler, "alg2", n, kw,
                                    scaled=True),
    "benchmark1": lambda n, **kw: _strict(BestEffortScheduler, "benchmark1",
                                          n, kw, scaled=False),
    "benchmark2": lambda n, **kw: _strict(WaitForAllScheduler, "benchmark2",
                                          n, kw),
    "oracle": lambda n, **kw: _strict(AlwaysOnScheduler, "oracle", n, kw),
    "battery_adaptive": lambda n, **kw: BatteryAdaptiveScheduler(n, **kw),
}


def register_scheduler(name: str, factory=None):
    """Register a named scheduler factory ``(n_clients, **kw) -> scheduler``,
    directly or as a decorator."""
    if factory is None:
        def deco(fn):
            _REGISTRY[name] = fn
            return fn

        return deco
    _REGISTRY[name] = factory
    return factory


def make_scheduler(name: str, n_clients: int, **kw):
    """Scheduler factory by registry name."""
    try:
        return _REGISTRY[name](int(n_clients), **kw)
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; have {sorted(_REGISTRY)}") from None


def scheduler_names():
    return sorted(_REGISTRY)
