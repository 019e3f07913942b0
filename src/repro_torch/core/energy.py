"""Energy-arrival processes (paper §II-B), as plain torch objects.

Port of ``repro.core.energy``. Each process models ``E_i^t``, whether
client ``i`` harvests a unit of energy at step ``t``, for all clients at
once:

    init(key)               -> state
    arrivals(state, t, key) -> (state, Arrivals)
    expected_participation() -> (N,) long-run participation probability

``Arrivals.energy`` is ``(N,)`` float32 in {0, 1}; ``Arrivals.gap`` is
``T_i^t`` for deterministic arrivals and the nominal scale ``γ_i`` for
the stochastic families. Per-client randomness comes from
:func:`client_keys` (``fold_in`` of the client index), so client ``i``
draws the same bits at any population width (DESIGN.md §7) and the same
bits as the JAX package.

A process keeps its per-client tables as CPU tensors when built;
:meth:`to` returns a copy on another device, which is how
:class:`repro_torch.core.trainer.ClientSimulator` places it. The JAX
package's ``client_sharding`` context is not ported yet (ROADMAP Queue 1
item 10).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as trandom


class Arrivals(NamedTuple):
    """Per-step arrival information for all clients."""

    energy: torch.Tensor  # (N,) float32 in {0, 1}
    gap: torch.Tensor     # (N,) float32 — T_i^t (det.) or γ_i (stochastic)


#: Paper §V experimental profile: 4 client groups with periods (1, 5, 10, 20).
PAPER_TAUS = (1, 5, 10, 20)


def default_taus(n_clients: int) -> np.ndarray:
    """Paper §V grouping generalized to N clients: client i ∈ group i mod 4."""
    return np.array([PAPER_TAUS[i % len(PAPER_TAUS)] for i in range(n_clients)])


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _leaf(x, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype)


class _Process:
    """``to(device)`` over every tensor field of a dataclass."""

    def to(self, device):
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def client_keys(key, n_clients: int) -> torch.Tensor:
    """(N, 2) per-client keys, ``fold_in`` of the client index.

    They depend only on ``(key, i)``, not on ``n_clients``, which is
    what makes ragged-population padding bit-exact (DESIGN.md §7).
    """
    idx = torch.arange(n_clients, dtype=torch.int64, device=key.device)
    return trandom.fold_in(key, idx)


def client_uniform(key, n_clients: int) -> torch.Tensor:
    """(N,) iid U[0,1) draws, one per client, shape-independent per row."""
    return trandom.uniform(client_keys(key, n_clients), ())


def client_randint(key, n_clients: int, maxval) -> torch.Tensor:
    """(N,) iid U{0,…,maxval_i−1} draws as ``floor(u · maxval)`` (int32).

    ``maxval`` is a scalar or an (N,) per-client bound (≥ 1).
    """
    maxval = torch.as_tensor(maxval, device=key.device)
    u = client_uniform(key, n_clients)
    draw = torch.floor(u * maxval.to(torch.float32)).to(torch.int32)
    return torch.minimum(draw, maxval.to(torch.int32) - 1)


def _pad_leaf(x, pad: int, value, axis: int = 0):
    """Append ``pad`` rows of ``value`` along ``axis``."""
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=axis)


def _check_pad(n_clients: int, n_total: int) -> int:
    pad = int(n_total) - int(n_clients)
    if pad < 0:
        raise ValueError(
            f"cannot pad {n_clients} clients down to {n_total}")
    return pad


def _gap_table(schedule: np.ndarray) -> np.ndarray:
    """Vectorized T[i, t] = Ī_i^t − I_i^t over an (N, H) 0/1 schedule.

    For each arrival at t0 with next arrival t1 (horizon if none),
    T[i, t] = t1 − t0 on t ∈ [t0, t1); 0 before the first arrival.
    """
    n, h = schedule.shape
    arr = schedule > 0
    idx = np.arange(h)[None, :]
    # I_i^t: most recent arrival at or before t (−1: none yet).
    last = np.maximum.accumulate(np.where(arr, idx, -1), axis=1)
    # First arrival at or after t (h: none); padded at index h so the
    # lookup below stays in-bounds for the final interval.
    next_ge = np.minimum.accumulate(np.where(arr, idx, h)[:, ::-1], axis=1)[:, ::-1]
    next_ge = np.concatenate([next_ge, np.full((n, 1), h)], axis=1)
    ibar = np.take_along_axis(next_ge, np.clip(last + 1, 0, h), axis=1)
    return np.where(last >= 0, ibar - last, 0).astype(np.float32)


@dataclasses.dataclass(eq=False)
class DeterministicArrivals(_Process):
    """Deterministic energy arrivals known in advance (paper §II-B-1).

    ``schedule`` is an (N, horizon) 0/1 array of arrival indicators. The
    gap table ``T[i, t] = Ī_i^t − I_i^t`` that Algorithm 1 uses is
    derived from it on the host when ``gaps`` is None; the final
    interval is truncated at the horizon, and steps before a client's
    first arrival have gap 0.
    """

    schedule: torch.Tensor        # (N, horizon) float32 in {0, 1}
    gaps: torch.Tensor = None     # (N, horizon) float32

    def __post_init__(self):
        if self.gaps is None:
            schedule = _host(self.schedule)
            if schedule.ndim != 2:
                raise ValueError(
                    f"schedule must be (N, horizon), got {schedule.shape}")
            sched01 = (schedule != 0).astype(np.float32)
            self.gaps = torch.from_numpy(_gap_table(sched01))
            self.schedule = torch.from_numpy(sched01)

    @property
    def n_clients(self) -> int:
        return self.schedule.shape[-2]

    @property
    def horizon(self) -> int:
        return self.schedule.shape[-1]

    @classmethod
    def periodic(cls, taus, horizon: int, offsets=None) -> "DeterministicArrivals":
        """Paper's experimental profile (eq. 37): arrivals at ``t ≡ off (mod τ_i)``."""
        taus = np.asarray(taus, dtype=np.int64)
        if offsets is None:
            offsets = np.zeros_like(taus)
        offsets = np.asarray(offsets, dtype=np.int64)
        t = np.arange(horizon)[None, :]
        sched = ((t - offsets[:, None]) % taus[:, None] == 0) & (t >= offsets[:, None])
        return cls(sched.astype(np.float32))

    def init(self, key):
        del key
        return ()

    def arrivals(self, state, t, key):
        del key
        t = torch.as_tensor(t, device=self.schedule.device)
        # Past the precomputed horizon there are no further arrivals.
        tc = torch.clamp(t, 0, self.horizon - 1).to(torch.int64)
        valid = (t < self.horizon).to(torch.float32)
        energy = self.schedule[:, tc] * valid
        gap = self.gaps[:, tc] * valid
        return state, Arrivals(energy=energy, gap=gap)

    def expected_participation(self) -> torch.Tensor:
        return torch.mean(self.schedule, dim=-1)

    def pad_clients(self, n_total: int) -> "DeterministicArrivals":
        """Same process over ``n_total`` client rows; padded rows never
        harvest (all-zero schedule ⇒ gap 0 ⇒ cannot participate)."""
        pad = _check_pad(self.n_clients, n_total)
        return DeterministicArrivals(
            schedule=_pad_leaf(self.schedule, pad, 0.0),
            gaps=_pad_leaf(self.gaps, pad, 0.0))


def _check_rates(name: str, betas: np.ndarray, what: str):
    if betas.ndim < 1:
        raise ValueError(f"{name} must be (N,), got {betas.shape}")
    if betas.size and not (np.all(np.isfinite(betas)) and np.all(betas > 0.0)
                           and np.all(betas <= 1.0)):
        raise ValueError(
            f"{what} requires finite {name} in (0, 1]; got "
            f"min={betas.min():g}, max={betas.max():g}")


@dataclasses.dataclass(eq=False)
class BinaryArrivals(_Process):
    """E_i^t ~ Bern(β_i), iid across steps and clients (paper eq. 9).

    β_i must lie in (0, 1]: the unbiased scale γ_i = 1/β_i is infinite
    for β_i = 0, so such rates are refused at construction.
    """

    betas: torch.Tensor  # (N,) float32

    def __post_init__(self):
        _check_rates("betas", _host(self.betas), "BinaryArrivals")
        self.betas = _leaf(self.betas, torch.float32)

    @property
    def n_clients(self) -> int:
        return self.betas.shape[-1]

    def init(self, key):
        del key
        return ()

    def arrivals(self, state, t, key):
        del t
        u = client_uniform(key, self.n_clients)
        energy = (u < self.betas).to(torch.float32)
        gap = 1.0 / self.betas  # γ_i = 1/β_i (Alg. 2 / Corollary 1)
        return state, Arrivals(energy=energy, gap=gap)

    def expected_participation(self) -> torch.Tensor:
        return self.betas

    def pad_clients(self, n_total: int) -> "BinaryArrivals":
        """Padded rows get β = 1 (a valid rate, no inf scales); the
        scheduler and aggregation layers mask their draws out."""
        pad = _check_pad(self.n_clients, n_total)
        return BinaryArrivals(betas=_pad_leaf(self.betas, pad, 1.0))


class UniformArrivalsState(NamedTuple):
    offset: torch.Tensor  # (N,) int32 — arrival position inside current window


@dataclasses.dataclass(eq=False)
class UniformArrivals(_Process):
    """One arrival per window of length T_i, uniformly placed (paper §II-B-2).

    At every t with ``t mod T_i == 0`` a fresh offset ``U{0,…,T_i−1}`` is
    drawn; the client receives energy when ``t mod T_i == offset``.
    """

    periods: torch.Tensor  # (N,) int32

    def __post_init__(self):
        periods = _host(self.periods)
        if periods.ndim < 1:
            raise ValueError(f"periods must be (N,), got {periods.shape}")
        if periods.size and not (np.all(np.isfinite(periods))
                                 and np.all(periods >= 1)):
            raise ValueError(
                "UniformArrivals requires finite periods >= 1; "
                f"got min={periods.min():g}")
        self.periods = _leaf(self.periods, torch.int32)

    @property
    def n_clients(self) -> int:
        return self.periods.shape[-1]

    def init(self, key):
        offset = client_randint(key, self.n_clients, self.periods)
        return UniformArrivalsState(offset=offset.to(torch.int32))

    def arrivals(self, state, t, key):
        pos = torch.as_tensor(t, device=self.periods.device) % self.periods
        fresh = client_randint(key, self.n_clients, self.periods)
        offset = torch.where(pos == 0, fresh.to(torch.int32), state.offset)
        energy = (pos == offset).to(torch.float32)
        gap = self.periods.to(torch.float32)  # γ_i = T_i (Corollary 1)
        return UniformArrivalsState(offset=offset), Arrivals(energy=energy, gap=gap)

    def expected_participation(self) -> torch.Tensor:
        return 1.0 / self.periods.to(torch.float32)

    def pad_clients(self, n_total: int) -> "UniformArrivals":
        """Padded rows get period 1 (valid; arrives every step), masked
        out downstream."""
        pad = _check_pad(self.n_clients, n_total)
        return UniformArrivals(periods=_pad_leaf(self.periods, pad, 1))


@dataclasses.dataclass(eq=False)
class DayNightArrivals(_Process):
    """Non-stationary Bernoulli arrivals with a periodic day/night β_t.

    β_i(t) is ``betas_day[i]`` for the first ``day_steps`` steps of every
    ``period``-step cycle and ``betas_night[i]`` for the rest; the scale
    is the instantaneous inverse rate γ_i(t) = 1/β_i(t).
    """

    betas_day: torch.Tensor    # (N,) float32 in (0, 1]
    betas_night: torch.Tensor  # (N,) float32 in (0, 1]
    period: torch.Tensor       # () int32, full day/night cycle length
    day_steps: torch.Tensor = None  # () int32, day length; None → period // 2

    def __post_init__(self):
        period = _host(self.period)
        if self.day_steps is None:
            self.day_steps = int(period) // 2
        day_steps = _host(self.day_steps)
        if not (np.all(period >= 1) and np.all(day_steps >= 0)
                and np.all(day_steps <= period)):
            raise ValueError(
                f"need 0 <= day_steps <= period and period >= 1; got "
                f"period={period}, day_steps={day_steps}")
        self.period = _leaf(self.period, torch.int32)
        self.day_steps = _leaf(self.day_steps, torch.int32)
        for name in ("betas_day", "betas_night"):
            _check_rates(name, _host(getattr(self, name)), "DayNightArrivals")
            setattr(self, name, _leaf(getattr(self, name), torch.float32))

    @property
    def n_clients(self) -> int:
        return self.betas_day.shape[-1]

    @classmethod
    def from_taus(cls, taus, period: int = 50, day_frac: float = 0.5,
                  contrast: float = 3.0) -> "DayNightArrivals":
        """Day/night profile with the paper's mean rate held at 1/τ_i.

        ``contrast`` is the day:night rate ratio; where that puts β_day
        above 1 it is clamped and β_night re-solved so the mean rate
        stays exactly 1/τ.
        """
        taus = np.asarray(taus, np.float64)
        if period < 2:
            raise ValueError(f"period must be >= 2, got {period}")
        if not 0.0 < day_frac < 1.0:
            raise ValueError(f"day_frac must be in (0, 1), got {day_frac}")
        if contrast < 1.0:
            raise ValueError(f"contrast must be >= 1, got {contrast}")
        day_steps = int(np.clip(round(day_frac * period), 1, period - 1))
        f = day_steps / period
        night = 1.0 / (taus * (f * contrast + (1.0 - f)))
        day = contrast * night
        clamped = day > 1.0
        day = np.where(clamped, 1.0, day)
        night = np.where(clamped, (1.0 / taus - f) / (1.0 - f), night)
        if np.any(night <= 0.0):
            raise ValueError(
                f"mean rate 1/τ below day fraction {f:g} for τ="
                f"{taus[np.asarray(night) <= 0]}; lower day_frac or contrast")
        return cls(betas_day=day.astype(np.float32),
                   betas_night=night.astype(np.float32),
                   period=period, day_steps=day_steps)

    def _beta_t(self, t) -> torch.Tensor:
        pos = torch.as_tensor(t, device=self.period.device) % self.period
        return torch.where(pos < self.day_steps, self.betas_day,
                           self.betas_night)

    def init(self, key):
        del key
        return ()

    def arrivals(self, state, t, key):
        beta = self._beta_t(t)
        u = client_uniform(key, self.n_clients)
        energy = (u < beta).to(torch.float32)
        gap = 1.0 / beta  # γ_i(t) = 1/β_i(t), the instantaneous scale
        return state, Arrivals(energy=energy, gap=gap)

    def expected_participation(self) -> torch.Tensor:
        p = self.period.to(torch.float32)[..., None]
        d = self.day_steps.to(torch.float32)[..., None]
        return (d * self.betas_day + (p - d) * self.betas_night) / p

    def pad_clients(self, n_total: int) -> "DayNightArrivals":
        pad = _check_pad(self.n_clients, n_total)
        return DayNightArrivals(
            betas_day=_pad_leaf(self.betas_day, pad, 1.0),
            betas_night=_pad_leaf(self.betas_night, pad, 1.0),
            period=self.period, day_steps=self.day_steps)


_ARRIVAL_FAMILIES: dict = {}


def register_arrival_family(name: str):
    """Decorator: register a named arrival-family factory
    ``(n_clients, horizon, taus, **kw) -> process``."""

    def deco(fn):
        _ARRIVAL_FAMILIES[name] = fn
        return fn

    return deco


def arrival_family_names() -> list[str]:
    return sorted(_ARRIVAL_FAMILIES)


def make_arrivals(kind: str, n_clients: int, horizon: int, taus=None, **kw):
    """Arrival-process factory by name. Every family reads the same
    per-client period vector τ (default: the paper's four groups), so a
    sweep over families holds the mean energy rate 1/τ_i fixed."""
    try:
        factory = _ARRIVAL_FAMILIES[kind]
    except KeyError:
        raise ValueError(
            f"unknown arrival kind {kind!r}; have {arrival_family_names()}"
        ) from None
    taus = default_taus(n_clients) if taus is None else np.asarray(taus)
    return factory(n_clients, horizon, taus, **kw)


@register_arrival_family("periodic")
def _periodic(n_clients, horizon, taus, **kw):
    return DeterministicArrivals.periodic(taus, horizon, **kw)


@register_arrival_family("binary")
def _binary(n_clients, horizon, taus, **kw):
    del horizon
    if kw:
        raise TypeError(f"binary arrivals take no extra kwargs; got {sorted(kw)}")
    return BinaryArrivals(1.0 / taus)


@register_arrival_family("uniform")
def _uniform(n_clients, horizon, taus, **kw):
    del horizon
    if kw:
        raise TypeError(f"uniform arrivals take no extra kwargs; got {sorted(kw)}")
    return UniformArrivals(taus)


@register_arrival_family("day_night")
def _day_night(n_clients, horizon, taus, **kw):
    del horizon
    return DayNightArrivals.from_taus(taus, **kw)


def pad_arrivals(process, n_total: int):
    """Pad a process's per-client leaves to ``n_total`` rows. Padded rows
    carry valid neutral hyperparameters (β=1, period=1, empty schedule);
    the scheduler and aggregation layers mask them out (DESIGN.md §7)."""
    try:
        method = process.pad_clients
    except AttributeError:
        raise TypeError(
            f"{type(process)!r} does not implement pad_clients(); ragged "
            "client populations need every arrival family to define its "
            "padding rule") from None
    return method(n_total)


def expected_participation(process) -> torch.Tensor:
    """Long-run participation probability per client under best-effort."""
    try:
        method = process.expected_participation
    except AttributeError:
        raise TypeError(
            f"{type(process)!r} does not implement the energy-process "
            "protocol (missing expected_participation())") from None
    return method()
