"""Scenario specs: one declarative cell of an experiment grid.

Port of ``repro.experiments.scenario``. A :class:`Scenario` names a
(scheduler × energy-process) pair plus the shape of the client
population and an optional fault family; :meth:`Scenario.build`
materializes the two component objects of
:mod:`repro_torch.core.scheduling` and :mod:`repro_torch.core.energy`,
:meth:`Scenario.build_faults` the :mod:`repro_torch.core.faults`
component. Scenarios are host-side specs (plain
dataclasses); the engine places what they build on the simulator's
device.

Scenarios are what :meth:`repro_torch.experiments.Study.resolve`
produces from its sweep axes; writing them by hand remains supported
for one-off irregular cells. The module also keeps the JAX package's
two legacy shims, :func:`make_energy_process` and the named-grid
registry (:func:`get_grid` / :func:`register_grid`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

from repro_torch.core.energy import PAPER_TAUS, default_taus, make_arrivals
from repro_torch.core.faults import make_fault
from repro_torch.core.scheduling import make_scheduler

__all__ = ["ARRIVAL_KINDS", "FIG1_SCHEDULERS", "PAPER_TAUS", "Scenario",
           "default_taus", "get_grid", "grid_names", "make_energy_process",
           "register_grid", "scenario_grid"]

ARRIVAL_KINDS = ("periodic", "binary", "uniform")


def make_energy_process(kind: str, n_clients: int, horizon: int, taus=None,
                        **kw):
    """Deprecated alias of :func:`repro_torch.core.energy.make_arrivals`."""
    return make_arrivals(kind, n_clients, horizon, taus=taus, **kw)


@dataclasses.dataclass
class Scenario:
    """One experiment-grid cell: scheduler × arrival process × population.

    ``scheduler`` / ``arrivals`` are registry names; ``taus`` is the
    per-client period vector shared across arrival kinds (None → the
    paper's cycling (1, 5, 10, 20) profile); ``scheduler_kwargs`` /
    ``arrival_kwargs`` feed extra hyperparameters (e.g. battery
    capacity, day/night cycle length) to the component factories.

    ``n_clients`` need not match other scenarios in a grid: the engine
    pads ragged populations to the simulator capacity under an active
    mask (DESIGN.md §7).

    ``faults`` optionally names a fault-injection family
    (:mod:`repro_torch.core.faults` registry; ``fault_kwargs`` feeds its
    factory). ``None`` — the default — runs the fault-free program.
    """

    name: str
    scheduler: str
    arrivals: str
    n_clients: int
    horizon: int
    taus: Sequence[int] | None = None
    scheduler_kwargs: dict = dataclasses.field(default_factory=dict)
    arrival_kwargs: dict = dataclasses.field(default_factory=dict)
    faults: str | None = None
    fault_kwargs: dict = dataclasses.field(default_factory=dict)

    def build(self):
        """Materialize the (scheduler, energy) pair (tables on the CPU;
        the simulator places them)."""
        scheduler = make_scheduler(self.scheduler, self.n_clients,
                                   **self.scheduler_kwargs)
        energy = make_arrivals(self.arrivals, self.n_clients, self.horizon,
                               taus=self.taus, **self.arrival_kwargs)
        return scheduler, energy

    def build_faults(self):
        """Materialize the fault component (None when fault-free)."""
        if self.faults is None:
            return None
        return make_fault(self.faults, self.n_clients, **self.fault_kwargs)


def scenario_grid(
    schedulers: Iterable[str],
    arrivals: Iterable[str],
    n_clients: int,
    horizon: int,
    taus=None,
    scheduler_kwargs: dict | None = None,
) -> list[Scenario]:
    """Cross product of scheduler × arrival-kind names as Scenario cells."""
    return [
        Scenario(name=f"{s}_{a}", scheduler=s, arrivals=a,
                 n_clients=n_clients, horizon=horizon, taus=taus,
                 scheduler_kwargs=dict(scheduler_kwargs or {}))
        for s in schedulers
        for a in arrivals
    ]


#: Paper Figure-1 methods, in presentation order.
FIG1_SCHEDULERS = ("alg1", "benchmark1", "benchmark2", "oracle")

_GRID_REGISTRY: dict[str, Callable[..., list[Scenario]]] = {}


def register_grid(name: str):
    """Decorator: register a named scenario-grid factory (legacy; new
    named experiments are Studies, :func:`repro_torch.experiments.
    register_study`)."""

    def deco(fn):
        _GRID_REGISTRY[name] = fn
        return fn

    return deco


def get_grid(name: str, **kw) -> list[Scenario]:
    """Resolve a named grid to a scenario list (legacy entry point).

    Dispatches to the legacy factory registry first, then to the Study
    registry (translating the old ``horizon=`` / ``taus=`` keywords).
    """
    if name in _GRID_REGISTRY:
        return _GRID_REGISTRY[name](**kw)
    from repro_torch.experiments.study import get_study, study_names

    if name not in study_names():
        raise ValueError(
            f"unknown scenario grid {name!r}; have {grid_names()}")
    if "horizon" in kw:
        kw["num_steps"] = kw.pop("horizon") - 1
    if "taus" in kw:
        taus = kw.pop("taus")
        if taus is not None:
            kw["taus_profile"] = taus
    return get_study(name, **kw).resolve()


def grid_names() -> list[str]:
    from repro_torch.experiments.study import study_names

    return sorted(set(_GRID_REGISTRY) | set(study_names()))
