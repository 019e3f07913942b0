"""Sweep axes: the named, composable dimensions of a Study.

Port of ``repro.experiments.axes``: the same axes, names, order and
cell-name formats, validated against the port's own registries.

An **axis** is a registered factory that knows how to apply one swept
value to a cell draft (the constructor arguments of a
:class:`~repro_torch.experiments.scenario.Scenario`) and how to format that
value into the cell's name. The cross-product of a Study's axes resolves
to Scenario cells, which the engine groups by component structure
(:func:`repro_torch.experiments.resolve_structure_groups`).

Built-in axes (canonical resolution order):

    scheduler     registry names from repro_torch.core.scheduling
    arrivals      family names from repro_torch.core.energy (str, or
                  (kind, kwargs) for hyperparameterized families such as
                  ("day_night", {"period": 50}))
    capacity      battery capacity -> scheduler_kwargs["capacity"]
    n_clients     client-population size — a data axis: ragged values
                  pad to the simulator capacity under an active mask
                  (DESIGN.md §7), sharing one structure group
    taus_profile  named / explicit per-client energy-period profile
    faults        registered, but a fault family is refused until
                  core/faults.py is ported (ROADMAP Queue 1 step 2);
                  None, the fault-free program, passes
    seeds         seed count or explicit list (run in turn by the
                  engine, never part of cell naming)

The registry is open: :func:`register_axis` adds project-specific axes
(e.g. an EMA-rate sweep) that compose with the built-ins. Scheduler and
arrival *values* are validated against their own registries at
resolution time, so one layer of named factories subsumes
``make_scheduler`` / ``make_arrivals`` / the legacy grid registry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core.energy import default_taus
from repro_torch.experiments.scenario import refuse_faults

#: Canonical order in which axes cross-multiply and appear in cell names.
AXIS_ORDER = ("scheduler", "arrivals", "capacity", "n_clients",
              "taus_profile", "faults", "seeds")


def _default_is_value(v) -> bool:
    return isinstance(v, str) or not isinstance(v, (list, tuple))


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """One registered sweep axis.

    ``apply(draft, value)`` folds a swept value into the cell draft (a
    dict of Scenario constructor arguments). ``fmt(value, fixed)``
    renders the value for the cell name — ``None`` omits it (the
    convention: identity axes *always* appear, shape/profile axes only
    when actually swept, seeds never). ``is_value(v)`` distinguishes one
    axis value from a sweep list — needed because some single values are
    themselves sequences (an explicit taus profile, an
    ``(arrival_kind, kwargs)`` pair).

    ``validate(value)`` — optional — checks one axis value against the
    registry that owns it (scheduler / arrival-family / fault-family /
    taus-profile names), raising ``ValueError`` that names the registry
    and its valid keys, so a bad name fails before ``Scenario.build``
    (the JAX package's manifest layer calls it on every decoded value;
    manifests are not ported yet, ROADMAP Queue 1 step 4).
    """

    name: str
    apply: Callable[[dict, Any], None]
    fmt: Callable[[Any, bool], str | None]
    is_value: Callable[[Any], bool] = _default_is_value
    doc: str = ""
    validate: Callable[[Any], None] | None = None


_AXES: dict[str, AxisSpec] = {}


def register_axis(name: str, *, apply, fmt=None, is_value=None,
                  doc: str = "", validate=None) -> AxisSpec:
    """Register a sweep axis. ``fmt`` defaults to omit-from-name."""
    spec = AxisSpec(name=name, apply=apply,
                    fmt=fmt or (lambda v, fixed: None),
                    is_value=is_value or _default_is_value, doc=doc,
                    validate=validate)
    _AXES[name] = spec
    return spec


def axis_names() -> list[str]:
    """All registered axes, canonical order first, extensions after."""
    ordered = [n for n in AXIS_ORDER if n in _AXES]
    return ordered + sorted(set(_AXES) - set(ordered))


def get_axis(name: str) -> AxisSpec:
    try:
        return _AXES[name]
    except KeyError:
        raise ValueError(
            f"unknown sweep axis {name!r}; have {axis_names()}") from None


# ------------------------------------------------------------ taus profiles

_TAUS_PROFILES: dict[str, Callable[[int], np.ndarray]] = {
    "paper": default_taus,
}


def register_taus_profile(name: str, fn: Callable[[int], Any]) -> None:
    """Register a named per-client energy-period profile ``fn(n) -> (N,)``."""
    _TAUS_PROFILES[name] = fn


def resolve_taus_profile(profile, n_clients: int) -> np.ndarray:
    """A profile is a registered name, an explicit per-client sequence
    (cycled over N like the paper's group assignment), or a callable."""
    if callable(profile):
        return np.asarray(profile(n_clients))
    if isinstance(profile, str):
        try:
            fn = _TAUS_PROFILES[profile]
        except KeyError:
            raise ValueError(
                f"unknown taus profile {profile!r}; have "
                f"{sorted(_TAUS_PROFILES)}") from None
        return np.asarray(fn(n_clients))
    taus = np.asarray(profile)
    if taus.ndim != 1 or taus.size == 0:
        raise ValueError(f"taus profile must be a 1-D sequence, got "
                         f"shape {taus.shape}")
    return np.array([taus[i % taus.size] for i in range(n_clients)])


def _fmt_taus(profile, fixed: bool) -> str | None:
    if fixed:  # not varying across cells -> not part of cell identity
        return None
    if isinstance(profile, str):
        return profile
    if callable(profile):
        return getattr(profile, "__name__", "taus")
    return "taus" + "x".join(f"{t:g}" for t in np.asarray(profile).reshape(-1))


# ------------------------------------------------------------ built-in axes

def _validate_scheduler(value) -> None:
    from repro_torch.core.scheduling import scheduler_names

    if value not in scheduler_names():
        raise ValueError(
            f"unknown scheduler {value!r}; scheduler registry has "
            f"{scheduler_names()}")


def _family_kind(value):
    """The family name of a ``kind`` / ``(kind, kwargs)`` axis value."""
    if isinstance(value, tuple) and len(value) == 2:
        return value[0]
    return value


def _validate_arrivals(value) -> None:
    from repro_torch.core.energy import arrival_family_names

    kind = _family_kind(value)
    if kind not in arrival_family_names():
        raise ValueError(
            f"unknown arrival family {kind!r}; arrival-family registry "
            f"has {arrival_family_names()}")


def _validate_faults(value) -> None:
    if value is None:  # the fault-free program
        return
    refuse_faults(f"faults axis value {value!r}")


def _validate_taus_profile(value) -> None:
    if isinstance(value, str) and value not in _TAUS_PROFILES:
        raise ValueError(
            f"unknown taus profile {value!r}; taus-profile registry has "
            f"{sorted(_TAUS_PROFILES)}")


def _apply_scheduler(draft: dict, value) -> None:
    draft["scheduler"] = str(value)


def _apply_arrivals(draft: dict, value) -> None:
    if isinstance(value, tuple):
        kind, kw = value
        draft["arrivals"] = str(kind)
        draft["arrival_kwargs"] = dict(kw)
    else:
        draft["arrivals"] = str(value)


def _fmt_arrivals(value, fixed: bool) -> str:
    if isinstance(value, tuple):
        kind, kw = value
        if fixed:  # kwargs don't vary across cells — kind identifies it
            return str(kind)
        tail = "".join(f"_{k}{v:g}" if isinstance(v, (int, float))
                       else f"_{k}{v}" for k, v in sorted(kw.items()))
        return f"{kind}{tail}"
    return str(value)


def _apply_capacity(draft: dict, value) -> None:
    draft.setdefault("scheduler_kwargs", {})["capacity"] = float(value)


def _apply_n_clients(draft: dict, value) -> None:
    draft["n_clients"] = int(value)


def _apply_taus_profile(draft: dict, value) -> None:
    draft["taus"] = resolve_taus_profile(value, draft["n_clients"])


def _arrivals_is_value(v) -> bool:
    if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str) \
            and isinstance(v[1], dict):
        return True  # one hyperparameterized family, not a 2-kind sweep
    return _default_is_value(v)


def _taus_is_value(v) -> bool:
    if isinstance(v, (list, tuple)) and v \
            and all(isinstance(t, (int, float, np.integer, np.floating))
                    for t in v):
        return True  # one explicit per-client period vector
    return _default_is_value(v)


register_axis(
    "scheduler", apply=_apply_scheduler, fmt=lambda v, fixed: str(v),
    validate=_validate_scheduler,
    doc="scheduler registry name (repro_torch.core.scheduling)")
register_axis(
    "arrivals", apply=_apply_arrivals, fmt=_fmt_arrivals,
    is_value=_arrivals_is_value, validate=_validate_arrivals,
    doc="arrival-family name (repro_torch.core.energy), or (kind, kwargs)")
register_axis(
    "capacity", apply=_apply_capacity,
    fmt=lambda v, fixed: None if fixed else f"c{v:g}",
    doc="battery capacity -> scheduler_kwargs['capacity']")
register_axis(
    "n_clients", apply=_apply_n_clients,
    fmt=lambda v, fixed: None if fixed else f"n{v}",
    doc="client-population size; a DATA axis — ragged values are padded "
        "to the simulator capacity under an active mask (DESIGN.md §7), "
        "so every N shares one structure group")
register_axis(
    "taus_profile", apply=_apply_taus_profile, fmt=_fmt_taus,
    is_value=_taus_is_value, validate=_validate_taus_profile,
    doc="per-client energy-period profile: registered name, sequence, "
        "or callable(n)")


def _apply_faults(draft: dict, value) -> None:
    _validate_faults(value)
    draft["faults"] = None


def _fmt_faults(value, fixed: bool) -> str | None:
    if value is None:
        return None if fixed else "nofault"
    return _fmt_arrivals(value, fixed)


def _faults_is_value(v) -> bool:
    return v is None or _arrivals_is_value(v)


register_axis(
    "faults", apply=_apply_faults, fmt=_fmt_faults,
    is_value=_faults_is_value, validate=_validate_faults,
    doc="fault-family name, (kind, kwargs), or None for the fault-free "
        "program; only None is ported (ROADMAP Queue 1 step 2)")
register_axis(
    "seeds", apply=lambda draft, value: None,
    doc="seed count or explicit list; run in turn by the engine")
