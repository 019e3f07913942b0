"""Declarative studies: composable sweep axes → labeled grid results.

Port of ``repro.experiments.study``. A :class:`Study` is the
experiment-facing spec of a whole grid — the cross-product of registered
sweep axes (:mod:`repro_torch.experiments.axes`) over a fixed step
budget:

    study = (Study("fig1_grid", num_steps=1000)
             .axis("scheduler", ["alg1", "benchmark1", "benchmark2", "oracle"])
             .axis("arrivals", ["periodic", "binary", "uniform"])
             .axis("seeds", 8))
    result = study.run(grads_fn=..., p=..., optimizer=..., params0=w0,
                       use_kernel=True)
    result.reduce(metric, over="seed")["alg1_periodic"]

``Study.run`` owns simulator construction (memoized per ingredients and
device in a bounded LRU) and dispatches to the single execution core
(:func:`repro_torch.experiments.engine.execute_cells`), which runs each
structure group's cells in turn on the simulator's device: the card
unless ``device=`` says otherwise (``ExecutionConfig.sequential`` pads
per cell instead). ``ExecutionConfig.checkpoint_dir`` routes the study
through the preemption-safe
:func:`~repro_torch.experiments.engine.execute_cells_resumable`
instead: checkpointed chunks, and a killed run resumes from its
directory bit for bit.

Named studies (``fig1``, ``fig1_grid``, ``capacity_sweep``,
``day_night``, ``population_scaling``) live in a registry
(:func:`register_study` / :func:`get_study`) that subsumes the legacy
grid registry — :func:`repro_torch.experiments.get_grid` resolves
through it.

``ExecutionConfig.mesh`` places the study across the ranks of a
``torch.distributed`` process group (:mod:`repro_torch.experiments.
placement`): cells split over cell rows, each cell's population split
over a ``clients`` axis, every rank holding every result.

``Study`` and ``ExecutionConfig`` round-trip through JSON manifests
(:mod:`repro_torch.experiments.manifest`), the wire format the JAX
package shares.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, Callable, Sequence

from repro_torch._device import resolve_device
from repro_torch._lru import LRUCache
from repro_torch.core.trainer import ClientSimulator
from repro_torch.experiments import engine
from repro_torch.experiments.axes import AXIS_ORDER, get_axis
from repro_torch.experiments.results import GridResult, host
from repro_torch.experiments.scenario import FIG1_SCHEDULERS, Scenario

#: Bound on the per-Study simulator memoization (:meth:`Study.simulator`).
#: Each entry pins a ClientSimulator and the datasets its grads_fn
#: closure captured, so the cache must not grow without bound in a
#: long-running process (DESIGN.md §11).
SIM_CACHE_SIZE = 8


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How a study executes — everything that is not *what* to run.

    mesh : rank mesh for sharded execution: a 1-D cells mesh
        (DESIGN.md §5), a 1-D ``clients`` mesh (within-cell client
        sharding, DESIGN.md §8) or a 2-D ``(cells, clients)`` grid mesh
        (:func:`repro_torch.experiments.placement.make_grid_mesh`); None
        (or one rank) → the one-device path.
    eval_fn : optional (params) -> metric tree, evaluated every
        ``eval_every`` steps.
    eval_every : eval chunk length; 0 → one eval at the end when
        ``eval_fn`` is set.
    sequential : pad per cell instead of per structure group (a
        full-capacity cell then runs unmasked whatever its group) — the
        JAX package's per-cell baseline, kept for cross-checks.
    client_reduction : cross-rank aggregation under a ``clients`` mesh
        axis: ``"psum"`` (default, f32 tolerance), ``"gather"``
        (bitwise), ``"fused"`` / ``"fused_bf16"`` / ``"psum_bf16"``
        (DESIGN.md §9).
    degrade : arm the graceful-degradation ladder (DESIGN.md §10): a
        group whose sharded run raises ``ValueError`` retries one rung
        down, then on one rank; recorded in ``GridResult.downgrades``.
    checkpoint_dir : directory for preemption-safe execution
        (:func:`~repro_torch.experiments.engine.execute_cells_resumable`):
        the study runs in checkpointed chunks and a killed run resumes
        from here bit for bit. Incompatible with ``mesh`` /
        ``sequential`` / ``eval_fn``.
    checkpoint_every : chunk length between checkpoints (0 → one chunk,
        i.e. checkpoint only at the end).
    checkpoint_keep : retained checkpoints per structure group.
    halt_on_divergence : stop advancing a structure group once every one
        of its runs has gone non-finite (checkpointed path only).
    """

    mesh: Any = None
    eval_fn: Callable | None = None
    eval_every: int = 0
    sequential: bool = False
    client_reduction: str = "psum"
    degrade: bool = False
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    checkpoint_keep: int = 3
    halt_on_divergence: bool = False

    # ------------------------------------------------------ serialization

    def to_manifest(self) -> dict:
        """``execution-config/v1`` envelope (DESIGN.md §11). ``mesh`` /
        ``eval_fn`` hold live objects and must be None."""
        from repro_torch.experiments import manifest

        return manifest.execution_config_to_manifest(self)

    def to_json(self, **json_kw) -> str:
        return json.dumps(self.to_manifest(), **json_kw)

    @classmethod
    def from_manifest(cls, doc: dict) -> "ExecutionConfig":
        from repro_torch.experiments import manifest

        return manifest.execution_config_from_manifest(doc)

    @classmethod
    def from_json(cls, text: str) -> "ExecutionConfig":
        from repro_torch.experiments import manifest

        return manifest.execution_config_from_manifest(manifest.loads(text))


class Study:
    """Declarative sweep spec: named axes × a step budget.

    Axes are given either at construction (``axes={...}``, scalar values
    = fixed, sequences = swept) or via the chainable :meth:`axis`. The
    ``seeds`` axis is special: the engine runs it inside each cell, so
    it never appears in cell names and surfaces as the ``seed`` axis of
    the :class:`GridResult`.
    """

    def __init__(self, name: str = "study", *, num_steps: int,
                 axes: dict | None = None):
        self.name = name
        self.num_steps = int(num_steps)
        self._axes: dict[str, tuple] = {}
        self._fixed: set[str] = set()
        self._sim_cache = LRUCache(maxsize=SIM_CACHE_SIZE)
        for axis, values in (axes or {}).items():
            self.axis(axis, values)

    def axis(self, name: str, values) -> "Study":
        """Set one sweep axis; a scalar fixes it, a sequence sweeps it.

        Unknown axis names raise with the registered alternatives.
        Returns self for chaining.
        """
        spec = get_axis(name)  # validates; raises ValueError with axis_names()
        if name == "seeds":
            # seeds is a count or an explicit list, never a sweep of lists
            self._axes[name] = values
            return self
        fixed = spec.is_value(values)
        if fixed:
            values = (values,)
            self._fixed.add(name)
        else:
            values = tuple(values)
            self._fixed.discard(name)
            if not values:
                raise ValueError(f"axis {name!r} needs at least one value")
        self._axes[name] = values
        return self

    @property
    def axes(self) -> dict[str, tuple]:
        """Resolved axes in canonical order (seeds last)."""
        ordered = [n for n in AXIS_ORDER if n in self._axes]
        ordered += [n for n in self._axes if n not in ordered]
        return {n: self._axes[n] for n in ordered}

    def seeds(self) -> int | Sequence[int]:
        return self._axes.get("seeds", 8)

    # -------------------------------------------------------- serialization

    def to_manifest(self) -> dict:
        """``study/v1`` envelope: name, step budget, ordered axes with
        fixed/swept flags, seeds (:mod:`repro_torch.experiments.manifest`)."""
        from repro_torch.experiments import manifest

        return manifest.study_to_manifest(self)

    def to_json(self, **json_kw) -> str:
        return json.dumps(self.to_manifest(), **json_kw)

    @classmethod
    def from_manifest(cls, doc: dict) -> "Study":
        """Decode a ``study/v1`` envelope — typed-config-from-dict over
        the axis/scheduler/arrival/fault registries; unknown names raise
        naming the registry and its valid keys."""
        from repro_torch.experiments import manifest

        return manifest.study_from_manifest(doc)

    @classmethod
    def from_json(cls, text: str) -> "Study":
        from repro_torch.experiments import manifest

        return manifest.study_from_manifest(manifest.loads(text))

    def _seed_values(self) -> tuple:
        seeds = self.seeds()
        return tuple(range(seeds)) if isinstance(seeds, int) else tuple(seeds)

    # ---------------------------------------------------------- resolution

    def _sweep_axes(self) -> dict[str, tuple]:
        return {n: v for n, v in self.axes.items() if n != "seeds"}

    def resolve(self) -> list[Scenario]:
        """Cross-product the axes into named Scenario cells."""
        return [sc for sc, _ in self._resolve_labeled()]

    def _resolve_labeled(self) -> list[tuple[Scenario, dict]]:
        sweep = self._sweep_axes()
        if "scheduler" not in sweep or "arrivals" not in sweep:
            raise ValueError(
                f"study {self.name!r} needs at least the scheduler and "
                f"arrivals axes; have {list(sweep)}")
        cells = []
        for combo in itertools.product(*sweep.values()):
            labels = dict(zip(sweep.keys(), combo))
            draft: dict = {"n_clients": 8, "horizon": self.num_steps + 1,
                           "taus": None, "scheduler_kwargs": {},
                           "arrival_kwargs": {}}
            parts = []
            for axis, value in labels.items():
                spec = get_axis(axis)
                spec.apply(draft, value)
                part = spec.fmt(value, axis in self._fixed)
                if part is not None:
                    parts.append(part)
            name = "_".join(parts) if parts else "cell"
            cells.append((Scenario(name=name, **draft), labels))
        engine.check_unique_names([sc for sc, _ in cells])
        return cells

    # ----------------------------------------------------------- execution

    def simulator(self, *, grads_fn, p, optimizer, loss_fn=None,
                  use_kernel: bool = False, device=None) -> ClientSimulator:
        """Build (or reuse) the study's ClientSimulator on ``device``
        (None: the card, raising when there is none).

        The study memoizes construction on its ingredients, so
        ``study.run(...)`` called twice with the same functions builds
        one simulator. Functions are compared by equality (bound methods
        like ``problem.suboptimality`` are a fresh object per attribute
        access but compare equal); the weight vector ``p`` by value (a
        host copy) and the device by name.

        The memoization is a **bounded LRU** (:data:`SIM_CACHE_SIZE`
        entries); :meth:`cache_stats` / :meth:`clear_cache` expose the
        counters.
        """
        device = resolve_device(device)
        key = (grads_fn, optimizer, loss_fn, use_kernel, str(device),
               tuple(host(p).astype("float32").reshape(-1).tolist()))
        return self._sim_cache.get_or_create(
            key, lambda: ClientSimulator(
                grads_fn=grads_fn, p=p, optimizer=optimizer,
                loss_fn=loss_fn, use_kernel=use_kernel, device=device))

    def cache_stats(self) -> dict:
        """Hit/miss/eviction counters + occupancy of the simulator
        memoization (:meth:`simulator`)."""
        return self._sim_cache.stats()

    def clear_cache(self, *, engine_caches: bool = True) -> dict:
        """Drop the study's memoized simulators (and, by default, call
        :func:`repro_torch.experiments.clear_cache`). Returns the final
        :meth:`cache_stats` snapshot."""
        stats = self._sim_cache.stats()
        self._sim_cache.clear()
        if engine_caches:
            engine.clear_cache()
        return stats

    def run(self, *, params0, grads_fn=None, p=None, optimizer=None,
            loss_fn=None, use_kernel: bool = False,
            sim: ClientSimulator | None = None,
            config: ExecutionConfig | None = None,
            device=None) -> GridResult:
        """Execute the whole study and return a labeled :class:`GridResult`.

        Pass either a prebuilt ``sim`` (which brings its own device) or
        the simulator ingredients (``grads_fn`` / ``p`` / ``optimizer``
        [+ ``loss_fn`` / ``use_kernel``] — memoized, see
        :meth:`simulator`) and ``device`` (None: the card). ``params0``
        and the keys go to the simulator's device; the result's tensors
        stay there. Everything about *how* to execute lives in
        ``config``.
        """
        cfg = config or ExecutionConfig()
        if sim is None:
            if grads_fn is None or p is None or optimizer is None:
                raise ValueError(
                    "either pass a prebuilt sim= or all of "
                    "grads_fn/p/optimizer")
            sim = self.simulator(grads_fn=grads_fn, p=p, optimizer=optimizer,
                                 loss_fn=loss_fn, use_kernel=use_kernel,
                                 device=device)
        cells = self._resolve_labeled()
        if cfg.checkpoint_dir is not None:
            conflicts = [n for n, v in (("mesh", cfg.mesh),
                                        ("sequential", cfg.sequential),
                                        ("eval_fn", cfg.eval_fn)) if v]
            if conflicts:
                raise ValueError(
                    f"checkpoint_dir (resumable execution) is incompatible "
                    f"with {conflicts} — run those studies unchunked")
            results = engine.execute_cells_resumable(
                [sc for sc, _ in cells], sim=sim, params0=params0,
                num_steps=self.num_steps, seeds=self.seeds(),
                checkpoint_dir=cfg.checkpoint_dir,
                checkpoint_every=cfg.checkpoint_every,
                keep=cfg.checkpoint_keep,
                halt_on_divergence=cfg.halt_on_divergence)
        else:
            results = engine.execute_cells(
                [sc for sc, _ in cells], sim=sim, params0=params0,
                num_steps=self.num_steps, seeds=self.seeds(),
                eval_fn=cfg.eval_fn, eval_every=cfg.eval_every,
                mesh=cfg.mesh, sequential=cfg.sequential,
                client_reduction=cfg.client_reduction, degrade=cfg.degrade)
        axes = dict(self._sweep_axes())
        axes["seed"] = self._seed_values()
        return GridResult(
            cells={sc.name: results[sc.name] for sc, _ in cells},
            labels={sc.name: labels for sc, labels in cells},
            axes=axes, name=self.name,
            downgrades=engine.last_downgrades())


def build_components(*, scheduler: str, arrivals, n_clients: int,
                     horizon: int, taus_profile="paper", capacity=None):
    """One cell's (scheduler, energy) pair straight from the axis
    registry, so drivers and studies build components through one code
    path."""
    study = Study("cell", num_steps=horizon - 1,
                  axes={"scheduler": scheduler, "arrivals": arrivals,
                        "n_clients": n_clients, "taus_profile": taus_profile})
    if capacity is not None:
        study.axis("capacity", capacity)
    (cell,) = study.resolve()
    return cell.build()


# ------------------------------------------------------------ study registry

_STUDIES: dict[str, Callable[..., Study]] = {}


def register_study(name: str):
    """Decorator: register a named Study factory ``(**kw) -> Study``."""

    def deco(fn):
        _STUDIES[name] = fn
        return fn

    return deco


def get_study(name: str, **kw) -> Study:
    try:
        factory = _STUDIES[name]
    except KeyError:
        raise ValueError(
            f"unknown study {name!r}; have {study_names()}") from None
    return factory(**kw)


def study_names() -> list[str]:
    return sorted(_STUDIES)


@register_study("fig1")
def _fig1(n_clients: int = 40, num_steps: int = 1000, taus_profile="paper",
          seeds=8) -> Study:
    """Paper Figure 1 verbatim: 4 methods on periodic (eq. 37) arrivals."""
    return Study("fig1", num_steps=num_steps, axes={
        "scheduler": list(FIG1_SCHEDULERS), "arrivals": "periodic",
        "n_clients": n_clients, "taus_profile": taus_profile,
        "seeds": seeds})


@register_study("fig1_grid")
def _fig1_grid(n_clients: int = 40, num_steps: int = 1000,
               taus_profile="paper", seeds=8) -> Study:
    """Scenario-diversity extension: 4 methods × all 3 stationary
    arrival families."""
    return Study("fig1_grid", num_steps=num_steps, axes={
        "scheduler": list(FIG1_SCHEDULERS),
        "arrivals": ["periodic", "binary", "uniform"],
        "n_clients": n_clients, "taus_profile": taus_profile,
        "seeds": seeds})


@register_study("capacity_sweep")
def _capacity_sweep(n_clients: int = 8, num_steps: int = 2000,
                    capacities: Sequence[float] = (1.0, 2.0, 4.0),
                    taus_profile="paper", seeds=8) -> Study:
    """Battery-capacity sweep for the beyond-paper adaptive scheduler
    (one structure group for the whole sweep)."""
    return Study("capacity_sweep", num_steps=num_steps, axes={
        "scheduler": "battery_adaptive", "arrivals": "binary",
        "capacity": [float(c) for c in capacities],
        "n_clients": n_clients, "taus_profile": taus_profile,
        "seeds": seeds})


@register_study("day_night")
def _day_night(n_clients: int = 8, num_steps: int = 2000, period: int = 50,
               contrast: float = 3.0, taus_profile="paper",
               seeds=8) -> Study:
    """Non-stationary day/night β_t (arXiv:2102.11274 regime): the
    energy-aware schedulers vs the energy-agnostic baseline under a
    periodic harvest-rate profile with the same mean rate 1/τ."""
    return Study("day_night", num_steps=num_steps, axes={
        "scheduler": ["alg2", "benchmark1", "battery_adaptive", "oracle"],
        "arrivals": ("day_night",
                     {"period": period, "contrast": contrast}),
        "n_clients": n_clients, "taus_profile": taus_profile,
        "seeds": seeds})


@register_study("population_scaling")
def _population_scaling(n_clients: Sequence[int] = (4, 8, 16),
                        num_steps: int = 1000, taus_profile="paper",
                        seeds=8) -> Study:
    """Client-population scaling curve: population size is a *data*
    axis (DESIGN.md §7) — every cell is padded to the simulator capacity
    ``len(sim.p)`` with an active-row mask, so all N values share one
    structure group. The caller's ``sim``/``grads_fn``/``p`` must be
    built at capacity ≥ max(n_clients); each cell reweights (and crops
    its participation history) to its own N."""
    return Study("population_scaling", num_steps=num_steps, axes={
        "scheduler": "alg2", "arrivals": "binary",
        "n_clients": [int(n) for n in n_clients],
        "taus_profile": taus_profile, "seeds": seeds})
