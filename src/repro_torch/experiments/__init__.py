"""Scenario engine: declarative studies, grid execution, labeled results.

Port of ``repro.experiments`` on one device:

* :mod:`repro_torch.experiments.axes` — the registry of composable sweep
  axes (scheduler, arrivals, capacity, n_clients, taus_profile, faults,
  seeds) that a study cross-multiplies into cells.
* :mod:`repro_torch.experiments.study` — :class:`Study` specs +
  :class:`ExecutionConfig` + the named-study registry (``fig1``,
  ``fig1_grid``, ``capacity_sweep``, ``day_night``,
  ``population_scaling``); :meth:`Study.run` owns simulator
  construction (on the card unless ``device=`` says otherwise) and
  dispatch.
* :mod:`repro_torch.experiments.results` — :class:`GridResult`, the
  labeled result table (``.sel`` / ``.reduce`` / ``.to_records`` /
  ``.to_json``) with NaN-aware seed statistics.
* :mod:`repro_torch.experiments.scenario` — :class:`Scenario` cell specs
  and the legacy grid-registry shims (:func:`get_grid`).
* :mod:`repro_torch.experiments.engine` — :func:`execute_cells`, the
  single execution core: cells grouped by component structure, ragged
  populations padded per group, each group's cells and seeds run in
  turn through :class:`repro_torch.core.ClientSimulator`.

Not ported yet: placement across cards (ROADMAP Queue 1 step 7), the
resumable path (step 3), fault injection (step 2) and manifests with
the executable cache (step 4).
"""

from repro_torch.experiments.axes import (
    AXIS_ORDER,
    AxisSpec,
    axis_names,
    get_axis,
    register_axis,
    register_taus_profile,
    resolve_taus_profile,
)
from repro_torch.experiments.engine import (
    CellResult,
    DowngradeRecord,
    StructureGroup,
    check_unique_names,
    clear_cache,
    divergence_summary,
    execute_cells,
    grid_summary,
    last_downgrades,
    population_mask,
    resolve_structure_groups,
    run_grid,
    run_grid_sequential,
    subpopulation_p,
)
from repro_torch.experiments.results import GridResult, default_metric, seed_stats
from repro_torch.experiments.scenario import (
    ARRIVAL_KINDS,
    FIG1_SCHEDULERS,
    PAPER_TAUS,
    Scenario,
    default_taus,
    get_grid,
    grid_names,
    make_energy_process,
    register_grid,
    scenario_grid,
)
from repro_torch.experiments.study import (
    SIM_CACHE_SIZE,
    ExecutionConfig,
    Study,
    build_components,
    get_study,
    register_study,
    study_names,
)

__all__ = [
    "ARRIVAL_KINDS", "AXIS_ORDER", "FIG1_SCHEDULERS", "PAPER_TAUS",
    "SIM_CACHE_SIZE",
    "AxisSpec", "CellResult", "DowngradeRecord", "ExecutionConfig",
    "GridResult", "Scenario", "StructureGroup", "Study",
    "axis_names", "build_components", "check_unique_names", "clear_cache",
    "default_metric", "default_taus", "divergence_summary", "execute_cells",
    "get_axis", "get_grid", "get_study", "grid_names", "grid_summary",
    "last_downgrades", "make_energy_process", "population_mask",
    "register_axis", "register_grid", "register_study",
    "register_taus_profile", "resolve_structure_groups",
    "resolve_taus_profile", "run_grid", "run_grid_sequential",
    "scenario_grid", "seed_stats", "study_names", "subpopulation_p",
]
