"""Grid execution on one device: each structure group's cells in turn.

Port of ``repro.experiments.engine``. The paper's headline evidence is a
*grid* of runs — schedulers × arrival processes × seeds. The JAX engine
compiles one ``vmap(scenarios) ∘ vmap(seeds)`` program per structure
group. The port keeps the grouping and everything decided by it, and
runs each member cell and seed of a group in turn through
:meth:`ClientSimulator.run`: a cell and seed pays exactly what a
standalone run pays, ``num_steps`` launches of kernel K2 (``sgd`` with
``use_kernel``) or of K1 (any other optimizer) on the card.

1. Scenarios are grouped by the **structure** of their built
   (scheduler, energy) pair (:func:`_group_key`): the component types,
   their static metadata (``n_clients``, ``scaled``) and the shapes and
   dtypes of their tensor fields — the groups the JAX package's treedef
   gives.
2. **Ragged client populations** (DESIGN.md §7): cells whose
   ``n_clients`` is below the simulator capacity ``N_cap = len(sim.p)``
   are padded to N_cap, an ``active_mask`` marks the rows that exist,
   and each cell carries its own zero-padded weights
   (:func:`subpopulation_p`). Raggedness is decided per group, exactly
   as in JAX: a group whose members are all at capacity runs unmasked;
   in a ragged group every member runs under its mask, a full-capacity
   member under an all-ones mask with ``sim.p`` verbatim (bit-identical
   to the unmasked run).
3. Per-seed results are stacked along a leading seed axis R, per-client
   outputs are cropped back to each cell's n, and the quarantine record
   (``diverged``) is attached.

Results stay on the simulator's device; :func:`_attach_divergence` and
:func:`divergence_summary` copy the per-step finite flags and the
quarantine record to the host explicitly.

Not ported yet, and refused with ``NotImplementedError``: ``mesh`` and
device placement (ROADMAP Queue 1 step 7), the resumable checkpointed
path (step 3), fault injection (step 2) and ``executable_cache`` (step
4). A batched cell step (the cells of a group in one step) is a later
speed-up, to be judged on a benchmark (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.core.energy import pad_arrivals
from repro_torch.core.scheduling import pad_scheduler
from repro_torch.core.trainer import ClientSimulator, SimHistory
from repro_torch.experiments.results import host
from repro_torch.experiments.scenario import Scenario, refuse

class CellResult(NamedTuple):
    """Per-scenario result; every leaf carries a leading seed axis R.

    params   : final model parameters, leaves (R, ...)
    history  : SimHistory with leaves (R, T, ...)
    evals    : eval_fn outputs with leaves (R, num_evals, ...), or None
    diverged : (R,) int32 — first step index at which the seed's params
               went non-finite (−1: the run stayed finite throughout),
               computed from the ``history.finite`` per-step flags.

    Every leaf is a torch tensor on the simulator's device.
    """

    params: Any
    history: SimHistory
    evals: Any = None
    diverged: Any = None


def _signature(component):
    """Hashable structure of one component object (None → None).

    Per dataclass field: a tensor gives its shape and dtype; static
    metadata (``n_clients``, a bool such as ``scaled``, a string) its
    value; any other Python number its type, since the JAX package
    holds such hyperparameters (a battery's ``capacity``, ``ema``,
    ``warmup``) as scalar leaves that may differ within a group.
    """
    if component is None:
        return None
    if dataclasses.is_dataclass(component):
        items = [(f.name, getattr(component, f.name))
                 for f in dataclasses.fields(component)]
    else:
        items = sorted(vars(component).items())
    sig = []
    for name, v in items:
        if isinstance(v, torch.Tensor):
            sig.append((name, tuple(v.shape), str(v.dtype)))
        elif name == "n_clients" or v is None or isinstance(v, (bool, str)):
            sig.append((name, v))
        else:
            sig.append((name, type(v).__name__))
    return type(component), tuple(sig)


def _group_key(scheduler, energy, faults=None):
    """Structure signature of a cell's components: the port's
    counterpart of the JAX treedef plus leaf shapes and dtypes."""
    return _signature(scheduler), _signature(energy), _signature(faults)


def population_mask(n_clients: int, n_total: int, device=None) -> torch.Tensor:
    """(n_total,) float32 mask: 1 for the first ``n_clients`` rows, on
    ``device`` (None: the card)."""
    idx = torch.arange(n_total, device=resolve_device(device))
    return (idx < n_clients).to(torch.float32)


def subpopulation_p(p, n_clients: int, n_total: int | None = None) -> torch.Tensor:
    """Data weights of the ``n_clients``-prefix subpopulation of ``p``,
    renormalized over the active rows only and zero-padded to
    ``n_total`` (default ``len(p)``), on ``p``'s device.

    This is *the* unbiasedness-under-masking rule (DESIGN.md §7): the
    paper's p_i = D_i/D must sum to 1 over the clients that exist. The
    prefix sum is taken on the host in client order, one f32 add at a
    time — the order of the JAX package's CPU reduction up to 32
    clients (past 32, XLA's vectorized order can differ in the last
    bit) — so a cell's weights do not depend on the device.
    """
    p = torch.as_tensor(p, dtype=torch.float32)
    n_total = int(p.shape[0]) if n_total is None else int(n_total)
    if not 1 <= n_clients <= n_total:
        raise ValueError(
            f"n_clients={n_clients} outside [1, {n_total}]")
    total = np.add.accumulate(host(p[:n_clients]))[-1]
    pref = p[:n_clients] / torch.tensor(total, dtype=torch.float32,
                                        device=p.device)
    if n_clients == n_total:
        return pref
    return torch.cat([pref, torch.zeros((n_total - n_clients,),
                                        dtype=torch.float32, device=p.device)])


def _pad_built(built, n_cap: int):
    """(scheduler, energy, faults) built at natural n → padded to n_cap
    rows (``faults`` is None: fault injection is not ported)."""
    scheduler, energy, faults = built
    return pad_scheduler(scheduler, n_cap), pad_arrivals(energy, n_cap), faults


def _cell_mask_p(sc: Scenario, sim: ClientSimulator, n_cap: int):
    """(active_mask, p) for one cell of a ragged group. A full-capacity
    cell gets an all-ones mask and the caller's ``sim.p``
    *unrenormalized*: multiplying by 1.0 and reusing p verbatim keeps it
    bit-identical to the unmasked run, whereas renormalizing would
    perturb it whenever p does not sum to exactly 1.0 in f32."""
    if sc.n_clients == n_cap:
        return torch.ones((n_cap,), dtype=torch.float32,
                          device=sim.device), sim.p
    return (population_mask(sc.n_clients, n_cap, device=sim.device),
            subpopulation_p(sim.p, sc.n_clients, n_cap))


class StructureGroup(NamedTuple):
    """One structure group of a resolved grid.

    ``key`` is the :func:`_group_key` signature; ``members`` index into
    the caller's scenario list; ``scheduler`` / ``energy`` / ``faults``
    are per-member lists of the padded components (``faults`` entries
    are None); ``active`` / ``p`` are per-member lists of (N_cap,)
    ragged operands on the simulator's device, both None when the group
    is uniformly at capacity. The engine runs the members in turn.
    """

    key: Any
    members: list[int]
    scheduler: list
    energy: list
    faults: list
    active: list | None
    p: list | None
    ragged: bool


def _check_capacity(scenarios, n_cap: int) -> None:
    over = [f"{sc.name} (N={sc.n_clients})" for sc in scenarios
            if sc.n_clients > n_cap]
    if over:
        raise ValueError(
            f"scenario population exceeds the simulator capacity "
            f"N_cap={n_cap} (len(sim.p)): {over}")


def resolve_structure_groups(
    scenarios: Sequence[Scenario], *, sim: ClientSimulator,
) -> tuple[list[str], int, list[StructureGroup]]:
    """Group scenario cells by padded component structure.

    Below-capacity components are padded to ``N_cap = len(sim.p)`` (an
    identity at capacity) and grouping is on the padded structure;
    raggedness is decided per group, so uniform groups keep their
    mask-free runs.

    Returns ``(names, n_cap, groups)`` in input order.
    """
    scenarios = list(scenarios)
    names = check_unique_names(scenarios)
    n_cap = int(sim.p.shape[0])
    _check_capacity(scenarios, n_cap)
    built = [sc.build() + (sc.build_faults(),) for sc in scenarios]
    padded = [b if sc.n_clients == n_cap else _pad_built(b, n_cap)
              for sc, b in zip(scenarios, built)]
    grouped: dict[Any, list[int]] = {}
    for idx, (sch, en, flt) in enumerate(padded):
        grouped.setdefault(_group_key(sch, en, flt), []).append(idx)

    groups = []
    for gkey, members in grouped.items():
        ragged = any(scenarios[i].n_clients != n_cap for i in members)
        active, p = None, None
        if ragged:
            active, p = map(list, zip(*(_cell_mask_p(scenarios[i], sim, n_cap)
                                        for i in members)))
        groups.append(StructureGroup(
            gkey, members, [padded[i][0] for i in members],
            [padded[i][1] for i in members], [padded[i][2] for i in members],
            active, p, ragged))
    return names, n_cap, groups


def _crop_cell(cell: CellResult, n: int, n_cap: int) -> CellResult:
    """Slice the padded client axis of per-client outputs back to n."""
    if n == n_cap:
        return cell
    hist = cell.history._replace(
        participation=cell.history.participation[..., :n])
    return cell._replace(history=hist)


def _attach_divergence(cell: CellResult) -> CellResult:
    """Fill ``CellResult.diverged`` from the per-step isfinite flags.

    The flags are copied to the host once; ``diverged[r]`` is the first
    step index whose post-step params were non-finite for seed r, or −1
    when the whole run stayed finite. It goes back to the flags' device
    as int32. Divergence is absorbing under every built-in optimizer
    (NaN params → NaN grads → NaN params), so first-bad-step plus the
    flag tail characterize the quarantined trajectory.
    """
    fin = cell.history.finite
    if fin is None:  # hand-built history without flags — nothing to report
        return cell
    bad = ~host(fin)
    first = np.where(bad.any(axis=-1), bad.argmax(axis=-1), -1)
    return cell._replace(diverged=torch.as_tensor(
        first, dtype=torch.int32).to(fin.device))


def divergence_summary(results: dict[str, CellResult]) -> dict[str, dict]:
    """Per-cell quarantine stats: ``{name: {n_diverged, first_bad_step}}``.

    ``first_bad_step`` is the earliest diverged seed's first non-finite
    step (−1 when every seed stayed finite). The same numbers surface
    per-study through :meth:`repro_torch.experiments.GridResult.divergence`.
    """
    out = {}
    for name, cell in results.items():
        d = host(cell.diverged) if cell.diverged is not None \
            else np.array([-1])
        bad = d[d >= 0]
        out[name] = {"n_diverged": int(bad.size),
                     "first_bad_step": int(bad.min()) if bad.size else -1}
    return out


def clear_cache() -> None:
    """Drop what the engine caches between grids.

    The JAX engine keeps compiled group executables (and the simulator
    and ``eval_fn`` closures they pin) in a process-global jit cache and
    drops them here. The port compiles no group program, so it keeps no
    such cache and this drops nothing; it stays so that callers of the
    JAX API (``Study.clear_cache``, the theory bench) run unchanged.
    The kernels' built libraries are per process and are kept.
    """


def _seed_keys(seeds, device):
    """The seed list and one ``PRNGKey(s)`` a seed on ``device``."""
    if isinstance(seeds, int):
        seeds = range(seeds)
    seeds = list(seeds)
    if not seeds:
        raise ValueError("need at least one seed")
    return seeds, [trandom.PRNGKey(int(s), device=device) for s in seeds]


def check_unique_names(scenarios: Sequence[Scenario]) -> list[str]:
    """Scenario names key the result mapping — duplicates would silently
    overwrite cells. Shared by every execution path (grouped, sequential,
    Study.resolve)."""
    names = [sc.name for sc in scenarios]
    if len(set(names)) != len(names):
        dups = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(
            f"scenario names must be unique, got duplicates {dups} in {names}")
    return names


def _resolve_sim(sim, grads_fn, p, optimizer, loss_fn, use_kernel, device):
    if sim is not None:
        return sim
    if grads_fn is None or p is None or optimizer is None:
        raise ValueError(
            "either pass a prebuilt sim= or all of grads_fn/p/optimizer")
    return ClientSimulator(grads_fn=grads_fn, p=p, optimizer=optimizer,
                           loss_fn=loss_fn, use_kernel=use_kernel,
                           device=device)


# ------------------------------------------------- graceful degradation


@dataclasses.dataclass(frozen=True)
class DowngradeRecord:
    """One structured graceful-degradation event (DESIGN.md §10).

    The JAX package records these when a sharded group falls down its
    reduction ladder or back to one device. The port runs on one device
    and has no sharded path yet (ROADMAP Queue 1 step 7), so it records
    none; the type and :func:`last_downgrades` keep the API.
    """

    group: tuple[str, ...]
    stage: str
    from_value: str
    to_value: str
    error: str

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)


_LAST_DOWNGRADES: list[DowngradeRecord] = []


def last_downgrades() -> tuple[DowngradeRecord, ...]:
    """Downgrade records from the most recent execution (reset at the
    start of every :func:`execute_cells` call; always empty in the
    port)."""
    return tuple(_LAST_DOWNGRADES)


def _run_cell(sim, key, params0, num_steps, scheduler, energy, p, active,
              eval_fn, eval_every) -> CellResult:
    out = sim.run(key, params0, num_steps, scheduler=scheduler,
                  energy=energy, p=p, active_mask=active, eval_fn=eval_fn,
                  eval_every=eval_every)
    return CellResult(*out) if eval_fn is not None else CellResult(*out, None)


def _finish(per_seed: list[CellResult], n: int, n_cap: int) -> CellResult:
    """Seeds stacked along a leading axis, cropped, quarantine attached."""
    stacked = tree_map(lambda *xs: torch.stack(xs), *per_seed)
    return _attach_divergence(_crop_cell(stacked, n, n_cap))


def execute_cells(
    scenarios: Sequence[Scenario],
    *,
    sim: ClientSimulator,
    params0,
    num_steps: int,
    seeds: int | Sequence[int] = 8,
    eval_fn=None,
    eval_every: int = 0,
    mesh=None,
    sequential: bool = False,
    client_reduction: str = "psum",
    degrade: bool = False,
    executable_cache=None,
) -> dict[str, CellResult]:
    """Execute scenario × seed cells with a prebuilt simulator.

    The single execution core behind :meth:`Study.run` and the legacy
    :func:`run_grid` / :func:`run_grid_sequential` shims. Names and
    capacity are checked before any step runs. Then the cells are
    resolved into structure groups (:func:`resolve_structure_groups`)
    and each group's member cells run in turn, each seed ``s`` as one
    ``sim.run(PRNGKey(s), params0, num_steps, ...)`` on the simulator's
    device — bit-identical to a standalone run of the same cell.
    ``sequential=True`` pads per cell instead: a below-capacity cell
    runs under its mask and renormalized weights, a full-capacity cell
    unmasked, whatever its group.

    ``grads_fn`` must always emit N_cap rows — ragged cells ignore the
    rows of clients that do not exist. Per-client outputs
    (``history.participation``) are cropped back to the natural n.

    ``mesh`` and ``executable_cache`` are refused (ROADMAP Queue 1 steps
    7 and 4). ``client_reduction`` and ``degrade`` only act on a mesh in
    the JAX package, so without one they change nothing here either.

    Returns ``{scenario.name: CellResult}`` in input order.
    """
    del client_reduction, degrade  # mesh-only options
    if mesh is not None:
        refuse("mesh= (device placement across cards)", 7,
               "experiments/placement.py")
    if executable_cache is not None:
        refuse("executable_cache=", 4, "serve/cache.py")
    scenarios = list(scenarios)
    del _LAST_DOWNGRADES[:]
    names = check_unique_names(scenarios)
    n_cap = int(sim.p.shape[0])
    _check_capacity(scenarios, n_cap)
    _, keys = _seed_keys(seeds, sim.device)

    if sequential:
        results = {}
        for sc in scenarios:
            scheduler, energy = sc.build()
            sc.build_faults()
            active, p_cell = None, None
            if sc.n_clients != n_cap:
                scheduler, energy, _ = _pad_built(
                    (scheduler, energy, None), n_cap)
                active, p_cell = _cell_mask_p(sc, sim, n_cap)
            per_seed = [_run_cell(sim, key, params0, num_steps, scheduler,
                                  energy, p_cell, active, eval_fn, eval_every)
                        for key in keys]
            results[sc.name] = _finish(per_seed, sc.n_clients, n_cap)
        return results

    _, _, groups = resolve_structure_groups(scenarios, sim=sim)
    results: list[CellResult | None] = [None] * len(scenarios)
    for grp in groups:
        for j, idx in enumerate(grp.members):
            active = grp.active[j] if grp.ragged else None
            p_cell = grp.p[j] if grp.ragged else None
            per_seed = [_run_cell(sim, key, params0, num_steps,
                                  grp.scheduler[j], grp.energy[j], p_cell,
                                  active, eval_fn, eval_every)
                        for key in keys]
            results[idx] = _finish(per_seed, scenarios[idx].n_clients, n_cap)
    return dict(zip(names, results))


def run_grid(
    scenarios: Sequence[Scenario],
    *,
    grads_fn=None,
    p=None,
    optimizer=None,
    params0,
    num_steps: int,
    seeds: int | Sequence[int] = 8,
    loss_fn=None,
    use_kernel: bool = False,
    eval_fn=None,
    eval_every: int = 0,
    sim: ClientSimulator | None = None,
    mesh=None,
    device=None,
) -> dict[str, CellResult]:
    """Execute every scenario × seed cell (legacy shim of
    :meth:`repro_torch.experiments.Study.run`).

    ``seeds`` is either a count (seeds 0..R−1) or an explicit list; seed
    ``s`` runs under ``PRNGKey(s)``, bit-identical to a standalone
    ``ClientSimulator.run(PRNGKey(s), ...)`` of the same cell. Pass a
    prebuilt ``sim`` (which brings its own device), or its ingredients
    and ``device`` (None: the card). ``mesh`` is refused (ROADMAP Queue
    1 step 7).

    Returns ``{scenario.name: CellResult}`` in input order.
    """
    sim = _resolve_sim(sim, grads_fn, p, optimizer, loss_fn, use_kernel,
                       device)
    return execute_cells(scenarios, sim=sim, params0=params0,
                         num_steps=num_steps, seeds=seeds, eval_fn=eval_fn,
                         eval_every=eval_every, mesh=mesh)


def run_grid_sequential(
    scenarios: Sequence[Scenario],
    *,
    grads_fn=None,
    p=None,
    optimizer=None,
    params0,
    num_steps: int,
    seeds: int | Sequence[int] = 8,
    loss_fn=None,
    use_kernel: bool = False,
    eval_fn=None,
    eval_every: int = 0,
    sim: ClientSimulator | None = None,
    device=None,
) -> dict[str, CellResult]:
    """The per-cell padding baseline (``execute_cells(sequential=True)``).

    .. deprecated:: prefer ``Study.run(config=ExecutionConfig(
       sequential=True))``. Bit-identical to :func:`run_grid` (same
       per-seed keys).
    """
    sim = _resolve_sim(sim, grads_fn, p, optimizer, loss_fn, use_kernel,
                       device)
    return execute_cells(scenarios, sim=sim, params0=params0,
                         num_steps=num_steps, seeds=seeds, eval_fn=eval_fn,
                         eval_every=eval_every, sequential=True)


def grid_summary(results: dict[str, CellResult], reducer=None) -> dict[str, dict]:
    """Per-scenario NaN-aware mean±std over the seed axis of a metric.

    ``reducer(cell) -> (R,)`` extracts one scalar per seed; default is
    the mean loss over the final 10% of steps. Diverged seeds (NaN/inf)
    are excluded from mean/std and counted in ``n_nan``
    (:func:`repro_torch.experiments.results.seed_stats` — the same
    reduction backing :meth:`GridResult.reduce`).
    """
    from repro_torch.experiments import results as results_mod

    reducer = results_mod.default_metric if reducer is None else reducer
    return {name: results_mod.seed_stats(reducer(cell))
            for name, cell in results.items()}
