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

A scenario's fault component (:mod:`repro_torch.core.faults`) is part
of its structure and is padded with the rest. **Preemption-safe
execution** (:func:`execute_cells_resumable`) advances each group in
chunks through :meth:`ClientSimulator.run_carry` and checkpoints the
group's carries and history after every chunk, stacked into ``(S, R,
…)`` arrays, the layout the JAX package writes; a run killed at any
point resumes from its directory bit for bit. A legacy simulator (its
:meth:`~ClientSimulator.flat_spec` None: ``flat=False``, or a
``params0`` of mixed dtypes) takes every route; its carries are trees,
checkpointed in their leaves' dtypes.

**The runner protocol** (DESIGN.md §11) is the JAX package's: a
caller-owned ``executable_cache`` (:class:`repro_torch.serve.
ExecutableCache`) hands :func:`execute_cells` one runner per structure
group (:func:`make_group_runner`) and :func:`execute_cells_resumable`
one per group and chunk length (:func:`make_chunk_runner`). Nothing is
traced or compiled in the port: a runner runs the same code as the
uncached path, and counts as a "compile" (its ``on_trace`` hook) the
first run of each batch signature it has not run before, the signature
that makes the JAX package's jit trace again. So the serve layer's
counters take the JAX package's values on the same traffic.

**Placement across ranks** (``mesh=``, :mod:`repro_torch.experiments.
placement`): a group's cells are split over the mesh's cell rows, and a
``clients`` axis splits each cell's population over the ranks of its
row, ``client_reduction`` choosing the cross-rank aggregation. With
``degrade=True`` a group whose sharded run raises ``ValueError`` moves
down :data:`_REDUCTION_LADDER` and, when the ladder is spent, back to
one rank; each move is a :class:`DowngradeRecord`. A batched cell step
(the cells of a group in one step) is a speed-up to be judged on a
benchmark (ROADMAP, Housekeeping).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import threading
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    write_json_atomic)
from repro_torch.core import aggregation
from repro_torch.core.energy import pad_arrivals
from repro_torch.core.faults import pad_faults
from repro_torch.core.scheduling import pad_scheduler
from repro_torch.core.trainer import ClientSimulator, SimHistory
from repro_torch.experiments.results import host
from repro_torch.experiments.scenario import Scenario

_LOG = logging.getLogger(__name__)


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
    metadata (``n_clients``, a field the class lists in
    ``meta_fields`` such as a stale fault's ``delay``, a bool such as
    ``scaled``, a string) its value; a tuple of components (a composite
    fault's ``parts``) each part's signature; any other Python number
    its type, since the JAX package holds such hyperparameters (a
    battery's ``capacity``, ``ema``, ``warmup``) as scalar leaves that
    may differ within a group.
    """
    if component is None:
        return None
    if dataclasses.is_dataclass(component):
        items = [(f.name, getattr(component, f.name))
                 for f in dataclasses.fields(component)]
    else:
        items = sorted(vars(component).items())
    meta = ("n_clients",) + tuple(getattr(component, "meta_fields", ()))
    sig = []
    for name, v in items:
        if isinstance(v, torch.Tensor):
            sig.append((name, tuple(v.shape), str(v.dtype)))
        elif name in meta or v is None or isinstance(v, (bool, str)):
            sig.append((name, v))
        elif isinstance(v, tuple):
            sig.append((name, tuple(map(_signature, v))))
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
    rows (``faults`` may be None)."""
    scheduler, energy, faults = built
    return (pad_scheduler(scheduler, n_cap), pad_arrivals(energy, n_cap),
            pad_faults(faults, n_cap))


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
    are None for fault-free cells); ``active`` / ``p`` are per-member lists of (N_cap,)
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
    drops them here. The port compiles no group program; what it drops
    are the sharded runners' signatures, which pin their simulators
    (:func:`repro_torch.experiments.placement.clear_cache`). The
    kernels' built libraries are per process and are kept.
    """
    from repro_torch.experiments import placement

    placement.clear_cache()


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

#: Reduction fallback order (DESIGN.md §10): each step strips one
#: requirement — fused kernel first, then the bf16 wire, then the psum
#: collective — ending at ``gather``, the bitwise-oracle path with no
#: precondition beyond a capacity the client axis divides.
_REDUCTION_LADDER: dict[str, tuple[str, ...]] = {
    "fused_bf16": ("psum_bf16", "psum", "gather"),
    "fused": ("psum", "gather"),
    "psum_bf16": ("psum", "gather"),
    "psum": ("gather",),
    "gather": (),
}


@dataclasses.dataclass(frozen=True)
class DowngradeRecord:
    """One structured graceful-degradation event (DESIGN.md §10).

    ``stage`` is the ladder rung that moved: ``"reduction"`` (the
    client cross-rank aggregation fell one step down
    :data:`_REDUCTION_LADDER`) or ``"placement"`` (the sharded run was
    abandoned for the one-rank path). ``group`` names the scenario cells
    that were run again; ``error`` is the ValueError that moved them.
    Every rank records the same events: the preconditions are checked
    before any rank runs a step.
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
    start of every :func:`execute_cells` call); empty means every group
    ran at its requested placement and reduction."""
    return tuple(_LAST_DOWNGRADES)


def _record_downgrade(group, stage, frm, to, err) -> DowngradeRecord:
    rec = DowngradeRecord(group=tuple(group), stage=stage,
                          from_value=str(frm), to_value=str(to),
                          error=str(err))
    _LAST_DOWNGRADES.append(rec)
    _LOG.warning("degraded %s %s -> %s: %s", stage, frm, to, rec.to_json())
    return rec


def _run_cell(sim, key, params0, num_steps, scheduler, energy, faults, p,
              active, eval_fn, eval_every) -> CellResult:
    out = sim.run(key, params0, num_steps, scheduler=scheduler,
                  energy=energy, faults=faults, p=p, active_mask=active,
                  eval_fn=eval_fn, eval_every=eval_every)
    return CellResult(*out) if eval_fn is not None else CellResult(*out, None)


def _stack_seeds(per_seed: list[CellResult]) -> CellResult:
    return tree_map(lambda *xs: torch.stack(xs), *per_seed)


def _finish(cell: CellResult, n: int, n_cap: int) -> CellResult:
    """A seed-stacked cell cropped to n, quarantine attached."""
    return _attach_divergence(_crop_cell(cell, n, n_cap))


def _group_body(scheduler, energy, faults, active, p, params0, keys, *,
                sim: ClientSimulator, num_steps: int, eval_fn=None,
                eval_every: int = 0) -> list[CellResult]:
    """One structure group's member cells, each seed in turn: the shared
    computation behind the uncached path of :func:`execute_cells` and
    :func:`make_group_runner`, so both give the same bits.

    ``scheduler`` / ``energy`` / ``faults`` are per-member lists;
    ``active`` / ``p`` per-member lists or None (a uniform group);
    ``keys`` one key a seed. Returns one uncropped CellResult a member,
    its leaves stacked along the seed axis R.
    """
    cells = []
    for j in range(len(scheduler)):
        cells.append(_stack_seeds([
            _run_cell(sim, key, params0, num_steps, scheduler[j], energy[j],
                      faults[j], None if p is None else p[j],
                      None if active is None else active[j], eval_fn,
                      eval_every)
            for key in keys]))
    return cells


def _advance_body(carries, scheduler, energy, faults, active, p, *,
                  sim: ClientSimulator, num_steps: int, spec):
    """Advance a group's (S, R) carries ``num_steps`` rounds, each member
    and seed in turn through :meth:`ClientSimulator.run_carry` — the
    chunked twin of :func:`_group_body`. ``carries`` is a list (members)
    of lists (seeds); returns the advanced carries and the chunk's
    histories in the same layout."""
    out, hists = [], []
    for j, row in enumerate(carries):
        crow, hrow = [], []
        for carry in row:
            carry, hist = sim.run_carry(
                carry, num_steps, scheduler=scheduler[j], energy=energy[j],
                faults=faults[j], p=None if p is None else p[j],
                active_mask=None if active is None else active[j], spec=spec)
            crow.append(carry)
            hrow.append(hist)
        out.append(crow)
        hists.append(hrow)
    return out, hists


class _Runner:
    """A group or chunk body behind the runner protocol (module
    docstring): it calls ``on_trace`` on the first run of each batch
    signature — the group key, raggedness, S cells, R seeds and N_cap,
    what makes the JAX package's jit trace again — and never again for
    that signature.

    Nothing is compiled: the first run of a signature on the card pays
    only what any first run pays there, the caching allocator growing
    to the batch's working set and cuDNN choosing its convolution
    algorithms for new shapes. ``cache_size()`` is the number of
    signatures run, the counterpart of a jit wrapper's cache entries.
    Thread-safe: competing flushers may share a runner.
    """

    def __init__(self, body, n_cap: int, on_trace=None):
        self._body = body
        self._n_cap = int(n_cap)
        self._on_trace = on_trace
        self._seen: set = set()
        self._lock = threading.Lock()

    def _note(self, scheduler, energy, faults, active, n_seeds: int) -> None:
        sig = (_group_key(scheduler[0], energy[0], faults[0]),
               active is not None, len(scheduler), int(n_seeds), self._n_cap)
        with self._lock:
            new = sig not in self._seen
            self._seen.add(sig)
        if new and self._on_trace is not None:
            self._on_trace()

    def cache_size(self) -> int:
        with self._lock:
            return len(self._seen)


class _GroupRunner(_Runner):
    def __call__(self, scheduler, energy, faults, active, p, params0, keys):
        self._note(scheduler, energy, faults, active, len(keys))
        return self._body(scheduler, energy, faults, active, p, params0, keys)


class _ChunkRunner(_Runner):
    def __call__(self, carries, scheduler, energy, faults, active, p):
        self._note(scheduler, energy, faults, active, len(carries[0]))
        return self._body(carries, scheduler, energy, faults, active, p)


def make_group_runner(*, sim: ClientSimulator, num_steps: int, eval_fn=None,
                      eval_every: int = 0, on_trace=None):
    """A fresh runner of :func:`_group_body`, called as
    ``runner(scheduler, energy, faults, active, p, params0, keys)`` with
    a :class:`StructureGroup`'s per-member lists; returns one uncropped
    CellResult a member.

    Each runner owns its record of signatures, so dropping it (LRU
    eviction from :class:`repro_torch.serve.ExecutableCache`) forgets
    them; ``on_trace`` is called on the first run of each new batch
    signature (:class:`_Runner`), which is how the serve layer counts
    compiles as the JAX package does.
    """
    return _GroupRunner(
        lambda *a: _group_body(*a, sim=sim, num_steps=num_steps,
                               eval_fn=eval_fn, eval_every=eval_every),
        sim.p.shape[0], on_trace)


def make_chunk_runner(*, sim: ClientSimulator, chunk: int, spec,
                      on_trace=None):
    """A fresh runner of :func:`_advance_body` — the chunked twin of
    :func:`make_group_runner`, called as ``runner(carries, scheduler,
    energy, faults, active, p)``.

    The serve layer's :class:`repro_torch.serve.ExecutableCache`
    memoizes one per (structure, chunk length, config); a warm resume —
    the same structure advancing through the same chunk length — runs a
    signature its runner has run before: zero new compiles.
    """
    return _ChunkRunner(
        lambda *a: _advance_body(*a, sim=sim, num_steps=chunk, spec=spec),
        sim.p.shape[0], on_trace)


def structure_fingerprint(group_key) -> str:
    """Short stable digest of a :func:`_group_key` signature — the
    cache-key / response-visible name of one component structure. It
    hashes the port's own key, so it need not equal the JAX package's
    digest (whose key holds treedefs); no file or directory name
    depends on it."""
    return hashlib.sha256(str(group_key).encode()).hexdigest()[:12]


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

    ``executable_cache`` (DESIGN.md §11) is a caller-owned keyed store
    of runners: each structure group then runs through
    ``executable_cache.group_runner((group_key, ragged), sim=...,
    num_steps=..., eval_fn=..., eval_every=...)``, a
    :func:`make_group_runner` the cache may memoize, bound and evict.
    The runner runs the uncached path's code, so the results are the
    same bits; the cache only counts (module docstring).

    ``mesh`` (a :class:`repro_torch.experiments.placement.Mesh` of more
    than one rank) runs each group through
    :func:`~repro_torch.experiments.placement.run_group_sharded`: cells
    split over the cell rows, bitwise the one-rank run; a ``clients``
    axis splits each cell's population over its row's ranks,
    ``client_reduction`` selecting the aggregation — ``"psum"``
    (default, f32 tolerance), ``"gather"`` (bitwise), ``"fused[_bf16]"``
    or ``"psum_bf16"`` (DESIGN.md §9). Every rank gets every cell's
    result. A one-rank mesh takes the unsharded path, bit for bit.
    ``degrade=True`` arms the ladder (module docstring). The executable
    cache serves the unsharded path only.

    Returns ``{scenario.name: CellResult}`` in input order.
    """
    if mesh is not None:
        from repro_torch.experiments import placement

        if not isinstance(mesh, placement.Mesh):
            raise TypeError(
                f"mesh must be a repro_torch.experiments.placement.Mesh "
                f"(make_cell_mesh / make_client_mesh / make_grid_mesh), "
                f"got {type(mesh).__name__}")
    scenarios = list(scenarios)
    del _LAST_DOWNGRADES[:]
    names = check_unique_names(scenarios)
    n_cap = int(sim.p.shape[0])
    _check_capacity(scenarios, n_cap)
    _, keys = _seed_keys(seeds, sim.device)

    if sequential:
        if mesh is not None:
            raise ValueError("sequential execution does not take a mesh")
        results = {}
        for sc in scenarios:
            scheduler, energy = sc.build()
            faults = sc.build_faults()
            active, p_cell = None, None
            if sc.n_clients != n_cap:
                scheduler, energy, faults = _pad_built(
                    (scheduler, energy, faults), n_cap)
                active, p_cell = _cell_mask_p(sc, sim, n_cap)
            per_seed = [_run_cell(sim, key, params0, num_steps, scheduler,
                                  energy, faults, p_cell, active, eval_fn,
                                  eval_every)
                        for key in keys]
            results[sc.name] = _finish(_stack_seeds(per_seed), sc.n_clients,
                                       n_cap)
        return results

    sharded = mesh is not None and mesh.size > 1
    _, _, groups = resolve_structure_groups(scenarios, sim=sim)
    results: list[CellResult | None] = [None] * len(scenarios)
    for grp in groups:
        args = (grp.scheduler, grp.energy, grp.faults, grp.active, grp.p,
                params0, keys)

        def run_one_rank(args=args, grp=grp):
            if executable_cache is not None:
                runner = executable_cache.group_runner(
                    (grp.key, grp.ragged), sim=sim, num_steps=num_steps,
                    eval_fn=eval_fn, eval_every=eval_every)
                return runner(*args)
            return _group_body(*args, sim=sim, num_steps=num_steps,
                               eval_fn=eval_fn, eval_every=eval_every)

        if sharded:
            members = [names[i] for i in grp.members]
            reduction = client_reduction
            while True:
                try:
                    cells = placement.run_group_sharded(
                        grp.scheduler, grp.energy, grp.active, grp.p,
                        params0, keys, sim=sim, num_steps=num_steps,
                        n_scenarios=len(grp.members), mesh=mesh,
                        faults=grp.faults, eval_fn=eval_fn,
                        eval_every=eval_every, reduction=reduction)
                    break
                except ValueError as e:
                    if not degrade:
                        raise
                    lower = _REDUCTION_LADDER.get(reduction, ())
                    if lower:
                        _record_downgrade(members, "reduction", reduction,
                                          lower[0], e)
                        reduction = lower[0]
                        continue
                    _record_downgrade(members, "placement", "sharded",
                                      "one rank", e)
                    cells = run_one_rank()
                    break
        else:
            cells = run_one_rank()
        for idx, cell in zip(grp.members, cells):
            results[idx] = _finish(cell, scenarios[idx].n_clients, n_cap)
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
    and ``device`` (None: the card). ``mesh`` places the cells across
    ranks (:func:`execute_cells`).

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


# --------------------------------------------- preemption-safe execution

#: Manifest schema tag — bump on incompatible layout changes.
MANIFEST_FORMAT = "study-manifest/v1"


def _leaf_bytes(leaf) -> tuple[str, bytes]:
    """(str((shape, dtype name)), raw bytes) of one ``params0`` leaf, as
    the JAX package reads them from a numpy array: a bf16 tensor as its
    16-bit patterns under the name ``bfloat16``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        name = arr.dtype.name
    return str((arr.shape, name)), np.ascontiguousarray(arr).tobytes()


def study_fingerprint(scenarios, num_steps, seed_list, params0) -> str:
    """Content hash binding a checkpoint directory to one exact study:
    canonical scenario specs + horizon + seeds + initial-parameter bytes,
    hashed as the JAX package hashes them, so the same study gives the
    same hex digest in both packages. Resume refuses a directory whose
    manifest fingerprint differs."""
    h = hashlib.sha256()
    for sc in scenarios:
        d = dataclasses.asdict(sc)
        if d.get("taus") is not None:
            d["taus"] = np.asarray(d["taus"]).tolist()
        h.update(json.dumps(d, sort_keys=True, default=repr).encode())
    h.update(json.dumps({"num_steps": int(num_steps),
                         "seeds": [int(s) for s in seed_list]}).encode())
    for leaf in tree_leaves(params0):
        meta, raw = _leaf_bytes(leaf)
        h.update(meta.encode())
        h.update(raw)
    return h.hexdigest()


def _history_template(n_scen, n_seeds, t, n_cap):
    """Shape/dtype template (numpy) of an (S, R, t) SimHistory chunk as
    saved in resumable checkpoints."""
    return SimHistory(
        loss=np.zeros((n_scen, n_seeds, t), np.float32),
        participation=np.zeros((n_scen, n_seeds, t, n_cap), np.float32),
        weight_sum=np.zeros((n_scen, n_seeds, t), np.float32),
        finite=np.zeros((n_scen, n_seeds, t), np.bool_))


def _pad_halted_history(history, num_steps: int):
    """Extend a halted group's (numpy) history to the full horizon: NaN
    metrics, ``finite=False`` — the quarantine tail (DESIGN.md §10)."""
    done = int(history.loss.shape[2])
    pad = num_steps - done
    if pad <= 0:
        return history

    def ext(x, value):
        shape = x.shape[:2] + (pad,) + x.shape[3:]
        return np.concatenate([x, np.full(shape, value, x.dtype)], axis=2)

    return SimHistory(loss=ext(history.loss, np.nan),
                      participation=ext(history.participation, np.nan),
                      weight_sum=ext(history.weight_sum, np.nan),
                      finite=ext(history.finite, False))


def _stack2(trees):
    """A list (scenarios) of lists (seeds) of same-structure trees → one
    tree of (S, R, …) leaves."""
    return tree_map(lambda *xs: torch.stack(xs),
                    *[tree_map(lambda *ys: torch.stack(ys), *row)
                      for row in trees])


def _advance_resumable_group(
    grp: StructureGroup, *, gid: str, sim: ClientSimulator, spec, params0,
    keys, num_steps: int, checkpoint_every: int, checkpoint_dir: str,
    keep: int, manifest: dict, manifest_path: str, halt_on_divergence: bool,
    executable_cache=None, progress=None,
) -> list[CellResult]:
    """Advance ONE structure group to the horizon, checkpointed.

    Restore the group's newest complete checkpoint (or init fresh),
    advance each member cell and seed in turn ``checkpoint_every`` steps
    at a time through :meth:`ClientSimulator.run_carry`
    (:func:`_advance_body`), and after every chunk write ``{carry,
    history}`` — the group's carries and history stacked into (S, R, …)
    arrays — plus the study manifest. ``executable_cache`` routes each
    chunk through a memoized :func:`make_chunk_runner` (a warm resume
    adds no compile). ``progress(gid, step, num_steps)`` fires once
    after restore/init and once per completed chunk. Returns one
    uncropped :class:`CellResult` per member.
    """
    n_cap = int(sim.p.shape[0])
    n_scen, n_seeds = len(grp.members), len(keys)
    mgr = CheckpointManager(os.path.join(checkpoint_dir, gid), keep=keep)
    # Fresh carries: the start of a new group, and the restore template.
    carries = [[sim.init(key, params0, scheduler=grp.scheduler[j],
                         energy=grp.energy[j], faults=grp.faults[j],
                         spec=spec)
                for key in keys] for j in range(n_scen)]
    step = latest_step(mgr.directory)
    halted = manifest["groups"][gid]["halted"]
    history = None
    if step is None:
        step, halted = 0, False
    else:
        tpl = {"carry": _stack2(carries),
               "history": _history_template(n_scen, n_seeds, step, n_cap)}
        state, step = mgr.restore(tpl, step)
        history = state["history"]
        carries = [[tree_map(lambda x: x[j, r], state["carry"])
                    for r in range(n_seeds)] for j in range(n_scen)]
    if progress is not None:
        progress(gid, step, num_steps)

    while step < num_steps and not halted:
        chunk = min(checkpoint_every, num_steps - step)
        args = (carries, grp.scheduler, grp.energy, grp.faults, grp.active,
                grp.p)
        if executable_cache is not None:
            runner = executable_cache.chunk_runner(
                (grp.key, grp.ragged, chunk), sim=sim, chunk=chunk, spec=spec)
            carries, hists = runner(*args)
        else:
            carries, hists = _advance_body(*args, sim=sim, num_steps=chunk,
                                           spec=spec)
        hist = SimHistory(*map(host, _stack2(hists)))
        history = hist if history is None else SimHistory(*(
            np.concatenate([a, b], axis=2) for a, b in zip(history, hist)))
        step += chunk
        if halt_on_divergence and not history.finite[..., -1].any():
            halted = True
        mgr.save(step, {"carry": _stack2(carries), "history": history})
        manifest["groups"][gid]["step"] = step
        manifest["groups"][gid]["halted"] = bool(halted)
        write_json_atomic(manifest_path, manifest)
        if progress is not None:
            progress(gid, step, num_steps)

    if history is None:  # num_steps == 0 degenerate study
        history = _history_template(n_scen, n_seeds, 0, n_cap)
    if halted:
        history = _pad_halted_history(history, num_steps)
    cells = []
    for j in range(n_scen):
        # A legacy carry (spec None) holds the params tree itself.
        params = tree_map(lambda *xs: torch.stack(xs), *[
            c.params if spec is None
            else aggregation.unravel_pytree(c.params, spec)
            for c in carries[j]])
        cells.append(CellResult(
            params=params, history=SimHistory(*(
                torch.from_numpy(np.ascontiguousarray(x[j])).to(sim.device)
                for x in history)), evals=None))
    return cells


def execute_cells_resumable(
    scenarios: Sequence[Scenario],
    *,
    sim: ClientSimulator,
    params0,
    num_steps: int,
    seeds: int | Sequence[int] = 8,
    checkpoint_dir: str,
    checkpoint_every: int = 0,
    keep: int = 3,
    halt_on_divergence: bool = False,
    executable_cache=None,
    progress=None,
) -> dict[str, CellResult]:
    """Preemption-safe :func:`execute_cells`: chunked runs + checkpoints.

    Execution proceeds structure group by structure group (the grouping
    of :func:`execute_cells`, :func:`resolve_structure_groups`), each
    group advancing in ``checkpoint_every``-step chunks (0: one chunk);
    after every chunk the group's ``{carry, history}`` tree is written
    atomically under ``checkpoint_dir/<gid>/step_<t>.npz`` and the study
    manifest (``manifest.json``) is rewritten. Because each chunk is a
    function of the carry alone, a run killed at *any* point — including
    mid-write, by ``kill -9`` — resumes from the directory with results
    **bitwise identical** to the uninterrupted run and to
    :func:`execute_cells`: finished groups restore their final
    checkpoint without re-running, the group in flight restores its
    newest complete checkpoint and runs only the tail.

    The manifest binds the directory to one exact study via
    :func:`study_fingerprint`; resuming with anything changed raises.
    Layout, the JAX package's::

        {"format": "study-manifest/v1", "fingerprint": "<sha256>",
         "num_steps": T, "checkpoint_every": K,
         "groups": {"g000": {"members": [...], "step": t,
                             "halted": false}, ...}}

    ``halt_on_divergence=True`` stops advancing a group once **every**
    (scenario, seed) run has gone non-finite (divergence is absorbing);
    the unrun tail is reported as NaN metrics with ``finite=False``.
    Eval hooks are not taken on this path.

    ``executable_cache`` (DESIGN.md §12) memoizes one
    :func:`make_chunk_runner` per (structure, chunk length) — the serve
    layer binds its keyed :class:`repro_torch.serve.ExecutableCache`
    here, so repeat resumable traffic, a warm resume after an
    interruption included, adds zero new compiles.
    ``progress(gid, step, num_steps)`` reports per-chunk advancement.
    """
    scenarios = list(scenarios)
    del _LAST_DOWNGRADES[:]  # no ladder here, but keep the report current
    seed_list, keys = _seed_keys(seeds, sim.device)
    num_steps = int(num_steps)
    if checkpoint_every <= 0:
        checkpoint_every = num_steps

    names, n_cap, groups = resolve_structure_groups(scenarios, sim=sim)
    spec = sim.flat_spec(params0)
    gids = [f"g{g:03d}" for g in range(len(groups))]

    manifest_path = os.path.join(checkpoint_dir, "manifest.json")
    fingerprint = study_fingerprint(scenarios, num_steps, seed_list, params0)
    manifest = {
        "format": MANIFEST_FORMAT,
        "fingerprint": fingerprint,
        "num_steps": num_steps,
        "checkpoint_every": int(checkpoint_every),
        "groups": {gid: {"members": [names[i] for i in grp.members],
                         "step": 0, "halted": False}
                   for gid, grp in zip(gids, groups)},
    }
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            prev = json.load(f)
        if prev.get("format") != MANIFEST_FORMAT:
            raise ValueError(
                f"{manifest_path}: unknown manifest format "
                f"{prev.get('format')!r} (want {MANIFEST_FORMAT})")
        if prev.get("fingerprint") != fingerprint:
            raise ValueError(
                f"{manifest_path} belongs to a different study "
                f"(fingerprint mismatch) — refusing to resume; use a "
                f"fresh checkpoint_dir or delete the stale one")
        for gid in gids:
            got = prev["groups"].get(gid, {})
            manifest["groups"][gid]["halted"] = bool(got.get("halted", False))
    else:
        write_json_atomic(manifest_path, manifest)

    results: list[CellResult | None] = [None] * len(scenarios)
    for gid, grp in zip(gids, groups):
        cells = _advance_resumable_group(
            grp, gid=gid, sim=sim, spec=spec, params0=params0, keys=keys,
            num_steps=num_steps, checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir, keep=keep, manifest=manifest,
            manifest_path=manifest_path,
            halt_on_divergence=halt_on_divergence,
            executable_cache=executable_cache, progress=progress)
        for idx, cell in zip(grp.members, cells):
            cell = _crop_cell(cell, scenarios[idx].n_clients, n_cap)
            results[idx] = _attach_divergence(cell)
    return dict(zip(names, results))


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
