"""Placement layer: studies sharded across ranks (DESIGN.md §5, §8, §13).

Port of ``repro.experiments.placement``. A JAX ``Mesh`` is a grid of
devices inside one SPMD program; the port's :class:`Mesh` is a grid of
**ranks** of the default ``torch.distributed`` process group, one device
a rank. Every rank runs the same host code (multi-controller, as JAX
does under ``jax.distributed``), and ``torch.distributed`` collectives
take the place of ``shard_map``'s. Two composable axes:

**Cell axis** (``"cells"``, DESIGN.md §5): the (scenario S × seed R)
cells of a structure group are **flattened** into one cell axis C = S·R
(cell ``c = s·R + r``, :func:`flatten_cells`) and split over the cell
rows of the mesh, as evenly as they go (row sizes differ by at most one;
the JAX package pads to a divisible count instead, :func:`pad_cells`).
Each rank runs the cells of its row in turn, exactly as
:func:`repro_torch.experiments.engine.execute_cells` runs them on one
device, so a cells-axis run is **bitwise** the one-rank run. No padded
lane exists, so none can reach a result.

**Client axis** (``"clients"``, DESIGN.md §8): within a cell, every
per-client operand — the component fields whose leading dimension is
the population capacity (:func:`client_leaf_specs`), ``p`` and
``active_mask``, the scheduler and energy *state*, the ``(N, P)``
gradient buffer — is split over the ranks of the cell row, and params
and optimizer state stay **replicated**. The step's one collective runs
on the row's process group (the reduction modes of
:func:`repro_torch.core.aggregation.parse_reduction`), and per-client
draws fold in the *global* client index
(:func:`repro_torch.core.energy.client_sharding`).

The axes compose: ``make_grid_mesh(cells=2, clients=2)`` runs two cell
rows, each cell's population split over the two ranks of its row.

After a group has run, every rank holds every cell's result: the rank
at client coordinate 0 of each row publishes its cells and all ranks
gather them (:func:`_gather_cells`). :func:`replicate_to_mesh` is then a
no-op lift (every rank built the same inputs) and :func:`fetch_to_host`
a host copy.

Building a mesh is collective: it makes one process group a cell row
(``torch.distributed.new_group``), so every rank must build the same
meshes in the same order. Meshes are cached by layout, so building one
again reuses its groups. Without an initialized process group the world
is this one process, and every factory gives a one-rank mesh, which the
engine runs as if no mesh were given.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tree import tree_map
from repro_torch.core.aggregation import parse_reduction
from repro_torch.core.energy import client_sharding
from repro_torch.core.scheduling import shard_scheduler
from repro_torch.core.trainer import FAULTS_UNDER_CLIENTS, FUSED_NEEDS_SGD

#: Default mesh-axis name for the flattened (scenario × seed) cell axis.
CELL_AXIS = "cells"

#: Mesh-axis name for within-cell client sharding. Unlike the cell axis
#: (any single-axis name works), the client axis is recognized by this
#: name.
CLIENT_AXIS = "clients"


def _world() -> tuple[int, int]:
    """(world size, this rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


_HOSTS: list[str] = []


def rank_hosts() -> list[str]:
    """The host name of every rank, in rank order. The first call after
    the process group starts is collective (an all-gather of the names);
    :func:`repro_torch.launch.distributed.initialize` makes it."""
    size, _ = _world()
    if len(_HOSTS) != size:
        names = [socket.gethostname()]
        if size > 1:
            names = [None] * size
            dist.all_gather_object(names, socket.gethostname())
        _HOSTS[:] = names
    return list(_HOSTS)


def device_topology(ranks=None) -> str:
    """``"N global rank(s) across K host(s)"`` — the phrase every mesh
    shape error uses, so a multi-process failure never conflates a host's
    ranks with the world's."""
    hosts = rank_hosts()
    ranks = range(len(hosts)) if ranks is None else list(np.ravel(ranks))
    return (f"{len(ranks)} global rank(s) across "
            f"{max(len({hosts[r] for r in ranks}), 1)} host(s)")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of ranks with named axes.

    axis_names : ``("cells",)``, ``("clients",)`` or ``("cells",
        "clients")`` for the placement layer (any names for a mesh built
        by hand).
    ranks : the grid of global ranks, one device a rank.
    coords : this rank's coordinates in ``ranks``, None when it is not in
        the mesh.
    groups : one process group a cell row (the ranks along the last
        axis) when the mesh has a ``clients`` axis and more than one
        rank along it, else None for that row.
    """

    axis_names: tuple
    ranks: np.ndarray
    coords: tuple | None = None
    groups: tuple = ()

    @property
    def shape(self) -> OrderedDict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return OrderedDict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)


_MESHES: dict = {}
_MESH_LOCK = threading.Lock()


def _make_mesh(grid, axis_names) -> Mesh:
    """The mesh over ``grid`` (an array of ranks), cached by layout. Its
    row groups are made here, by every rank in the same order."""
    grid = np.asarray(grid, dtype=np.int64)
    axis_names = tuple(axis_names)
    size, rank = _world()
    key = (axis_names, grid.shape, grid.tobytes(), size)
    with _MESH_LOCK:
        mesh = _MESHES.get(key)
        if mesh is not None:
            return mesh
        if grid.size and (grid.min() < 0 or grid.max() >= size):
            raise ValueError(
                f"mesh ranks {grid.ravel().tolist()} outside the world — "
                f"have {device_topology()}")
        hit = np.argwhere(grid == rank)
        coords = tuple(int(i) for i in hit[0]) if len(hit) else None
        groups = ()
        if CLIENT_AXIS in axis_names and grid.ndim >= 1:
            rows = grid.reshape(-1, grid.shape[-1])
            groups = tuple(
                dist.new_group(ranks=[int(r) for r in row])
                if len(row) > 1 else None for row in rows)
        mesh = Mesh(axis_names, grid, coords, groups)
        _MESHES[key] = mesh
        return mesh


def mesh_process_count(mesh: Mesh) -> int:
    """Number of distinct processes (ranks) in the mesh: > 1 means its
    runs cross process boundaries (DESIGN.md §13)."""
    return len(set(mesh.ranks.ravel().tolist()))


def _rank_slice(n_devices: int | None, ranks=None) -> list[int]:
    """The first ``n_devices`` of ``ranks`` (default: every rank of the
    world). ``ranks=`` pins a layout by hand."""
    ranks = list(range(_world()[0])) if ranks is None \
        else [int(r) for r in np.ravel(ranks)]
    if n_devices is not None:
        if not 1 <= n_devices <= len(ranks):
            raise ValueError(
                f"n_devices={n_devices} outside [1, {len(ranks)}] — "
                f"have {device_topology(ranks)}")
        ranks = ranks[:n_devices]
    return ranks


def make_cell_mesh(n_devices: int | None = None, *,
                   axis_name: str = CELL_AXIS, ranks=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` (default: all) ranks;
    ``ranks=`` pins an explicit layout. The cell axis has no per-step
    collective, so any layout serves."""
    return _make_mesh(_rank_slice(n_devices, ranks), (axis_name,))


def make_client_mesh(n_devices: int | None = None, *, ranks=None) -> Mesh:
    """1-D ``("clients",)`` mesh: within-cell client-axis sharding only
    (DESIGN.md §8). The population capacity must divide the mesh size.
    The default spans every rank of every host: the only per-step
    collective crossing them is the ``(P,)`` reduction."""
    return _make_mesh(_rank_slice(n_devices, ranks), (CLIENT_AXIS,))


def make_grid_mesh(cells: int, clients: int, *, ranks=None) -> Mesh:
    """2-D ``(cells, clients)`` mesh over the first ``cells·clients``
    ranks: cell rows across the first axis, each cell's population split
    over the ranks of its row."""
    pool = list(range(_world()[0])) if ranks is None \
        else [int(r) for r in np.ravel(ranks)]
    if cells * clients > len(pool):
        raise ValueError(
            f"make_grid_mesh(cells={cells}, clients={clients}) needs "
            f"{cells * clients} global ranks, have {device_topology(pool)}")
    grid = np.array(_rank_slice(cells * clients, pool)).reshape(cells, clients)
    return _make_mesh(grid, (CELL_AXIS, CLIENT_AXIS))


def _ranks_by_host() -> list[list[int]]:
    """The world's ranks grouped by host, both in first-seen order."""
    by_host: dict[str, list[int]] = {}
    for rank, host in enumerate(rank_hosts()):
        by_host.setdefault(host, []).append(rank)
    return list(by_host.values())


def make_multihost_mesh(cells: int | None = None,
                        clients: int | None = None) -> Mesh:
    """2-D ``(cells, clients)`` mesh with the **cell axis crossing
    hosts** and every client row inside one host (DESIGN.md §13): the
    within-cell reduction never leaves a host, and the cell axis, which
    crosses hosts, has no per-step collective.

    Defaults: ``cells`` = the host count, ``clients`` = the ranks each
    cell row can use on its host. One host degenerates to a
    :func:`make_grid_mesh` layout, so the same driver runs anywhere.
    """
    grid = _ranks_by_host()
    n_hosts, local = len(grid), min(len(g) for g in grid)
    cells = n_hosts if cells is None else int(cells)
    if cells % n_hosts != 0:
        raise ValueError(
            f"make_multihost_mesh(cells={cells}): the cell axis must "
            f"divide evenly over hosts — have {device_topology()}")
    rows_per_host = cells // n_hosts
    width = local // rows_per_host if clients is None else int(clients)
    if width < 1 or rows_per_host * width > local:
        raise ValueError(
            f"make_multihost_mesh(cells={cells}, clients={clients}) needs "
            f"{rows_per_host}×{width} ranks per host, have {local} — "
            f"{device_topology()}")
    rows = [g[r * width:(r + 1) * width]
            for g in grid for r in range(rows_per_host)]
    return _make_mesh(np.array(rows), (CELL_AXIS, CLIENT_AXIS))


def _mesh_axes(mesh: Mesh) -> tuple[str | None, str | None]:
    """(cell_axis, client_axis) names of a grid mesh, either possibly
    None. A 1-D mesh's axis is the cell axis unless it is named
    ``"clients"``; a 2-D mesh must be (cell_axis, "clients")."""
    names = tuple(mesh.axis_names)
    if len(names) == 1:
        if names[0] == CLIENT_AXIS:
            return None, CLIENT_AXIS
        return names[0], None
    if len(names) == 2 and names[1] == CLIENT_AXIS \
            and names[0] != CLIENT_AXIS:
        return names[0], CLIENT_AXIS
    raise ValueError(
        "grid sharding needs a 1-D mesh (the flattened cell axis, or a "
        f"'{CLIENT_AXIS}' axis for within-cell sharding) or a 2-D "
        f"(cells, '{CLIENT_AXIS}') mesh; got axes {names} — build one "
        "with make_cell_mesh() / make_client_mesh() / make_grid_mesh()")


def _check_client_shards(n_cap: int, shards: int) -> int:
    if n_cap % shards != 0:
        raise ValueError(
            f"client-axis sharding needs the population capacity to divide "
            f"the '{CLIENT_AXIS}' mesh axis: N_cap={n_cap} over {shards} "
            f"shards (pad the population to a multiple — DESIGN.md §8)")
    return n_cap // shards


def client_leaf_specs(component, n_cap: int, *,
                      client_axis: str = CLIENT_AXIS) -> list:
    """The leaf-shape rule as the port's per-leaf row split:
    ``[(field, axis or None), ...]`` over ``component``'s tensor fields,
    in field order. A field whose first axis has the population capacity
    ``n_cap`` is per-client and split over ``client_axis`` (its rows
    ``index·n_local …`` go to the rank at ``index``); every other field
    (scalar hyperparameters, tables of another length) is replicated.

    The rule is shape-based: a hyperparameter vector that has length
    ``n_cap`` by coincidence would be split too, so a component with
    such a field must not run client-sharded (no built-in has one).
    """
    if component is None:
        return []
    out = []
    for f in dataclasses.fields(component):
        leaf = getattr(component, f.name)
        if isinstance(leaf, torch.Tensor):
            split = leaf.dim() > 0 and leaf.shape[0] == n_cap
            out.append((f.name, client_axis if split else None))
    return out


def _shard_fields(component, n_cap: int, rows: slice):
    """``component`` with each field the leaf rule splits cut to
    ``rows``."""
    cut = {name: getattr(component, name)[rows]
           for name, axis in client_leaf_specs(component, n_cap) if axis}
    return dataclasses.replace(component, **cut) if cut else component


def _repeat(x, r: int):
    """Each entry of a cell-axis sequence (list or tensor) ``r`` times."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return torch.repeat_interleave(x, r, dim=0)
    return [e for e in x for _ in range(r)]


def flatten_cells(scheduler, energy, keys, *, n_scenarios: int,
                  active=None, p=None, faults=None):
    """(S per-member components, R keys) → C = S·R flat cells.

    Cell ``c = s·R + r`` pairs scenario ``s`` with seed ``r``, so a list
    of cell results regroups as ``[s·R + r]``. ``scheduler`` / ``energy``
    / ``faults`` are per-member lists (a ``StructureGroup``'s), repeated
    over the seeds; ``active`` / ``p`` the optional per-member lists or
    (S, N_cap) tensors of a ragged group, repeated likewise; ``keys`` a
    list of R keys or an (R, 2) tensor, tiled over the scenarios. None
    passes through.
    """
    r = len(keys)
    keys_c = (keys.repeat(n_scenarios, 1) if isinstance(keys, torch.Tensor)
              else list(keys) * n_scenarios)
    return (_repeat(scheduler, r), _repeat(energy, r), _repeat(faults, r),
            _repeat(active, r), _repeat(p, r), keys_c)


def pad_cells(tree, n_cells: int, n_devices: int):
    """Pad the leading cell axis of every cell-axis sequence (list or
    tensor; tuples and dicts of them are walked) to a multiple of
    ``n_devices`` by repeating cell 0; returns the padded tree and the
    padded count. The port's runners split cells unevenly instead and
    never pad; this is the JAX package's layout rule, kept for callers
    that want a divisible axis."""
    pad = (-n_cells) % n_devices
    if pad == 0:
        return tree, n_cells

    def _pad(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])
        if isinstance(x, dict):
            return {k: _pad(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(_pad(v) for v in x)
        return list(x) + [x[0]] * pad

    return _pad(tree), n_cells + pad


def _gather_cells(mine: dict, publish: bool, device) -> dict:
    """Every rank's published cells, on every rank: ``{c: result}``. The
    ranks at client coordinate 0 publish; the results travel as host
    tensors (exact) and land on ``device``. A rank keeps its own."""
    size, _ = _world()
    if size == 1:
        return dict(mine)
    payload = {c: tree_map(lambda x: x.detach().cpu(), cell)
               for c, cell in mine.items()} if publish else {}
    parts = [None] * size
    dist.all_gather_object(parts, payload)
    out = {}
    for part in parts:
        for c, cell in part.items():
            out[c] = mine[c] if c in mine else tree_map(
                lambda x: x.to(device), cell)
    return out


class _ShardedRunner:
    """A sharded body with the port's compile count: the first run of a
    signature (simulator, steps, eval hook, mesh, reduction, group
    structure and batch) counts as one "compile", the run that makes the
    JAX package's jit trace its ``shard_map`` again. Nothing is
    compiled; ``_cache_size()`` is the number of signatures run on this
    rank, as a jit wrapper's cache entries are per process."""

    def __init__(self, body):
        self._body = body
        self._seen: set = set()
        self._lock = threading.Lock()

    def _cache_size(self) -> int:
        with self._lock:
            return len(self._seen)

    def clear_cache(self) -> None:
        with self._lock:
            self._seen.clear()

    def __call__(self, signature, *args, **kw):
        with self._lock:
            self._seen.add(signature)
        return self._body(*args, **kw)


def _run_cells(sim, mesh, reduction, cells, params0, num_steps, eval_fn,
               eval_every):
    """Run this rank's ``cells`` — ``{c: (key, scheduler, energy, faults,
    p, active)}`` — on ``mesh``; returns ``({c: CellResult}, publish)``.
    Under a clients axis each cell's per-client operands are cut to this
    rank's rows and the run is inside its :func:`client_sharding`
    context."""
    from repro_torch.experiments.engine import _run_cell

    cell_ax, client_ax = _mesh_axes(mesh)
    if mesh.coords is None:
        return {}, False
    if client_ax is None:
        return {c: _run_cell(sim, key, params0, num_steps, sch, en, flt, pw,
                             act, eval_fn, eval_every)
                for c, (key, sch, en, flt, pw, act) in cells.items()}, True
    n_cap = int(sim.p.shape[0])
    shards = mesh.shape[client_ax]
    n_local = _check_client_shards(n_cap, shards)
    row = mesh.coords[0] if cell_ax is not None else 0
    index = mesh.coords[-1]
    rows = slice(index * n_local, (index + 1) * n_local)
    out = {}
    with client_sharding(client_ax, shards, reduction, index=index,
                         group=mesh.groups[row]):
        for c, (key, sch, en, _, pw, act) in cells.items():
            sch = shard_scheduler(_shard_fields(sch, n_cap, rows), n_local)
            en = _shard_fields(en, n_cap, rows)
            pw = (sim.p if pw is None else pw)[rows]
            act = None if act is None else act[rows]
            out[c] = _run_cell(sim, key, params0, num_steps, sch, en, None,
                               pw, act, eval_fn, eval_every)
    return out, index == 0


def _check_sharded(sim, mesh, reduction, faults) -> tuple:
    """Every precondition of a sharded run, checked before any rank runs
    a step, so that all ranks raise the same error (a rank that raised
    mid-run would leave the others waiting in a collective)."""
    cell_ax, client_ax = _mesh_axes(mesh)
    size, _ = _world()
    if mesh.size and int(mesh.ranks.max()) >= size:
        raise ValueError(
            f"mesh ranks {mesh.ranks.ravel().tolist()} outside the world — "
            f"have {device_topology()}")
    if client_ax is not None:
        if any(f is not None for f in faults) or sim.faults is not None:
            raise ValueError(FAULTS_UNDER_CLIENTS)
        _check_client_shards(int(sim.p.shape[0]), mesh.shape[client_ax])
        mode, _ = parse_reduction(reduction)
        if mode == "fused" and getattr(sim.optimizer, "kind", "") != "sgd":
            raise ValueError(FUSED_NEEDS_SGD)
    return cell_ax, client_ax


def _group_body(scheduler, energy, faults, active, p, params0, keys, *,
                sim, num_steps, eval_fn, eval_every, mesh, reduction):
    from repro_torch.experiments.engine import _stack_seeds

    cell_ax, _ = _mesh_axes(mesh)
    n_scen, n_seeds = len(scheduler), len(keys)
    sch_c, en_c, flt_c, act_c, p_c, keys_c = flatten_cells(
        scheduler, energy, keys, n_scenarios=n_scen, active=active, p=p,
        faults=faults)
    n_rows = mesh.shape[cell_ax] if cell_ax is not None else 1
    split = np.array_split(np.arange(n_scen * n_seeds), n_rows)
    row = 0 if mesh.coords is None or cell_ax is None else mesh.coords[0]
    cells = {int(c): (keys_c[c], sch_c[c], en_c[c], flt_c[c],
                      None if p_c is None else p_c[c],
                      None if act_c is None else act_c[c])
             for c in split[row]}
    mine, publish = _run_cells(sim, mesh, reduction, cells, params0,
                               num_steps, eval_fn, eval_every)
    every = _gather_cells(mine, publish, sim.device)
    return [_stack_seeds([every[s * n_seeds + r] for r in range(n_seeds)])
            for s in range(n_scen)]


#: The sharded twin of ``engine._group_body``; ``_run_group_sharded.
#: _cache_size()`` counts its compiles on this rank.
_run_group_sharded = _ShardedRunner(_group_body)


def _cell_body(scheduler, energy, active, p, params0, key, *, sim,
               num_steps, eval_fn, eval_every, mesh, reduction):
    mine, publish = _run_cells(
        sim, mesh, reduction, {0: (key, scheduler, energy, None, p, active)},
        params0, num_steps, eval_fn, eval_every)
    return _gather_cells(mine, publish, sim.device)[0]


#: Single-cell client-sharded execution: one population over the whole
#: ``clients`` mesh (no cell axis).
_run_cell_client_sharded = _ShardedRunner(_cell_body)


def clear_cache() -> None:
    """Forget the sharded runners' signatures (see engine.clear_cache)."""
    _run_group_sharded.clear_cache()
    _run_cell_client_sharded.clear_cache()


# ------------------------------------------- multi-process host boundary

def replicate_to_mesh(tree, mesh: Mesh):
    """The JAX package lifts host arrays to replicated global arrays
    here. Every rank of the port computes the identical host-side grid
    (same scenarios, same PRNG keys) and holds its inputs whole, so the
    lift is the identity."""
    del mesh
    return tree


def fetch_to_host(tree):
    """Results as numpy on every rank. The sharded runners already
    assemble every cell on every rank (:func:`_gather_cells`), so this
    is a host copy of each tensor."""
    from repro_torch.experiments.results import host

    return tree_map(host, tree)


def run_client_sharded(sim, key, params0, num_steps: int, *, scheduler=None,
                       energy=None, mesh: Mesh, p=None, active_mask=None,
                       eval_fn=None, eval_every: int = 0,
                       reduction: str = "psum"):
    """Run ONE cell with its client axis split over ``mesh``'s ranks.

    The within-cell entry point (DESIGN.md §8) for populations one
    device cannot hold: arrivals and battery state, scheduler rows,
    ``active_mask`` / ``p`` and the ``(N, P)`` gradient buffer live
    split over the ``clients`` axis; params and optimizer state are
    replicated. Same contract as :meth:`ClientSimulator.run`: returns
    ``(params, history[, evals])`` on every rank, the participation
    history at full width. ``reduction`` is ``"psum"`` (default: one
    ``(P,)`` all-reduce a step, f32 reassociation tolerance), ``"gather"``
    (bit for bit the one-rank run), ``"fused[_bf16]"`` (K2's delta form
    and the update in one launch) or ``"psum_bf16"``. The capacity
    ``len(sim.p)`` must divide the client-axis size.
    """
    cell_ax, client_ax = _mesh_axes(mesh)
    if client_ax is None:
        raise ValueError(
            f"run_client_sharded needs a mesh with a '{CLIENT_AXIS}' axis; "
            f"got axes {mesh.axis_names}")
    if cell_ax is not None and mesh.shape[cell_ax] != 1:
        raise ValueError(
            "run_client_sharded executes a single cell — the mesh's cell "
            f"axis must have size 1, got {mesh.shape[cell_ax]}")
    scheduler = sim.scheduler if scheduler is None else scheduler
    energy = sim.energy if energy is None else energy
    if scheduler is None or energy is None:
        raise ValueError("scheduler/energy must be given (or set on sim)")
    _check_sharded(sim, mesh, reduction, ())
    from repro_torch.experiments.engine import _group_key

    sig = (sim, int(num_steps), eval_fn, eval_every, mesh, reduction,
           _group_key(scheduler, energy), active_mask is not None)
    cell = _run_cell_client_sharded(
        sig, scheduler, energy, active_mask, p, params0, key, sim=sim,
        num_steps=num_steps, eval_fn=eval_fn, eval_every=eval_every,
        mesh=mesh, reduction=reduction)
    if eval_fn is None:
        return cell.params, cell.history
    return cell.params, cell.history, cell.evals


def run_group_sharded(scheduler, energy, active, p, params0, keys, *, sim,
                      num_steps: int, n_scenarios: int, mesh: Mesh,
                      faults=None, eval_fn=None, eval_every: int = 0,
                      reduction: str = "psum"):
    """Execute one structure group's (S × R) cells across ``mesh``.

    ``scheduler`` / ``energy`` / ``faults`` are the group's per-member
    lists, ``active`` / ``p`` its per-member ragged operands (None for a
    uniform group), ``keys`` one key a seed. Flatten → split over the
    cell rows → each rank runs its row's cells (client-sharded when the
    mesh has a ``clients`` axis) → every cell gathered on every rank.
    Returns one uncropped CellResult a member, its leaves stacked along
    the seed axis R, as ``engine._group_body`` does.

    A cells-only mesh gives each cell the bits of its one-rank run; a
    ``clients`` axis adds ``reduction``'s contract (``gather`` bitwise,
    ``psum`` / ``fused`` f32 tolerance, ``*_bf16`` bf16 tolerance).
    """
    faults = [None] * n_scenarios if faults is None else list(faults)
    _, client_ax = _check_sharded(sim, mesh, reduction, faults)
    from repro_torch.experiments.engine import _group_key

    sig = (sim, int(num_steps), eval_fn, eval_every, mesh,
           reduction if client_ax is not None else None,
           _group_key(scheduler[0], energy[0], faults[0]), active is not None,
           int(n_scenarios), len(keys), int(sim.p.shape[0]))
    return _run_group_sharded(
        sig, scheduler, energy, faults, active, p, params0, keys, sim=sim,
        num_steps=num_steps, eval_fn=eval_fn, eval_every=eval_every,
        mesh=mesh, reduction=reduction)
