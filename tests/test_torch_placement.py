"""Port parity for the placement layer in one process.

``repro_torch.experiments.placement`` against ``repro.experiments.
placement`` where the two can be set side by side without ranks:

- the mesh factories and axis resolution, and errors that name the
  topology (ranks and hosts, where the JAX package names devices and
  processes); the launcher's mesh module;
- ``flatten_cells`` and ``pad_cells`` bitwise: the same ragged grid's
  structure group flattened in both packages gives the same keys,
  masks, weights and component tables cell for cell;
- the leaf-shape rule against ``client_leaf_specs`` on every built-in
  scheduler and energy model (the same fields split);
- ``parse_reduction`` and ``_REDUCTION_LADDER`` equal to JAX's;
- ``shard_scheduler`` on every built-in, and a custom scheduler's own
  ``shard_clients``;
- a one-rank mesh bitwise the same as ``mesh=None``, with no sharded
  signature counted (JAX: ``test_one_device_mesh_takes_vmap_path``);
- the ``REPRO_DIST_*`` environment contract parsed as JAX parses it.

The runs across ranks are ``tests/test_torch_client_sharding.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro import _env as jenv
from repro import experiments as JE
from repro.core import ClientSimulator as JSim
from repro.core.energy import make_arrivals as j_arrivals
from repro.core.scheduling import make_scheduler as j_scheduler
from repro.core.scheduling import shard_scheduler as j_shard_scheduler
from repro.experiments import engine as jengine
from repro.experiments import placement as JP
from repro.optim import sgd as j_sgd
from repro_torch import _env as tenv
from repro_torch import experiments as TE
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves
from repro_torch.core import ClientSimulator as TSim
from repro_torch.core import aggregation as tagg
from repro_torch.core import convergence as tconv
from repro_torch.core.energy import make_arrivals as t_arrivals
from repro_torch.core.scheduling import make_scheduler as t_scheduler
from repro_torch.core.scheduling import scheduler_names
from repro_torch.core.scheduling import shard_scheduler as t_shard_scheduler
from repro_torch.experiments import engine as tengine
from repro_torch.experiments import placement as TP
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import sgd as t_sgd

N_CAP, DIM, T = 8, 5, 12
ARRIVALS = ("periodic", "binary", "uniform", "day_night")


# --------------------------------------------------------- mesh factories

def test_mesh_factories_and_axes():
    """One process is a world of one rank: every factory gives a one-rank
    mesh with the JAX package's axis names, and ``_mesh_axes`` resolves
    them as JAX's does."""
    cases = [(TP.make_cell_mesh(), JP.make_cell_mesh(1)),
             (TP.make_client_mesh(), JP.make_client_mesh(1)),
             (TP.make_grid_mesh(1, 1), JP.make_grid_mesh(1, 1)),
             (TP.make_multihost_mesh(), None),
             (TP.make_cell_mesh(1, axis_name="seeds"),
              JP.make_cell_mesh(1, axis_name="seeds"))]
    for tm, jm in cases:
        assert tm.size == 1 and tm.coords == (0,) * len(tm.axis_names)
        if jm is not None:
            assert tm.axis_names == tuple(jm.axis_names)
            assert dict(tm.shape) == dict(jm.shape)
            assert TP._mesh_axes(tm) == JP._mesh_axes(jm)
    assert TP.make_multihost_mesh().axis_names == ("cells", "clients")
    # A mesh is cached by layout: building it again reuses its groups.
    assert TP.make_client_mesh() is TP.make_client_mesh(1)
    assert TP.mesh_process_count(TP.make_grid_mesh(1, 1)) == 1
    bad = TP.Mesh(("clients", "cells"), np.array([[0]]))
    jbad = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("clients", "cells"))
    with pytest.raises(ValueError, match="clients") as t_err:
        TP._mesh_axes(bad)
    with pytest.raises(ValueError, match="clients") as j_err:
        JP._mesh_axes(jbad)
    assert str(t_err.value) == str(j_err.value)


def test_mesh_errors_name_the_topology():
    assert TP.device_topology() == "1 global rank(s) across 1 host(s)"
    with pytest.raises(ValueError, match=r"n_devices=2 outside \[1, 1\] — "
                                         r"have 1 global rank\(s\) across "
                                         r"1 host\(s\)"):
        TP.make_client_mesh(2)
    for n in (0, 2):
        with pytest.raises(ValueError, match="n_devices"):
            TP.make_cell_mesh(n)
    with pytest.raises(ValueError, match="needs 35 global ranks, have 1 "
                                         r"global rank\(s\) across 1 host"):
        TP.make_grid_mesh(cells=7, clients=5)
    with pytest.raises(ValueError, match=r"ranks per host.*1 global rank"):
        TP.make_multihost_mesh(cells=2)
    with pytest.raises(ValueError, match="outside the world"):
        TP._make_mesh([[0, 1]], ("cells", "clients"))
    with pytest.raises(TypeError, match="placement.Mesh"):
        TE.execute_cells([], sim=None, params0=None, num_steps=1,
                         mesh=JP.make_client_mesh(1))


def test_launch_mesh_module():
    with pytest.raises(NotImplementedError, match="Last"):
        tmesh.make_production_mesh()
    host = tmesh.make_host_mesh()
    assert host.axis_names == ("data", "model") and host.size == 1
    assert tmesh.make_grid_mesh is TP.make_grid_mesh
    assert (tmesh.CELL_AXIS, tmesh.CLIENT_AXIS) == (JP.CELL_AXIS,
                                                    JP.CLIENT_AXIS)


# ---------------------------------------------------- cell-axis algebra

def _cells():
    """A ragged fault-free grid of two structures (alg2 × binary at n 4
    and 8, benchmark2 × periodic at 8), the same in both packages."""
    specs = (("a_n4", "alg2", "binary", 4), ("a_n8", "alg2", "binary", 8),
             ("b_n8", "benchmark2", "periodic", 8))
    t = [TE.Scenario(name=n, scheduler=s, arrivals=a, n_clients=k,
                     horizon=T + 1) for n, s, a, k in specs]
    j = [JE.Scenario(name=n, scheduler=s, arrivals=a, n_clients=k,
                     horizon=T + 1) for n, s, a, k in specs]
    return t, j


def test_flatten_cells_matches_jax_bitwise():
    prob = tconv.make_quadratic(trandom.PRNGKey(0, device="cpu"), N_CAP,
                                dim=DIM)
    tcells, jcells = _cells()
    tsim = TSim(grads_fn=None, p=prob.p, optimizer=t_sgd(0.01), device="cpu")
    jsim = JSim(grads_fn=None, p=jnp.asarray(prob.p.numpy()),
                optimizer=j_sgd(0.01))
    seeds = (7, 11)
    tkeys = [trandom.PRNGKey(s, device="cpu") for s in seeds]
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    tgroups = tengine.resolve_structure_groups(tcells, sim=tsim)[2]
    jgroups = jengine.resolve_structure_groups(jcells, sim=jsim)[2]
    assert [g.members for g in tgroups] == [g.members for g in jgroups]
    for tg, jg in zip(tgroups, jgroups):
        n_scen = len(tg.members)
        t_out = TP.flatten_cells(tg.scheduler, tg.energy, tkeys,
                                 n_scenarios=n_scen, active=tg.active,
                                 p=tg.p, faults=tg.faults)
        j_out = JP.flatten_cells(jg.scheduler, jg.energy, jkeys,
                                 n_scenarios=n_scen, active=jg.active,
                                 p=jg.p, faults=jg.faults)
        sch_c, en_c, flt_c, act_c, p_c, keys_c = t_out
        n_c = n_scen * len(seeds)
        assert len(sch_c) == len(en_c) == len(flt_c) == len(keys_c) == n_c
        assert all(f is None for f in flt_c) and j_out[2] is None
        np.testing.assert_array_equal(torch.stack(keys_c).numpy(),
                                      np.asarray(j_out[5]))
        if tg.ragged:
            np.testing.assert_array_equal(torch.stack(act_c).numpy(),
                                          np.asarray(j_out[3]))
            np.testing.assert_array_equal(torch.stack(p_c).numpy(),
                                          np.asarray(j_out[4]))
        else:
            assert act_c is None and j_out[3] is None
        jleaves = jax.tree_util.tree_flatten_with_path(j_out[1])[0]
        for c in range(n_c):
            for path, leaf in jleaves:
                got = getattr(en_c[c], path[0].name)
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(leaf)[c])
            assert sch_c[c].n_clients == j_out[0].n_clients


def test_pad_cells_matches_jax():
    t_tree = {"a": torch.arange(6.0).reshape(3, 2)}
    j_tree = {"a": jnp.arange(6.0).reshape(3, 2)}
    for n_devices in (3, 4, 5):
        t_pad, tn = TP.pad_cells(t_tree, 3, n_devices)
        j_pad, jn = JP.pad_cells(j_tree, 3, n_devices)
        assert tn == jn
        np.testing.assert_array_equal(t_pad["a"].numpy(),
                                      np.asarray(j_pad["a"]))
    same, n = TP.pad_cells(t_tree, 3, 3)
    assert n == 3 and same is t_tree  # no copy when already divisible
    padded, n = TP.pad_cells((["x", "y", "z"], None), 3, 2)
    assert n == 4 and padded == (["x", "y", "z", "x"], None)


# ------------------------------------------------------- leaf-shape rule

@pytest.mark.parametrize("kind", ["scheduler", "energy"])
def test_leaf_rule_matches_client_leaf_specs(kind):
    """The same fields are split in both packages, for every built-in
    scheduler and every registered arrival family, at capacity 8 and
    after a ragged pad to 8 (the leaf rule reads the padded width)."""
    names = scheduler_names() if kind == "scheduler" else ARRIVALS
    for name in names:
        for n in (N_CAP, 5):
            if kind == "scheduler":
                t, j = t_scheduler(name, n), j_scheduler(name, n)
            else:
                t = t_arrivals(name, n, T + 1).pad_clients(N_CAP)
                j = j_arrivals(name, n, T + 1).pad_clients(N_CAP)
            jspecs = JP.client_leaf_specs(j, N_CAP, client_axis="clients")
            jnames = [p[0].name for p, _ in
                      jax.tree_util.tree_flatten_with_path(j)[0]]
            j_split = {nm for nm, spec in zip(jnames, jspecs)
                       if spec == jax.sharding.PartitionSpec("clients")}
            tspecs = TP.client_leaf_specs(t, N_CAP)
            assert {nm for nm, _ in tspecs} <= set(jnames)
            assert {nm for nm, ax in tspecs if ax == "clients"} == j_split


def test_shard_fields_cut_rows():
    en = t_arrivals("day_night", N_CAP, T + 1)
    cut = TP._shard_fields(en, N_CAP, slice(4, 8))
    assert torch.equal(cut.betas_day, en.betas_day[4:])
    assert torch.equal(cut.period, en.period)
    sched = t_arrivals("periodic", N_CAP, T + 1)
    cut = TP._shard_fields(sched, N_CAP, slice(2, 4))
    assert torch.equal(cut.schedule, sched.schedule[2:4])
    assert torch.equal(cut.gaps, sched.gaps[2:4])


# ----------------------------------------------------- reduction grammar

@pytest.mark.parametrize("reduction", [
    "gather", "psum", "psum_bf16", "fused", "fused_bf16", "gather_bf16",
    "psum_f16", "allreduce", "fused_"])
def test_parse_reduction_matches_jax(reduction):
    from repro.core.aggregation import parse_reduction as j_parse

    try:
        want = j_parse(reduction)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tagg.parse_reduction(reduction)
        assert str(got.value) == str(e)
        return
    mode, wire = tagg.parse_reduction(reduction)
    assert mode == want[0]
    assert (wire is None) == (want[1] is None)
    if wire is not None:
        assert wire == torch.bfloat16 and want[1] == jnp.bfloat16


def test_reduction_ladder_matches_jax():
    assert tengine._REDUCTION_LADDER == jengine._REDUCTION_LADDER
    assert TE.ExecutionConfig().client_reduction == "psum"
    import inspect

    sig = inspect.signature(TP.run_client_sharded)
    assert sig.parameters["reduction"].default == "psum"


# ------------------------------------------------------- shard_scheduler

def test_shard_scheduler_matches_jax():
    for name in scheduler_names():
        t = t_shard_scheduler(t_scheduler(name, N_CAP), 2)
        j = j_shard_scheduler(j_scheduler(name, N_CAP), 2)
        assert t.n_clients == j.n_clients == 2
        state = t.init(trandom.PRNGKey(0, device="cpu"))
        jstate = j.init(jax.random.PRNGKey(0))
        for a, b in zip(tree_leaves(state), jax.tree_util.tree_leaves(jstate)):
            assert tuple(a.shape) == tuple(b.shape)

    @dataclasses.dataclass
    class Custom:
        n_clients: int

        def shard_clients(self, n_local):
            return ("mine", n_local)

    assert t_shard_scheduler(Custom(8), 4) == ("mine", 4)


# ------------------------------------------------ one rank = no mesh

def test_one_rank_mesh_is_the_unsharded_path():
    prob = tconv.make_quadratic(trandom.PRNGKey(1, device="cpu"), N_CAP,
                                dim=DIM)
    sim = TSim(grads_fn=lambda w, k, t: prob.all_grads(w, key=k, noise=0.05),
               p=prob.p, optimizer=t_sgd(0.02), loss_fn=prob.global_loss,
               use_kernel=True, device="cpu")
    study = (TE.Study("one", num_steps=T).axis("scheduler", ["alg1", "alg2"])
             .axis("arrivals", "binary").axis("n_clients", [5, 8])
             .axis("seeds", 2))
    w0 = torch.full((DIM,), 3.0)
    before = TP._run_group_sharded._cache_size()
    plain = study.run(sim=sim, params0=w0)
    for mesh in (TP.make_client_mesh(), TP.make_cell_mesh(),
                 TP.make_grid_mesh(1, 1)):
        for reduction in ("gather", "psum", "fused_bf16"):
            one = study.run(sim=sim, params0=w0, config=TE.ExecutionConfig(
                mesh=mesh, client_reduction=reduction))
            for name in plain:
                for x, y in zip(tree_leaves(tuple(plain[name])),
                                tree_leaves(tuple(one[name]))):
                    assert torch.equal(x, y)
            assert one.downgrades == ()
    assert TP._run_group_sharded._cache_size() == before
    with pytest.raises(ValueError, match="sequential"):
        study.run(sim=sim, params0=w0, config=TE.ExecutionConfig(
            mesh=TP.make_cell_mesh(), sequential=True))


def test_replicate_and_fetch():
    tree = {"a": torch.arange(3.0), "b": (torch.ones(2, dtype=torch.int32),)}
    mesh = TP.make_client_mesh()
    assert TP.replicate_to_mesh(tree, mesh) is tree
    host = TP.fetch_to_host(tree)
    assert isinstance(host["a"], np.ndarray)
    np.testing.assert_array_equal(host["b"][0], [1, 1])


# ------------------------------------------------- environment contract

_ENV = (jenv.DIST_COORDINATOR, jenv.DIST_NUM_PROCESSES, jenv.DIST_PROCESS_ID,
        jenv.DIST_LOCAL_DEVICES)


@pytest.mark.parametrize("env", [
    {},
    {"REPRO_DIST_COORDINATOR": "127.0.0.1:1234"},
    {"REPRO_DIST_NUM_PROCESSES": "2"},
    {"REPRO_DIST_COORDINATOR": "h:1", "REPRO_DIST_NUM_PROCESSES": "2",
     "REPRO_DIST_PROCESS_ID": "1"},
    {"REPRO_DIST_COORDINATOR": "h:1", "REPRO_DIST_NUM_PROCESSES": "4",
     "REPRO_DIST_PROCESS_ID": "3", "REPRO_DIST_LOCAL_DEVICES": "2"},
])
def test_distributed_env_matches_jax(monkeypatch, env):
    assert (tenv.DIST_COORDINATOR, tenv.DIST_NUM_PROCESSES,
            tenv.DIST_PROCESS_ID, tenv.DIST_LOCAL_DEVICES) == _ENV
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    try:
        want = jenv.distributed_env()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tenv.distributed_env()
        assert str(got.value) == str(e)
        return
    assert tenv.distributed_env() == want
