"""Port parity for the experiments engine: scenarios, structure groups,
ragged padding, results tables and the LRU cache.

Against the JAX package (``repro.experiments``), on the same inputs:
``population_mask`` and ``subpopulation_p`` bit for bit (the port sums a
prefix one f32 add at a time in client order, which is the order of
XLA's CPU reduction up to 32 clients; the cases stay within that);
the structure groups a grid resolves into (members, raggedness, the
(N_cap,) masks and weights) equal; ``GridResult`` selections,
reductions and exports equal on the same numbers; ``LRUCache`` counters
equal after the same operations.

Inside the port, bit for bit (the JAX package's own ragged property
tests are red on this tree, ROADMAP caveat R2, so these are the port's
proof): ``sequential=True`` equals the grouped default; a full-capacity
cell in a mixed group equals the same cell in a uniform group; padding
never changes an existing client's participation nor its participation
count; a grid cell equals a standalone ``ClientSimulator.run``.
Everything runs on the CPU through the kernels' plain versions
(``use_kernel=True``) at N ≤ 16 clients, dim 8, at most 40 steps.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro import experiments as JE
from repro._lru import LRUCache as JLRU
from repro.core import ClientSimulator as JSim
from repro.core.trainer import SimHistory as JHist
from repro.optim import sgd as j_sgd
from repro_torch import experiments as TE
from repro_torch import random as trandom
from repro_torch._lru import LRUCache as TLRU
from repro_torch._tree import tree_leaves
from repro_torch.core import ClientSimulator as TSim
from repro_torch.core import convergence as tconv
from repro_torch.core.trainer import SimHistory as THist
from repro_torch.optim import momentum as t_momentum
from repro_torch.optim import sgd as t_sgd

N_CAP, DIM, T = 16, 8, 40
W0 = np.full((DIM,), 5.0, np.float32)


@pytest.fixture(scope="module")
def prob():
    return tconv.make_quadratic(trandom.PRNGKey(0, device="cpu"), N_CAP,
                                dim=DIM, hetero=1.0)


def _sim(prob, n=N_CAP, opt=t_sgd):
    """A CPU simulator over the first ``n`` clients of ``prob`` (noisy
    gradients: the noise's bits depend on n, so runs at different n are
    compared on participation only)."""
    a, b, p = prob.a[:n], prob.b[:n], prob.p[:n]
    part = prob._replace(a=a, b=b, p=p / p.sum())

    def grads(w, key, t):
        return part.all_grads(w, key=key, noise=0.05)

    return TSim(grads_fn=grads, p=part.p, optimizer=opt(0.01),
                loss_fn=part.global_loss, use_kernel=True, device="cpu")


def _cells(*specs):
    """Scenarios from (name, scheduler, arrivals, n, kwargs) tuples."""
    return [TE.Scenario(name=name, scheduler=s, arrivals=a, n_clients=n,
                        horizon=T + 1, scheduler_kwargs=dict(kw))
            for name, s, a, n, kw in specs]


MIXED = (("alg2_n4", "alg2", "binary", 4, {}),
         ("alg2_n8", "alg2", "binary", 8, {}),
         ("alg2_n16", "alg2", "binary", 16, {}),
         ("alg1_n16", "alg1", "periodic", 16, {}),
         ("bench2_n16", "benchmark2", "periodic", 16, {}),
         ("battery_c1_n6", "battery_adaptive", "binary", 6, {"capacity": 1.0}),
         ("battery_c3_n16", "battery_adaptive", "binary", 16,
          {"capacity": 3.0}))


def _assert_cells_equal(a, b):
    leaves_a, leaves_b = (tree_leaves(tuple(c)) for c in (a, b))
    assert len(leaves_a) == len(leaves_b)
    for x, y in zip(leaves_a, leaves_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ------------------------------------------------- masks, weights, groups


@pytest.mark.parametrize("n,n_total", [(1, 1), (3, 8), (8, 8), (5, 16),
                                       (16, 16), (13, 32), (32, 32)])
def test_population_mask_and_subpopulation_p_bitwise(n, n_total):
    rng = np.random.default_rng(n * 100 + n_total)
    sizes = rng.integers(20, 300, n_total).astype(np.float64)
    for p in (sizes / sizes.sum(),
              rng.uniform(0.5, 1.5, n_total)):
        p = p.astype(np.float32)
        want = np.asarray(JE.subpopulation_p(jnp.asarray(p), n, n_total))
        got = TE.subpopulation_p(torch.from_numpy(p), n, n_total)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TE.population_mask(n, n_total, device="cpu").numpy(),
        np.asarray(JE.population_mask(n, n_total)))


def test_subpopulation_p_refuses_empty_and_oversized():
    p = torch.full((4,), 0.25)
    for n in (0, 5):
        with pytest.raises(ValueError, match="outside"):
            TE.subpopulation_p(p, n)


def test_structure_groups_match_jax(prob):
    """The same mixed-population grid resolves into the same groups in
    both packages: members, raggedness, and each ragged member's mask
    and weights bit for bit."""
    tcells = _cells(*MIXED)
    jcells = [JE.Scenario(**{f: getattr(sc, f) for f in (
        "name", "scheduler", "arrivals", "n_clients", "horizon",
        "scheduler_kwargs")}) for sc in tcells]
    jsim = JSim(grads_fn=None, p=jnp.asarray(prob.p.numpy()),
                optimizer=j_sgd(0.01))
    tsim = TSim(grads_fn=None, p=prob.p, optimizer=t_sgd(0.01), device="cpu")
    jnames, jcap, jgroups = JE.engine.resolve_structure_groups(jcells, sim=jsim)
    tnames, tcap, tgroups = TE.resolve_structure_groups(tcells, sim=tsim)
    assert (tnames, tcap) == (jnames, jcap)
    assert [g.members for g in tgroups] == [g.members for g in jgroups]
    assert [g.ragged for g in tgroups] == [g.ragged for g in jgroups]
    assert any(g.ragged for g in tgroups) and not all(g.ragged for g in tgroups)
    for tg, jg in zip(tgroups, jgroups):
        if not tg.ragged:
            assert tg.active is None and jg.active is None
            continue
        np.testing.assert_array_equal(torch.stack(tg.active).numpy(),
                                      np.asarray(jg.active))
        np.testing.assert_array_equal(torch.stack(tg.p).numpy(),
                                      np.asarray(jg.p))
        # A full-capacity member keeps sim.p verbatim under an all-ones mask.
        for j, i in enumerate(tg.members):
            if tcells[i].n_clients == N_CAP:
                assert tg.p[j] is tsim.p and bool((tg.active[j] == 1).all())


# ----------------------------------------- inside the port, bit for bit


@pytest.mark.parametrize("opt,seeds", [(t_sgd, [0, 3]), (t_momentum, [3])],
                         ids=["sgd", "momentum"])
def test_sequential_equals_grouped(prob, opt, seeds):
    sim = _sim(prob, opt=opt)
    kw = dict(sim=sim, params0=torch.from_numpy(W0), num_steps=T, seeds=seeds)
    grouped = TE.execute_cells(_cells(*MIXED), **kw)
    seq = TE.execute_cells(_cells(*MIXED), sequential=True, **kw)
    assert list(grouped) == list(seq) == [m[0] for m in MIXED]
    for name in grouped:
        _assert_cells_equal(grouped[name], seq[name])
    legacy = TE.run_grid_sequential(_cells(*MIXED[:2]), **kw)
    for name in legacy:
        _assert_cells_equal(grouped[name], legacy[name])


def test_full_capacity_cell_in_mixed_group_equals_uniform_group(prob):
    sim = _sim(prob)
    kw = dict(sim=sim, params0=torch.from_numpy(W0), num_steps=T, seeds=2)
    mixed = TE.get_study("population_scaling", n_clients=(5, 16),
                         num_steps=T, seeds=2)
    uniform = TE.get_study("population_scaling", n_clients=(16,),
                           num_steps=T, seeds=2)
    groups = TE.resolve_structure_groups(mixed.resolve(), sim=sim)[2]
    assert len(groups) == 1 and groups[0].ragged
    a = TE.execute_cells(mixed.resolve(), **kw)["alg2_binary_n16"]
    assert not TE.resolve_structure_groups(uniform.resolve(), sim=sim)[2][0].ragged
    b = TE.execute_cells(uniform.resolve(), **kw)["alg2_binary_n16"]
    _assert_cells_equal(a, b)


PADDED = [("alg1", "periodic", {}), ("alg2", "binary", {}),
          ("benchmark1", "uniform", {}), ("benchmark2", "periodic", {}),
          ("battery_adaptive", "binary", {"capacity": 2.5}),
          ("oracle", "day_night", {})]


def _padded_pair(prob, sched, arrivals, kw, n, seed):
    """Participation of the first-n subpopulation run natural (an
    n-client simulator) and padded to N_CAP inside the engine."""
    arr_kw = {"period": 10} if arrivals == "day_night" else {}
    sc = TE.Scenario(name="c", scheduler=sched, arrivals=arrivals,
                     n_clients=n, horizon=T + 1, scheduler_kwargs=kw,
                     arrival_kwargs=arr_kw)
    run = dict(params0=torch.from_numpy(W0), num_steps=T, seeds=[seed])
    nat = TE.execute_cells([sc], sim=_sim(prob, n), **run)["c"]
    pad = TE.execute_cells([sc], sim=_sim(prob), **run)["c"]
    return nat.history.participation, pad.history.participation


@pytest.mark.parametrize("sched,arrivals,kw", PADDED,
                         ids=[f"{s}-{a}" for s, a, _ in PADDED])
def test_padding_never_changes_existing_clients_participation(prob, sched,
                                                              arrivals, kw):
    for n, seed in ((3, 0), (11, 5)):
        nat, pad = _padded_pair(prob, sched, arrivals, kw, n, seed)
        assert nat.shape == pad.shape == (1, T, n)
        assert torch.equal(nat, pad)


@pytest.mark.parametrize("sched,arrivals,kw", PADDED,
                         ids=[f"{s}-{a}" for s, a, _ in PADDED])
def test_participation_counts_invariant_under_padding(prob, sched, arrivals,
                                                      kw):
    nat, pad = _padded_pair(prob, sched, arrivals, kw, 7, 9)
    assert torch.equal(nat.sum(dim=1), pad.sum(dim=1))
    assert int(pad.sum()) > 0


def test_grid_cell_equals_standalone_run(prob):
    sim = _sim(prob)
    evals = lambda w: {"norm": torch.sum(w * w)}
    cells = TE.get_study("fig1", n_clients=N_CAP, num_steps=T).resolve()
    out = TE.execute_cells(cells, sim=sim, params0=torch.from_numpy(W0),
                           num_steps=T, seeds=[2, 7], eval_fn=evals,
                           eval_every=10)
    for sc in cells:
        scheduler, energy = sc.build()
        for r, s in enumerate((2, 7)):
            params, hist, ev = sim.run(
                trandom.PRNGKey(s, device="cpu"), torch.from_numpy(W0), T,
                scheduler=scheduler, energy=energy, eval_fn=evals,
                eval_every=10)
            cell = out[sc.name]
            assert torch.equal(cell.params[r], params)
            for x, y in zip(cell.history, hist):
                assert torch.equal(x[r], y)
            assert torch.equal(cell.evals["norm"][r], ev["norm"])
            assert int(cell.diverged[r]) == -1


def test_divergence_is_recorded_per_seed(prob):
    """A step size far past 2/L blows the quadratic up: ``diverged`` is
    each seed's first non-finite step, and the summaries report it."""
    sim = TSim(grads_fn=lambda w, k, t: prob.all_grads(w), p=prob.p,
               optimizer=t_sgd(50.0), loss_fn=prob.global_loss,
               use_kernel=True, device="cpu")
    cells = _cells(("alg2", "alg2", "binary", N_CAP, {}),
                   ("oracle", "oracle", "binary", N_CAP, {}))
    out = TE.execute_cells(cells, sim=sim, params0=torch.from_numpy(W0),
                           num_steps=T, seeds=[0, 1])
    summary = TE.divergence_summary(out)
    for name, cell in out.items():
        fin = cell.history.finite
        first = [int(torch.nonzero(~f)[0]) for f in fin]
        assert cell.diverged.dtype == torch.int32
        assert cell.diverged.tolist() == first
        assert summary[name] == {"n_diverged": 2, "first_bad_step": min(first)}
    stats = TE.grid_summary(out)
    assert all(s["n_nan"] == 2 for s in stats.values())


# ------------------------------------------------------------- refusals


def _never(*_):
    raise AssertionError("a step ran")


def test_refusals_name_their_roadmap_step(prob):
    sim = TSim(grads_fn=_never, p=prob.p, optimizer=t_sgd(0.01), device="cpu")
    cells = _cells(("a", "alg1", "periodic", N_CAP, {}))
    kw = dict(sim=sim, params0=torch.from_numpy(W0), num_steps=T, seeds=1)
    with pytest.raises(NotImplementedError, match="step 7"):
        TE.execute_cells(cells, mesh=object(), **kw)
    # The executable cache is ported: the engine asks it for the group's
    # runner before any step runs.
    class Probe:
        def group_runner(self, key, **_):
            raise LookupError(key)

    with pytest.raises(LookupError):
        TE.execute_cells(cells, executable_cache=Probe(), **kw)
    # Faults are ported: an unknown family raises JAX's ValueError before
    # any step, on either path and through the axis; a registered one runs.
    faulty = [TE.Scenario(name="f", scheduler="alg1", arrivals="periodic",
                          n_clients=N_CAP, horizon=T + 1,
                          faults="drop_updates")]
    jfaulty = [JE.Scenario(name="f", scheduler="alg1", arrivals="periodic",
                           n_clients=N_CAP, horizon=T + 1,
                           faults="drop_updates")]
    with pytest.raises(ValueError) as je:
        jfaulty[0].build_faults()
    for sequential in (False, True):
        with pytest.raises(ValueError) as te:
            TE.execute_cells(faulty, sequential=sequential, **kw)
        assert str(te.value) == str(je.value)
    axis = TE.get_axis("faults")
    for value in ("drop_updates", ("drop_updates", {"rate": 0.1})):
        with pytest.raises(ValueError) as je:
            JE.get_axis("faults").validate(value)
        with pytest.raises(ValueError) as te:
            axis.validate(value)
        assert str(te.value) == str(je.value)
    (cell,) = TE.Study("s", num_steps=T, axes={
        "scheduler": "alg1", "arrivals": "periodic",
        "faults": ("drop", {"rate": 0.25})}).resolve()
    assert (cell.faults, cell.fault_kwargs) == ("drop", {"rate": 0.25})
    ran = TE.execute_cells([cell], sim=_sim(prob), params0=torch.from_numpy(W0),
                           num_steps=4, seeds=1)[cell.name]
    assert ran.history.weight_sum.shape == (1, 4)
    # The fault-free value of the axis is the plain program.
    (cell,) = TE.Study("s", num_steps=T, axes={
        "scheduler": "alg1", "arrivals": "periodic", "faults": None}).resolve()
    assert cell.faults is None and cell.build_faults() is None


def test_names_and_capacity_checked_before_any_step(prob):
    sim = TSim(grads_fn=_never, p=prob.p, optimizer=t_sgd(0.01), device="cpu")
    kw = dict(sim=sim, params0=torch.from_numpy(W0), num_steps=T, seeds=1)
    dup = _cells(("a", "alg1", "periodic", 8, {}), ("b", "alg2", "binary", 8, {}),
                 ("a", "oracle", "binary", 8, {}))
    over = _cells(("a", "alg1", "periodic", 8, {}),
                  ("big", "alg2", "binary", N_CAP + 1, {}))
    for sequential in (False, True):
        with pytest.raises(ValueError, match=r"duplicates \['a'\]"):
            TE.execute_cells(dup, sequential=sequential, **kw)
        with pytest.raises(ValueError, match=r"capacity N_cap=16.*big \(N=17\)"):
            TE.execute_cells(over, sequential=sequential, **kw)


# ------------------------------------------------------ results and LRU


def _result_pair():
    """The same four-cell, three-seed table in both packages: one seed
    of one cell diverged at step 4 (NaN loss from there)."""
    rng = np.random.default_rng(0)
    axes = {"scheduler": ("alg1", "benchmark1"), "capacity": (1.0, 2.0),
            "seed": (0, 1, 2)}
    labels, jcells, tcells = {}, {}, {}
    for s in axes["scheduler"]:
        for c in axes["capacity"]:
            name = f"{s}_c{c:g}"
            labels[name] = {"scheduler": s, "capacity": c}
            loss = rng.uniform(0.1, 2.0, (3, 20)).astype(np.float32)
            fin = np.ones((3, 20), bool)
            if name == "benchmark1_c2":
                loss[1, 4:] = np.nan
                fin[1, 4:] = False
            part = (rng.uniform(size=(3, 20, 4)) < 0.5).astype(np.float32)
            ws = rng.uniform(0.5, 1.5, (3, 20)).astype(np.float32)
            params = rng.normal(size=(3, 5)).astype(np.float32)
            jcells[name] = JE.engine._attach_divergence(JE.CellResult(
                jnp.asarray(params), JHist(jnp.asarray(loss), jnp.asarray(part),
                                           jnp.asarray(ws), jnp.asarray(fin))))
            tcells[name] = TE.engine._attach_divergence(TE.CellResult(
                torch.from_numpy(params), THist(
                    torch.from_numpy(loss), torch.from_numpy(part),
                    torch.from_numpy(ws), torch.from_numpy(fin))))
    return (JE.GridResult(jcells, labels, axes, name="grid"),
            TE.GridResult(tcells, labels, axes, name="grid"))


def test_grid_result_matches_jax():
    jr, tr = _result_pair()
    assert repr(tr) == repr(jr) and list(tr) == list(jr)
    np.testing.assert_array_equal(
        tr["benchmark1_c2"].diverged.numpy(),
        np.asarray(jr["benchmark1_c2"].diverged))
    for sel in ({"scheduler": "alg1"}, {"capacity": [2.0]},
                {"scheduler": "benchmark1", "capacity": 2.0}):
        js, ts = jr.sel(**sel), tr.sel(**sel)
        assert list(ts) == list(js) and ts.axes == js.axes
    assert torch.equal(tr.sel(scheduler="alg1", capacity=1.0).only().params,
                       tr["alg1_c1"].params)
    for err, sel in ((KeyError, {"scheduler": "oracle"}),
                     (ValueError, {"seed": 0}), (ValueError, {"bogus": 1})):
        with pytest.raises(err) as je:
            jr.sel(**sel)
        with pytest.raises(err) as te:
            tr.sel(**sel)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="exactly one cell"):
        tr.only()
    last = lambda c: c.history.loss[:, -1]
    for over in ("seed", "capacity", "scheduler"):
        assert tr.reduce(over=over) == jr.reduce(over=over)
    assert tr.reduce(last) == jr.reduce(last)
    assert tr.reduce()["benchmark1_c2"]["n_nan"] == 1
    assert tr.divergence() == jr.divergence()
    assert tr.to_records() == jr.to_records()
    assert tr.to_json() == jr.to_json()
    assert json.loads(tr.to_json())["records"][3]["first_bad_step"] == 4
    assert TE.grid_summary(tr.cells) == JE.grid_summary(jr.cells)
    assert TE.divergence_summary(tr.cells) == JE.divergence_summary(jr.cells)


def test_lru_counters_match_jax():
    evicted = {"j": [], "t": []}
    caches = {"j": JLRU(3, on_evict=lambda k, v: evicted["j"].append(k)),
              "t": TLRU(3, on_evict=lambda k, v: evicted["t"].append(k))}
    ops = [("put", "a", 1), ("put", "b", 2), ("get", "a"), ("get", "z"),
           ("put", "c", 3), ("put", "d", 4), ("create", "b", 5),
           ("create", "e", 6), ("pop", "c"), ("put", "a", 7), ("get", "a"),
           ("clear",), ("create", "a", 8), ("get", "a")]
    for op in ops:
        out = {}
        for tag, cache in caches.items():
            if op[0] == "put":
                out[tag] = cache.put(op[1], op[2])
            elif op[0] == "get":
                out[tag] = cache.get(op[1])
            elif op[0] == "create":
                out[tag] = cache.get_or_create(op[1], lambda v=op[2]: v)
            elif op[0] == "pop":
                out[tag] = cache.pop(op[1])
            else:
                out[tag] = cache.clear()
        assert out["t"] == out["j"], op
        assert caches["t"].stats() == caches["j"].stats(), op
        assert caches["t"].keys() == caches["j"].keys(), op
    assert evicted["t"] == evicted["j"] and evicted["t"]
    with pytest.raises(ValueError, match="maxsize"):
        TLRU(0)
