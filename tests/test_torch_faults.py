"""Port parity for client fault injection (``repro_torch.core.faults``).

Against the JAX package (``repro.core.faults``), on the same inputs
(numpy, seeded), the same component carried over with
``convert.fault_from_jax``:

- per family, ``init`` and ``apply``: the delivery mask ``keep`` and the
  stale ring bit for bit, the transformed ``g`` exact (NaN where JAX has
  NaN). Scalar and ``(N,)`` rates, a NaN ``scale``, the stale ring across
  ``t < delay`` and ``t ≥ delay``, periodic and one-shot offline windows
  (with rows whose window starts after ``t``), and a composite's
  independent subkeys;
- ``pad_faults`` fields, the registry's names and its errors, the
  rate and window checks;
- the structure groups of a grid with fault cells (``delay`` 1 against
  3, a composite, a scalar against a per-client rate, ragged n = 6);
- whole studies through ``execute_cells`` on the ``eval_fn`` route on
  both sides (the JAX package's plain ``run`` trips ROADMAP caveat R1),
  fault cells in mixed and ragged groups: participation, ``diverged``
  and ``finite`` bit for bit; ``loss``, ``weight_sum``, params and evals
  within ``rtol=1e-5, atol=1e-6`` (the two packages sum the gradients'
  products in different orders).

Inside the port, bit for bit: every family at rate 0 is the identity for
every scheduler; a padded fault cell equals its natural-n run (with
dyadic gradients and weights, so the client sum is exact in any order
and the comparison covers params and ``weight_sum``, not participation
alone); dropped NaN rows give exact zeros through the plain versions of
K2 (sgd) and K1 (momentum). Everything runs on the CPU at N = 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro import experiments as JE
from repro.core import ClientSimulator as JSim
from repro.core import convergence as jconv
from repro.core import faults as JF
from repro.optim import sgd as j_sgd
from repro_torch import experiments as TE
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves
from repro_torch.convert import fault_from_jax
from repro_torch.core import ClientSimulator as TSim
from repro_torch.core import convergence as tconv
from repro_torch.core import faults as TF
from repro_torch.optim import momentum as t_momentum
from repro_torch.optim import sgd as t_sgd

N, P, DIM, T, EVAL_EVERY = 8, 5, 6, 24, 12
W0 = np.full((DIM,), 4.0, np.float32)
NAN = float("nan")

# (family, kwargs) — kwargs may hold per-client lists of length N.
APPLY_CASES = {
    "drop-scalar": ("drop", {"rate": 0.3}),
    "drop-per-client": ("drop", {"rate": [0.0, 0.1, 0.5, 0.9, 1.0, 0.3,
                                          0.7, 0.2]}),
    "corrupt-nan": ("corrupt", {"rate": 0.5, "scale": NAN}),
    "corrupt-per-client": ("corrupt", {"rate": [1.0, 0.0] * 4, "scale": -3.0}),
    "stale-delay1": ("stale", {"rate": 0.5, "delay": 1}),
    "stale-delay3": ("stale", {"rate": [0.9] * 4 + [0.2] * 4, "delay": 3}),
    "offline-periodic": ("offline", {"start": [0, 1, 2, 3, 9, 12, 0, 4],
                                     "length": [1, 2, 0, 3, 2, 1, 4, 2],
                                     "period": [4, 5, 3, 0, 6, 0, 5, 7]}),
    "offline-one-shot": ("offline", {"start": 3, "length": 4}),
    "drop_corrupt": ("drop_corrupt", {"drop_rate": 0.4, "corrupt_rate": 0.5,
                                      "scale": NAN}),
}


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_init_and_apply_match_jax(case):
    kind, kw = APPLY_CASES[case]
    jf = JF.make_fault(kind, N, **kw)
    tf = TF.make_fault(kind, N, **kw)
    conv = fault_from_jax(jf)
    assert type(tf) is type(conv)
    for a, b in zip(_fields(tf), _fields(conv)):
        assert torch.equal(a, b) or (a.isnan().all() and b.isnan().all())
    rng = np.random.default_rng(len(case))
    jkey, tkey = jax.random.PRNGKey(11), trandom.PRNGKey(11, device="cpu")
    js = jf.init(jax.random.fold_in(jkey, JF.FAULT_SALT), N, P)
    ts = tf.init(trandom.fold_in(tkey, TF.FAULT_SALT), N, P)
    _assert_state(ts, js)
    kept = []
    for t in range(14):
        g = rng.normal(size=(N, P)).astype(np.float32)
        js, jg, jkeep = jf.apply(js, jnp.int32(t), jax.random.fold_in(jkey, t),
                                 jnp.asarray(g))
        ts, tg, tkeep = tf.apply(ts, torch.tensor(t, dtype=torch.int32),
                                 trandom.fold_in(tkey, t), torch.from_numpy(g))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        assert (tkeep is None) == (jkeep is None)
        if tkeep is not None:
            assert tkeep.dtype == torch.float32 and tkeep.shape == (N,)
            np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
            kept.append(tkeep.numpy())
        _assert_state(ts, js)
    if kept and kind != "stale":
        # The case faults something and delivers something.
        kept = np.array(kept)
        assert 0 < kept.sum() < kept.size


def _fields(fault):
    if isinstance(fault, TF.CompositeFault):
        return [x for p in fault.parts for x in _fields(p)]
    return [v for v in vars(fault).values() if isinstance(v, torch.Tensor)]


def _assert_state(ts, js):
    tl, jl = tree_leaves(ts), jax.tree_util.tree_leaves(js)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stale_ring_before_and_after_delay():
    """rate 1, delay 3: rows drop for t < 3, then each step delivers the
    gradient sent three rounds before; the input ring is not written."""
    f = TF.StaleUpdates(1.0, delay=3)
    key = trandom.PRNGKey(0, device="cpu")
    state = f.init(key, N, P)
    sent = []
    for t in range(7):
        g = torch.full((N, P), float(t + 1))
        before = state.clone()
        new, out, keep = f.apply(state, torch.tensor(t, dtype=torch.int32),
                                 trandom.fold_in(key, t), g)
        assert torch.equal(state, before), "the input ring stays valid"
        if t < 3:
            assert torch.equal(keep, torch.zeros(N))
        else:
            assert torch.equal(keep, torch.ones(N))
            assert torch.equal(out, sent[t - 3])
        sent.append(g)
        state = new


def test_offline_window_starting_after_t_stays_online():
    f = TF.OfflineWindows(start=[0, 5, 20], length=[2, 3, 1], period=[0, 6, 0])
    keep = [f.apply((), torch.tensor(t, dtype=torch.int32), None,
                    torch.zeros(3, 1))[2].tolist() for t in range(13)]
    assert [k[2] for k in keep] == [1.0] * 13
    assert [k[0] for k in keep] == [0.0, 0.0] + [1.0] * 11
    assert [t for t, k in enumerate(keep) if k[1] == 0.0] == [5, 6, 7, 11, 12]


def test_composite_parts_draw_independent_subkeys():
    """Two identical drop families inside a composite draw from
    ``fold_in(key, 0)`` and ``fold_in(key, 1)``: their masks differ, and
    each equals the family applied alone on that subkey."""
    key = trandom.PRNGKey(5, device="cpu")
    part = TF.DropUpdates(0.5)
    comp = TF.CompositeFault((part, part))
    g = torch.ones(64, 2)
    _, _, keep = comp.apply(((), ()), 0, key, g)
    k0 = part.apply((), 0, trandom.fold_in(key, 0), g)[2]
    k1 = part.apply((), 0, trandom.fold_in(key, 1), g)[2]
    assert not torch.equal(k0, k1)
    assert torch.equal(keep, k0 * k1)
    jkeep = JF.CompositeFault((JF.DropUpdates(0.5),) * 2).apply(
        ((), ()), 0, jax.random.PRNGKey(5), jnp.ones((64, 2)))[2]
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_pad_faults_matches_jax(case):
    kind, kw = APPLY_CASES[case]
    kw = {k: v[:6] if isinstance(v, list) else v for k, v in kw.items()}
    jp = JF.pad_faults(JF.make_fault(kind, 6, **kw), N)
    tp = TF.pad_faults(TF.make_fault(kind, 6, **kw), N)
    assert type(tp).__name__ == type(jp).__name__
    _assert_same_fields(tp, jp)
    assert TF.pad_faults(None, N) is None


def _assert_same_fields(tf, jf):
    if isinstance(tf, TF.CompositeFault):
        for a, b in zip(tf.parts, jf.parts):
            _assert_same_fields(a, b)
        return
    for name, value in vars(tf).items():
        want = getattr(jf, name)
        if isinstance(value, torch.Tensor):
            assert str(value.dtype).removeprefix("torch.") == \
                np.asarray(want).dtype.name
            np.testing.assert_array_equal(value.numpy(), np.asarray(want))
        else:
            assert value == want


def test_registry_and_errors_match_jax():
    assert TF.fault_family_names() == JF.fault_family_names()
    assert TF.FAULT_SALT == JF.FAULT_SALT
    for call in (lambda F: F.make_fault("meteor_strike", N),
                 lambda F: F.DropUpdates(1.5),
                 lambda F: F.DropUpdates([0.1, -0.2]),
                 lambda F: F.make_fault("drop_corrupt", N, corrupt_rate=2.0),
                 lambda F: F.StaleUpdates(0.1, delay=0),
                 lambda F: F.OfflineWindows(start=-1, length=2),
                 lambda F: F.CompositeFault(()),
                 lambda F: F.pad_faults(F.DropUpdates([0.1] * 4), 3)):
        with pytest.raises(ValueError) as je:
            call(JF)
        with pytest.raises(ValueError) as te:
            call(TF)
        assert str(te.value) == str(je.value)
    with pytest.raises(TypeError, match="pad_clients"):
        TF.pad_faults(object(), N)


# ------------------------------------------------------------ engine

def _scenario(E, name, n, faults=None, sched="alg1", arrivals="periodic",
              **fault_kwargs):
    return E.Scenario(name=name, scheduler=sched, arrivals=arrivals,
                      n_clients=n, horizon=T + 1, faults=faults,
                      fault_kwargs=dict(fault_kwargs))


GROUP_CELLS = [
    ("clean", N, None, {}),
    ("drop_scalar", N, "drop", {"rate": 0.3}),
    ("drop_scalar_b", N, "drop", {"rate": 0.6}),
    ("drop_per_client", N, "drop", {"rate": [0.3] * N}),
    ("stale_d1", N, "stale", {"rate": 0.5, "delay": 1}),
    ("stale_d3", N, "stale", {"rate": 0.5, "delay": 3}),
    ("stale_d3_n6", 6, "stale", {"rate": 0.2, "delay": 3}),
    ("composite", N, "drop_corrupt", {"drop_rate": 0.3, "corrupt_rate": 0.1,
                                      "scale": NAN}),
    ("offline_n6", 6, "offline", {"start": [0, 1, 2, 3, 4, 5], "length": 2,
                                  "period": 7}),
    ("offline", N, "offline", {"start": [0] * N, "length": 2, "period": 7}),
]


def test_structure_groups_with_faults_match_jax():
    tcells = [_scenario(TE, name, n, f, **kw) for name, n, f, kw in GROUP_CELLS]
    jcells = [_scenario(JE, name, n, f, **kw) for name, n, f, kw in GROUP_CELLS]
    p = np.full(N, 1.0 / N, np.float32)
    jsim = JSim(grads_fn=None, p=jnp.asarray(p), optimizer=j_sgd(0.01))
    tsim = TSim(grads_fn=None, p=p, optimizer=t_sgd(0.01), device="cpu")
    _, _, jgroups = JE.engine.resolve_structure_groups(jcells, sim=jsim)
    _, _, tgroups = TE.resolve_structure_groups(tcells, sim=tsim)
    members = [g.members for g in tgroups]
    assert members == [g.members for g in jgroups]
    assert [g.ragged for g in tgroups] == [g.ragged for g in jgroups]
    names = [[GROUP_CELLS[i][0] for i in m] for m in members]
    # delay 1 and 3 apart; scalar and per-client rates apart; a ragged
    # stale cell with its full-capacity twin; the two offline cells
    # (both per-client starts after padding) together.
    assert ["drop_scalar", "drop_scalar_b"] in names
    assert ["stale_d3", "stale_d3_n6"] in names
    assert ["offline_n6", "offline"] in names
    assert len(tgroups) == 7


@pytest.fixture(scope="module")
def problems():
    jprob = jconv.make_quadratic(jax.random.PRNGKey(2), N, dim=DIM,
                                 hetero=1.0)
    tprob = tconv.QuadraticProblem(
        a=torch.tensor(np.asarray(jprob.a)), b=torch.tensor(np.asarray(jprob.b)),
        p=torch.tensor(np.asarray(jprob.p)),
        w_star=torch.tensor(np.asarray(jprob.w_star)),
        mu=jprob.mu, lsmooth=jprob.lsmooth)
    return jprob, tprob


STUDY_CELLS = [
    ("clean", N, None, {}, "alg1"),
    ("drop", N, "drop", {"rate": 0.3}, "alg1"),
    ("drop_n6", 6, "drop", {"rate": [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]}, "alg1"),
    ("stale", N, "stale", {"rate": 0.5, "delay": 3}, "alg2"),
    ("stale_n6", 6, "stale", {"rate": 0.5, "delay": 3}, "alg2"),
    ("offline_n6", 6, "offline", {"start": [0, 2, 4, 6, 8, 10], "length": 3,
                                  "period": 9}, "benchmark1"),
    ("leak", N, "drop_corrupt", {"drop_rate": 1.0, "corrupt_rate": 1.0,
                                 "scale": NAN}, "oracle"),
    ("poison", N, "corrupt", {"rate": 0.2, "scale": NAN}, "oracle"),
]


def _study_cells(E):
    return [_scenario(E, name, n, f, sched=s,
                      arrivals="binary" if s == "alg2" else "periodic", **kw)
            for name, n, f, kw, s in STUDY_CELLS]


@pytest.mark.parametrize("sequential", [False, True],
                         ids=["grouped", "sequential"])
def test_fault_study_matches_jax(problems, sequential):
    jprob, tprob = problems
    seeds = [0, 3]
    jres = JE.execute_cells(
        _study_cells(JE), sim=JSim(
            grads_fn=lambda w, k, t: jprob.all_grads(w, key=k, noise=0.05),
            p=jprob.p, optimizer=j_sgd(0.02), loss_fn=jprob.suboptimality),
        params0=jnp.asarray(W0), num_steps=T, seeds=seeds,
        eval_fn=lambda w: {"subopt": jprob.suboptimality(w)},
        eval_every=EVAL_EVERY, sequential=sequential)
    tres = TE.execute_cells(
        _study_cells(TE), sim=TSim(
            grads_fn=lambda w, k, t: tprob.all_grads(w, key=k, noise=0.05),
            p=tprob.p, optimizer=t_sgd(0.02), loss_fn=tprob.suboptimality,
            use_kernel=True, device="cpu"),
        params0=torch.from_numpy(W0), num_steps=T, seeds=seeds,
        eval_fn=lambda w: {"subopt": tprob.suboptimality(w)},
        eval_every=EVAL_EVERY, sequential=sequential)
    assert list(tres) == list(jres)
    for name in tres:
        t, j = tres[name], jres[name]
        for got, want in ((t.history.participation, j.history.participation),
                          (t.history.finite, j.history.finite),
                          (t.diverged, j.diverged)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
        for got, want in ((t.history.loss, j.history.loss),
                          (t.history.weight_sum, j.history.weight_sum),
                          (t.params, j.params),
                          (t.evals["subopt"], j.evals["subopt"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    leak, poison = tres["leak"], tres["poison"]
    assert bool(leak.history.finite.all()) and leak.diverged.tolist() == [-1, -1]
    assert bool((leak.history.weight_sum == 0).all())
    assert torch.equal(leak.params, torch.from_numpy(W0).expand(2, DIM))
    assert poison.diverged.tolist() == [0, 0]


# ---------------------------------------------- inside the port, bitwise

RATE0 = {
    "drop": {"rate": 0.0},
    "corrupt": {"rate": 0.0, "scale": 0.0},
    "stale": {"rate": 0.0, "delay": 2},
    "offline": {"start": 0, "length": 0},
    "drop_corrupt": {"drop_rate": 0.0, "corrupt_rate": 0.0, "scale": 0.0},
}
SCHEDULERS = ("alg1", "alg2", "benchmark1", "benchmark2", "oracle",
              "battery_adaptive")


def _assert_bitwise(a, b):
    la, lb = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_rate0_is_the_identity(problems, scheduler):
    """Every family at rate 0 gives the fault-free run bit for bit,
    through the plain K2 (sgd) and, for one scheduler, K1 (momentum)."""
    _, tprob = problems
    opts = [t_sgd] + ([t_momentum] if scheduler == "alg1" else [])
    for opt in opts:
        sim = TSim(grads_fn=lambda w, k, t: tprob.all_grads(w, key=k,
                                                            noise=0.05),
                   p=tprob.p, optimizer=opt(0.02), loss_fn=tprob.suboptimality,
                   use_kernel=True, device="cpu")
        cells = [_scenario(TE, "clean", N, sched=scheduler, arrivals="binary")]
        cells += [_scenario(TE, kind, N, kind, sched=scheduler,
                            arrivals="binary", **kw)
                  for kind, kw in RATE0.items()]
        out = TE.execute_cells(cells, sim=sim, params0=torch.from_numpy(W0),
                               num_steps=T, seeds=[1])
        for kind in RATE0:
            _assert_bitwise(out[kind], out["clean"])


def _dyadic_sim(n, p):
    """A sim whose client sum is exact in any order: constant dyadic
    gradient rows, dyadic weights (p below, integer gaps of periodic
    arrivals), a dyadic step size."""
    rows = torch.tensor([[(i + 1) / 8.0, -(i % 3) / 4.0, 0.5] for i in range(n)])
    return TSim(grads_fn=lambda w, k, t: rows.clone(), p=p,
                optimizer=t_sgd(1 / 16), loss_fn=lambda w: torch.sum(w * w),
                use_kernel=True, device="cpu")


PADDED = [("drop", {"rate": [0.5, 0.1, 0.9, 0.3, 0.7, 0.2]}),
          ("corrupt", {"rate": [0.5] * 6, "scale": 2.0}),
          ("stale", {"rate": [0.6] * 6, "delay": 2}),
          ("offline", {"start": [0, 1, 2, 3, 4, 5], "length": 2,
                       "period": [3, 0, 4, 5, 0, 6]}),
          ("drop_corrupt", {"drop_rate": [0.3] * 6, "corrupt_rate": 0.5,
                            "scale": 4.0})]


@pytest.mark.parametrize("kind,kw", PADDED, ids=[k for k, _ in PADDED])
def test_padded_fault_cell_equals_natural_run(kind, kw):
    """n = 6 clients run alone and padded to 8 inside the engine: the
    same rows faulted, the same participation, weight_sum, params and
    loss, bit for bit (the JAX package's own ragged property tests are
    red on this tree, ROADMAP caveat R2)."""
    p8 = torch.tensor([1 / 16] * 4 + [1 / 8] * 2 + [1 / 4] * 2)
    p6 = TE.subpopulation_p(p8, 6, 6)
    assert torch.equal(p6, torch.tensor([1 / 8] * 4 + [1 / 4] * 2))
    sc = TE.Scenario(name="c", scheduler="alg1", arrivals="periodic",
                     n_clients=6, horizon=T + 1, taus=[1, 2, 4, 8, 2, 4],
                     faults=kind, fault_kwargs=kw)
    run = dict(params0=torch.full((3,), 4.0), num_steps=T, seeds=[0, 5])
    nat = TE.execute_cells([sc], sim=_dyadic_sim(6, p6), **run)["c"]
    pad = TE.execute_cells([sc], sim=_dyadic_sim(8, p8), **run)["c"]
    _assert_bitwise(nat, pad)
    ws = nat.history.weight_sum
    assert bool((ws > 0).any()) and bool((ws == 0).any() or kind == "corrupt")


@pytest.mark.parametrize("opt,kernel", [(t_sgd, "K2"), (t_momentum, "K1")],
                         ids=["sgd-K2", "momentum-K1"])
def test_dropped_nan_rows_are_exact_zeros(problems, opt, kernel):
    """drop_corrupt with every row NaN-poisoned and dropped: through the
    plain versions of K2 and K1 the params never move and stay finite,
    ``weight_sum`` is 0 and nothing diverges."""
    _, tprob = problems
    sim = TSim(grads_fn=lambda w, k, t: tprob.all_grads(w, key=k, noise=0.05),
               p=tprob.p, optimizer=opt(0.02), loss_fn=tprob.suboptimality,
               use_kernel=True, device="cpu")
    leak = _scenario(TE, "leak", N, "drop_corrupt", drop_rate=1.0,
                     corrupt_rate=1.0, scale=NAN)
    cell = TE.execute_cells([leak], sim=sim, params0=torch.from_numpy(W0),
                            num_steps=T, seeds=[0, 1, 2])["leak"]
    assert bool(cell.history.finite.all())
    assert bool((cell.history.weight_sum == 0).all())
    assert torch.equal(cell.params, torch.from_numpy(W0).expand(3, DIM))
    loss = cell.history.loss
    assert torch.equal(loss, loss[:, :1].expand_as(loss))
    assert cell.diverged.tolist() == [-1, -1, -1]
