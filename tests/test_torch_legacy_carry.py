"""Port parity for the legacy per-leaf carry.

``ClientSimulator(flat=False)`` and, under the default ``flat=None``, a
parameter tree of mixed dtypes run the pytree carry: params and
optimizer state stay trees in their leaves' dtypes, and each step
aggregates leaf by leaf (K1 once a leaf under ``use_kernel``). The Fig-1
CNN at the small size of ``test_torch_trainer.py`` (8×8 images, N = 8,
batch 2, 10 steps) runs in two forms: all f32 under ``flat=False``
("legacy"), and with its four biases in bf16 under ``flat=None``
("mixed"). The same numpy inputs go through both packages, the JAX
params carried over by ``params_from_jax``.

Each (form, optimizer) runs once in the JAX package, through its plain
``init`` and ``run_carry``, the two calls its ``run`` makes (the legacy
route does not reach ROADMAP caveat R1): through its kernel route in
interpret mode for sgd, its plain route for momentum and adam. Both port routes (``use_kernel`` on and off) are held
against that run; the port's ``init`` + ``step`` and ``init`` +
``run_carry`` against its ``run`` bit for bit (adam with ``eps=1e-5``,
see ``ADAM_EPS``). Tolerances:
participation, ``t`` and ``finite`` bitwise; ``weight_sum``
``rtol=1e-6``; f32 leaves and the loss ``rtol=1e-4, atol=1e-5``; bf16
leaves ``rtol=2e-2, atol=2e-2`` (the JAX package's own tolerance for its
mixed-dtype test, ``tests/test_aggregation_flat.py``).

Per module: ``aggregate_client_grads_flat``, ``_kernel`` and
``_kernel_per_leaf`` on a mixed tree (and the flat ones on an f32 tree)
with a masked NaN row: the masked row gives exact zeros, f32 leaves
within ``rtol=1e-6`` of JAX's, bf16 leaves within one bf16 ulp;
``server_update`` likewise; ``make_image_classification`` bit for bit.

The engine on a mixed quadratic tree (an f32 and a bf16 leaf): grouped
and sequential against JAX's ``execute_cells`` (participation bitwise,
the tolerances above), a checkpointed study bitwise the uninterrupted
one, resumed after an injected preemption, and against JAX's
resumable run; a ``StudyService`` request and ``recover()`` bitwise the
solo ``Study.run``. Refusals: JAX's ``ValueError``s for ``flat=True`` on
a mixed tree and for faults on the tree carry. The clients-mesh
refusal and the cells mesh are held on gloo ranks in
``tests/test_torch_client_sharding.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro import experiments as JE
from repro.core import ClientSimulator as JSim
from repro.core import DeterministicArrivals as JDet
from repro.core import aggregation as jagg
from repro.core import convergence as jconv
from repro.core import make_scheduler as j_make_scheduler
from repro.core.faults import StaleUpdates as JStale
from repro.data import ClientBatcher as JBatcher
from repro.data import synthetic as jsyn
from repro.models.cnn import cnn_loss as j_loss
from repro.models.cnn import init_cnn as j_init_cnn
from repro.optim import adam as j_adam
from repro.optim import momentum as j_momentum
from repro.optim import sgd as j_sgd
from repro_torch import experiments as TE
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.convert import carry_from_jax, params_from_jax
from repro_torch.core import ClientSimulator as TSim
from repro_torch.core import DeterministicArrivals as TDet
from repro_torch.core import StaleUpdates
from repro_torch.core import aggregation as tagg
from repro_torch.core import convergence as tconv
from repro_torch.core import make_scheduler as t_make_scheduler
from repro_torch.data import ClientBatcher as TBatcher
from repro_torch.data import make_image_classification
from repro_torch.models.cnn import client_grads_fn
from repro_torch.models.cnn import cnn_loss as t_loss
from repro_torch.optim import adam as t_adam
from repro_torch.optim import momentum as t_momentum
from repro_torch.optim import sgd as t_sgd
from repro_torch.serve import StudyService

N, HW, BATCH, T = 8, 8, 2, 10
TAUS = np.array([1, 2, 4, 8] * 2)
# Adam's eps is 1e-5, not 1e-8: Adam's first step scales every gradient
# element to about lr, so an element that is rounding noise of its own
# client sum (4e-9 in conv2's weights at step 0, summed 1.6 % apart by
# XLA and torch) would move by lr·(its relative difference); eps bounds
# that gain at lr·|g|/eps.
ADAM_EPS = 1e-5
OPTS = {"sgd": (j_sgd, t_sgd), "momentum": (j_momentum, t_momentum),
        "adam": (lambda lr: j_adam(lr, eps=ADAM_EPS),
                 lambda lr: t_adam(lr, eps=ADAM_EPS))}
LR = {"sgd": 0.05, "momentum": 0.02, "adam": 0.01}
JAX_KERNEL = {"sgd": True, "momentum": False, "adam": False}
FORMS = {"legacy": False, "mixed": None}
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N * 6, HW, HW, 3)).astype(np.float32)
    y = rng.integers(0, 10, N * 6).astype(np.int32)
    per = [{"x": x[i * 6:(i + 1) * 6], "y": y[i * 6:(i + 1) * 6]}
           for i in range(N)]
    return per, x[:16], y[:16]


_PARAMS: dict = {}


def _jax_params(form):
    """The CNN's JAX params (numpy leaves), once a process: all f32, or
    ("mixed") its biases in bf16."""
    if form not in _PARAMS:
        params = jax.jit(lambda k: j_init_cnn(k, image_hw=HW))(
            jax.random.PRNGKey(1))
        if form == "mixed":
            params = jax.tree_util.tree_map_with_path(
                lambda path, v: v.astype(jnp.bfloat16)
                if path[-1].key == "b" else v, params)
        _PARAMS[form] = jax.tree_util.tree_map(np.asarray, params)
    return _PARAMS[form]


def _sims(form, opt, use_kernel, jax_kernel):
    """The same simulator in both packages: (jax sim, torch sim, jax
    params, torch params)."""
    per, ex, ey = _data()
    jb = JBatcher(per, BATCH, seed=0)
    tb = TBatcher(per, BATCH, seed=0, device="cpu")

    def jgrads(params, key, t):
        batch = jb.sample(key)
        return jax.vmap(lambda a, b: jax.grad(j_loss)(params, a, b))(
            batch["x"], batch["y"])

    jopt, topt = OPTS[opt]
    jsim = JSim(grads_fn=jgrads, p=jb.p, optimizer=jopt(LR[opt]),
                scheduler=j_make_scheduler("alg1", N),
                energy=JDet.periodic(TAUS, T),
                loss_fn=lambda p: j_loss(p, jnp.asarray(ex), jnp.asarray(ey)),
                use_kernel=jax_kernel, flat=FORMS[form])
    tsim = TSim(grads_fn=client_grads_fn(tb), p=tb.p,
                optimizer=topt(LR[opt]),
                scheduler=t_make_scheduler("alg1", N),
                energy=TDet.periodic(TAUS, T),
                loss_fn=lambda p: t_loss(p, torch.from_numpy(ex),
                                         torch.from_numpy(ey)),
                use_kernel=use_kernel, flat=FORMS[form], device="cpu")
    jparams = _jax_params(form)
    return jsim, tsim, jparams, params_from_jax(jparams, device="cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _assert_leaves(got, want, f32_tol=F32_TOL, bf16_tol=BF16_TOL):
    """Each leaf of ``got`` (torch) in ``want``'s (JAX) dtype, f32 leaves
    within ``f32_tol``, bf16 leaves within ``bf16_tol``."""
    tl, jl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        tol = bf16_tol if t.dtype == torch.bfloat16 else f32_tol
        np.testing.assert_allclose(_np(t), _np(j), **tol)


def _assert_history(th, jh):
    np.testing.assert_array_equal(th.participation.numpy(),
                                  np.asarray(jh.participation))
    np.testing.assert_array_equal(th.finite.numpy(), np.asarray(jh.finite))
    np.testing.assert_allclose(th.weight_sum.numpy(), np.asarray(jh.weight_sum),
                               rtol=1e-6)
    np.testing.assert_allclose(th.loss.numpy(), np.asarray(jh.loss),
                               **F32_TOL)
    assert th.finite.all()


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


_JAX_RUNS: dict = {}


def _jax_run(form, opt):
    """JAX's run of (form, optimizer), once per process: its ``init``,
    then ``run_carry`` of T steps, the two calls its ``run`` makes on the
    legacy route, compiled by XLA without excess precision (each bf16
    operation rounds, as JAX's semantics and the port do; XLA's default
    lets a fusion skip the rounding of momentum's bf16 velocity before
    its f32 step, which moves a bf16 bias by an ulp now and then and
    the loss by up to 1e-4 within 10 steps). Returns (the compiled
    advance, the carry after T steps, the history)."""
    if (form, opt) not in _JAX_RUNS:
        jsim, _, jparams, _ = _sims(form, opt, False, JAX_KERNEL[opt])
        c0 = jsim.init(jax.random.PRNGKey(7), jparams)
        advance = jax.jit(lambda c: jsim.run_carry(c, T)).lower(c0).compile(
            compiler_options={"xla_allow_excess_precision": False})
        _JAX_RUNS[form, opt] = (advance, *advance(c0))
    return _JAX_RUNS[form, opt]


# ------------------------------------------------------------ the slice

@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "matvec"])
@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_slice_matches_jax(form, opt, use_kernel):
    _, jc, jh = _jax_run(form, opt)
    jp = jc.params
    _, tsim, _, tparams = _sims(form, opt, use_kernel, JAX_KERNEL[opt])
    assert tsim.flat_spec(tparams) is None
    key = trandom.PRNGKey(7, device="cpu")
    tp, th = tsim.run(key, tparams, T)
    _assert_history(th, jh)
    _assert_leaves(tp, jp)
    assert np.asarray(jh.participation).sum() > 0

    # init + step, and init + run_carry, are the run's rounds bit for bit.
    carry = tsim.init(key, tparams)
    assert not isinstance(carry.params, torch.Tensor)
    rounds = []
    for _ in range(T):
        carry, out = tsim.step(carry)
        rounds.append(out["participation"])
    assert int(carry.t) == T
    _bitwise(carry.params, tp)
    assert torch.equal(torch.stack(rounds), th.participation)
    resumed, hist = tsim.run_carry(tsim.init(key, tparams), T)
    _bitwise(resumed, carry)
    _bitwise(tuple(hist), tuple(th))
    # The optimizer state on the tree: momentum's velocity in each leaf's
    # dtype, adam's moments in f32, as JAX keeps them.
    _assert_leaves(resumed.opt_state, jc.opt_state)


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_carry_from_jax_tree_resumes(opt):
    """JAX's tree carry after T steps (bf16 biases), converted bit for
    bit, continues T more as the JAX run does: params, and the optimizer
    state (momentum's velocity in each leaf's dtype, adam's moments in
    f32) within the tolerances."""
    advance, jc, _ = _jax_run("mixed", opt)
    _, tsim, _, _ = _sims("mixed", opt, True, False)
    tc = carry_from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    assert type(tc.opt_state).__name__ == type(jc.opt_state).__name__
    for t, j in zip(tree_leaves(tuple(tc)), jax.tree_util.tree_leaves(jc)):
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          np.asarray(j).view(np.int16))
    jc, jh = advance(jc)
    tc, th = tsim.run_carry(tc, T)
    _assert_history(th, jh)
    assert int(tc.t) == int(jc.t) == 2 * T
    np.testing.assert_array_equal(tc.key.numpy(), np.asarray(jc.key))
    _assert_leaves(tc.params, jc.params)
    _assert_leaves(tc.opt_state, jc.opt_state)
    if opt == "momentum":
        assert tc.opt_state.velocity["conv1"]["b"].dtype == torch.bfloat16
    else:
        assert {x.dtype for x in tree_leaves((tc.opt_state.mu,
                                              tc.opt_state.nu))} == \
            {torch.float32}


# --------------------------------------------------------- per module

def _grad_trees(kind):
    """(jax tree, torch tree, weights, mask) of stacked (N, ...) client
    gradients; row 2 holds NaN and is masked out."""
    rng = np.random.default_rng(3)
    shapes = {"a": (N, 3, 4), "b": (N, 10), "c": (N, 64), "d": (N, 2, 16)}
    tree = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    for v in tree.values():
        v[2] = np.nan
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    if kind == "mixed":
        jtree["b"] = jtree["b"].astype(jnp.bfloat16)
        jtree["d"] = jtree["d"].astype(jnp.bfloat16)
    ttree = params_from_jax(jax.tree_util.tree_map(np.asarray, jtree),
                            device="cpu")
    w = (rng.uniform(size=N) * 2.0 / N).astype(np.float32)
    mask = np.ones(N, np.float32)
    mask[2] = 0.0
    return jtree, ttree, w, mask


def _within_one_bf16_ulp(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    got = np.asarray(got.float(), np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


AGG_FNS = {
    "flat": lambda m, g, w, mask: m.aggregate_client_grads_flat(
        g, w, mask=mask),
    "flat_kernel": lambda m, g, w, mask: m.aggregate_client_grads_flat(
        g, w, use_kernel=True, mask=mask),
    "kernel": lambda m, g, w, mask: m.aggregate_client_grads_kernel(
        g, w, mask=mask),
    "kernel_per_leaf": lambda m, g, w, mask:
        m.aggregate_client_grads_kernel_per_leaf(g, w, mask),
}


@pytest.mark.parametrize("kind", ["mixed", "f32"])
@pytest.mark.parametrize("fn", sorted(AGG_FNS))
def test_aggregation_matches_jax(fn, kind):
    jtree, ttree, w, mask = _grad_trees(kind)
    want = AGG_FNS[fn](jagg, jtree, jnp.asarray(w), jnp.asarray(mask))
    got = AGG_FNS[fn](tagg, ttree, torch.from_numpy(w), torch.from_numpy(mask))
    # The masked NaN row gives exact zeros: the same bits as the tree
    # with that row zeroed.
    zeroed = tree_map(lambda x: torch.where(
        torch.from_numpy(mask).reshape((-1,) + (1,) * (x.dim() - 1)) > 0,
        x, torch.zeros((), dtype=x.dtype)), ttree)
    _bitwise(got, AGG_FNS[fn](tagg, zeroed, torch.from_numpy(w),
                              torch.from_numpy(mask)))
    for t, j in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        assert bool(torch.isfinite(t).all())
        if t.dtype == torch.bfloat16:
            _within_one_bf16_ulp(t, j)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-7)


def test_server_update_matches_jax():
    jtree, ttree, w, mask = _grad_trees("mixed")
    jparams = jax.tree_util.tree_map(lambda x: x[0], jtree)
    tparams = tree_map(lambda x: x[0], ttree)
    jagg_ = jagg.aggregate_client_grads(jtree, jnp.asarray(w), jnp.asarray(mask))
    tagg_ = tagg.aggregate_client_grads(ttree, torch.from_numpy(w),
                                        torch.from_numpy(mask))
    want = jagg.server_update(jax.tree_util.tree_map(jnp.nan_to_num, jparams),
                              jagg_, 0.05)
    got = tagg.server_update(tree_map(torch.nan_to_num, tparams), tagg_, 0.05)
    for t, j in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        if t.dtype == torch.bfloat16:
            _within_one_bf16_ulp(t, j)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("seed,n,shape,kw", [
    (0, 64, (32, 32, 3), {}), (5, 17, (8, 8, 1), {"noise": 0.9}),
    (11, 9, (12, 12, 3), {"n_classes": 4, "prototype_smoothness": 5})])
def test_make_image_classification_bitwise(seed, n, shape, kw):
    want = jsyn.make_image_classification(seed, n, image_shape=shape, **kw)
    got = make_image_classification(seed, n, image_shape=shape, **kw)
    assert got.n_classes == want.n_classes
    for a, b in ((got.images, want.images), (got.labels, want.labels)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- the engine

Q_N, Q_DIM, Q_STEPS = 8, 4, 12


@pytest.fixture(scope="module")
def quad():
    """A mixed quadratic tree in both packages: the same problem drives
    an f32 leaf ``w`` and a bf16 leaf ``v`` (its gradient rounded to
    bf16), so the simulator takes the legacy carry."""
    tprob = tconv.make_quadratic(trandom.PRNGKey(0, device="cpu"), Q_N,
                                 dim=Q_DIM)
    jprob = jconv.QuadraticProblem(
        a=jnp.asarray(tprob.a.numpy()), b=jnp.asarray(tprob.b.numpy()),
        p=jnp.asarray(tprob.p.numpy()), w_star=jnp.asarray(tprob.w_star.numpy()),
        mu=tprob.mu, lsmooth=tprob.lsmooth)

    def jgrads(tree, k, t):
        return {"w": jprob.all_grads(tree["w"], key=k, noise=0.05),
                "v": jprob.all_grads(tree["v"].astype(jnp.float32))
                .astype(jnp.bfloat16)}

    def tgrads(tree, k, t):
        return {"w": tprob.all_grads(tree["w"], key=k, noise=0.05),
                "v": tprob.all_grads(tree["v"].float()).bfloat16()}

    jloss = lambda tree: jprob.suboptimality(tree["w"])  # noqa: E731
    tloss = lambda tree: tprob.suboptimality(tree["w"])  # noqa: E731
    jsim = JSim(grads_fn=jgrads, p=jprob.p, optimizer=j_sgd(0.02),
                loss_fn=jloss, use_kernel=False)
    tsim = TSim(grads_fn=tgrads, p=tprob.p, optimizer=t_sgd(0.02),
                loss_fn=tloss, use_kernel=True, device="cpu")
    j0 = {"w": jnp.full((Q_DIM,), 4.0),
          "v": jnp.full((Q_DIM,), 3.0, jnp.bfloat16)}
    t0 = {"w": torch.full((Q_DIM,), 4.0),
          "v": torch.full((Q_DIM,), 3.0, dtype=torch.bfloat16)}
    assert tsim.flat_spec(t0) is None
    return dict(jsim=jsim, tsim=tsim, j0=j0, t0=t0, tgrads=tgrads,
                tprob=tprob, tloss=tloss)


def _scenarios(E):
    """One ragged structure group: alg2 on binary arrivals at n = 6 and
    8 in a capacity of 8."""
    return [E.Scenario(name=f"alg2_n{n}", scheduler="alg2", arrivals="binary",
                       n_clients=n, horizon=Q_STEPS + 1) for n in (6, Q_N)]


def _cells_like_jax(tres, jres):
    assert list(tres) == list(jres)
    for name in tres:
        t, j = tres[name], jres[name]
        for got, want in ((t.history.participation, j.history.participation),
                          (t.history.finite, j.history.finite),
                          (t.diverged, j.diverged)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
        for got, want in ((t.history.loss, j.history.loss),
                          (t.history.weight_sum, j.history.weight_sum)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        _assert_leaves(t.params, j.params, dict(rtol=1e-5, atol=1e-6))


def _grids_bitwise(a, b):
    assert list(a) == list(b)
    for name in a:
        _bitwise(tuple(a[name]), tuple(b[name]))


def test_engine_grouped_and_sequential_match_jax(quad):
    kw = dict(num_steps=Q_STEPS, seeds=2)
    jres = JE.execute_cells(_scenarios(JE), sim=quad["jsim"],
                            params0=quad["j0"], **kw)
    grouped = TE.execute_cells(_scenarios(TE), sim=quad["tsim"],
                               params0=quad["t0"], **kw)
    sequential = TE.execute_cells(_scenarios(TE), sim=quad["tsim"],
                                  params0=quad["t0"], sequential=True, **kw)
    _cells_like_jax(grouped, jres)
    _grids_bitwise(sequential, grouped)
    assert grouped["alg2_n8"].params["v"].dtype == torch.bfloat16


def test_resumable_legacy_study_bitwise_and_like_jax(quad, tmp_path,
                                                     monkeypatch):
    kw = dict(num_steps=Q_STEPS, seeds=2)
    plain = TE.execute_cells(_scenarios(TE), sim=quad["tsim"],
                             params0=quad["t0"], **kw)
    whole = TE.execute_cells_resumable(
        _scenarios(TE), sim=quad["tsim"], params0=quad["t0"],
        checkpoint_dir=str(tmp_path / "whole"), checkpoint_every=5, **kw)
    _grids_bitwise(whole, plain)
    jres = JE.execute_cells_resumable(
        _scenarios(JE), sim=quad["jsim"], params0=quad["j0"],
        checkpoint_dir=str(tmp_path / "j"), **kw)
    _cells_like_jax(whole, jres)

    # A preemption after the second checkpoint, then a resume from the
    # directory: bitwise the uninterrupted run, the bf16 leaves of the
    # saved tree carries restored bit for bit.
    real_save, saves = CheckpointManager.save, [0]

    def dying_save(self, step, state):
        if saves[0] >= 2:
            raise RuntimeError("injected preemption")
        saves[0] += 1
        return real_save(self, step, state)

    monkeypatch.setattr(CheckpointManager, "save", dying_save)
    cut = str(tmp_path / "cut")
    with pytest.raises(RuntimeError, match="injected preemption"):
        TE.execute_cells_resumable(
            _scenarios(TE), sim=quad["tsim"], params0=quad["t0"],
            checkpoint_dir=cut, checkpoint_every=5, **kw)
    monkeypatch.setattr(CheckpointManager, "save", real_save)
    assert latest_step(f"{cut}/g000") == 10
    with np.load(f"{cut}/g000/step_10.npz") as saved:
        assert {"carry/params/v", "carry/params/w"} <= set(saved.files)
    resumed = TE.execute_cells_resumable(
        _scenarios(TE), sim=quad["tsim"], params0=quad["t0"],
        checkpoint_dir=cut, checkpoint_every=5, **kw)
    _grids_bitwise(resumed, whole)


def _service(quad, root):
    return StudyService(params0=quad["t0"], grads_fn=quad["tgrads"],
                        p=quad["tprob"].p, optimizer=t_sgd(0.02),
                        loss_fn=quad["tloss"], use_kernel=True, device="cpu",
                        checkpoint_root=root)


def test_service_request_and_recover(quad, tmp_path):
    study = (TE.Study("legacy", num_steps=Q_STEPS).axis("scheduler", "alg1")
             .axis("arrivals", "periodic").axis("n_clients", [5, Q_N])
             .axis("seeds", [0, 1]))
    solo = study.run(params0=quad["t0"], grads_fn=quad["tgrads"],
                     p=quad["tprob"].p, optimizer=t_sgd(0.02),
                     loss_fn=quad["tloss"], use_kernel=True, device="cpu")
    root = str(tmp_path)
    svc = _service(quad, root)
    rid = svc.submit(study.to_json(), TE.ExecutionConfig(checkpoint_every=5))
    (resp,) = svc.flush()
    assert resp.error is None
    _grids_bitwise(solo.cells, svc.result(rid).result.cells)
    fresh = _service(quad, root)
    (rid2,) = fresh.recover()
    again = fresh.result(rid2)
    assert again.error is None and again.batch["chunks"] == 0
    _grids_bitwise(solo.cells, again.result.cells)


# ----------------------------------------------------------- refusals

def test_refusals_match_jax(quad):
    """``flat=True`` on a mixed tree, and faults on the tree carry (at
    ``init``, and at ``run`` with ``flat=False``), raise JAX's errors."""
    jtree, ttree = quad["j0"], quad["t0"]
    jsim = JSim(grads_fn=quad["jsim"].grads_fn, p=quad["jsim"].p,
                optimizer=j_sgd(0.1), flat=True)
    tsim = TSim(grads_fn=quad["tgrads"], p=quad["tprob"].p,
                optimizer=t_sgd(0.1), flat=True, device="cpu")
    for fn, tree in ((jsim.flat_spec, jtree), (tsim.flat_spec, ttree)):
        with pytest.raises(ValueError, match="single leaf dtype"):
            fn(tree)
    jf = JSim(grads_fn=quad["jsim"].grads_fn, p=quad["jsim"].p,
              optimizer=j_sgd(0.1), flat=False)
    with pytest.raises(ValueError) as jerr:
        jf.run(jax.random.PRNGKey(0), jtree, 2, faults=JStale(0.5, delay=2),
               scheduler=j_make_scheduler("alg1", Q_N),
               energy=JDet.periodic(TAUS, 4))
    tf = TSim(grads_fn=quad["tgrads"], p=quad["tprob"].p,
              optimizer=t_sgd(0.1), flat=False, device="cpu",
              faults=StaleUpdates(0.5, delay=2))
    comps = dict(scheduler=t_make_scheduler("alg1", Q_N),
                 energy=TDet.periodic(TAUS, 4))
    key = trandom.PRNGKey(0, device="cpu")
    for call in (lambda: tf.run(key, ttree, 2, **comps),
                 lambda: tf.init(key, ttree, **comps)):
        with pytest.raises(ValueError) as terr:
            call()
        assert str(terr.value) == str(jerr.value).replace(
            "repro.core.faults", "repro_torch.core.faults")
