"""Port parity for the slice as a whole: the ClientSimulator loop.

The Fig-1 CNN at a small size (8×8 images, N = 8 clients, per-client
batch 2, periodic energy with τ = (1, 2, 4, 8)) runs 10 steps in both
packages from the same seed: the JAX parameters are carried over with
``params_from_jax`` and the data comes from the same numpy arrays. The
JAX package runs through ``init`` + ``run_carry(donate=False)`` or
``run(eval_fn=…)``; its plain ``run`` trips over a fault of its own
(ROADMAP caveat R1). Tolerances: participation and ``t`` bitwise (same
threefry bits); ``weight_sum`` f32 ``rtol=1e-6``; flat params and loss
``rtol=1e-4, atol=1e-5`` (XLA and torch sum the convolutions in
different orders). The quadratic quickstart, the cheapest whole-loop
test, is in ``test_torch_convergence.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.core import ClientSimulator as JSim
from repro.core import DeterministicArrivals as JDet
from repro.core import make_scheduler as j_make_scheduler
from repro.data import ClientBatcher as JBatcher
from repro.models.cnn import cnn_accuracy as j_acc
from repro.models.cnn import cnn_loss as j_loss
from repro.models.cnn import init_cnn as j_init_cnn
from repro.optim import momentum as j_momentum
from repro.optim import sgd as j_sgd
from repro_torch import random as trandom
from repro_torch.convert import carry_from_jax, params_from_jax
from repro_torch.core import ClientSimulator as TSim
from repro_torch.core import DeterministicArrivals as TDet
from repro_torch.core import StaleUpdates
from repro_torch.core import make_scheduler as t_make_scheduler
from repro_torch.data import ClientBatcher as TBatcher
from repro_torch.models.cnn import client_grads_fn
from repro_torch.models.cnn import cnn_accuracy as t_acc
from repro_torch.models.cnn import cnn_loss as t_loss
from repro_torch.optim import momentum as t_momentum
from repro_torch.optim import sgd as t_sgd

N, HW, BATCH, T = 8, 8, 2, 10
TAUS = np.array([1, 2, 4, 8] * 2)
OPTS = {"sgd": (j_sgd, t_sgd), "momentum": (j_momentum, t_momentum)}


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N * 6, HW, HW, 3)).astype(np.float32)
    y = rng.integers(0, 10, N * 6).astype(np.int32)
    per = [{"x": x[i * 6:(i + 1) * 6], "y": y[i * 6:(i + 1) * 6]}
           for i in range(N)]
    return per, x[:16], y[:16]


def _pair(sched, opt, use_kernel):
    """The same simulator in both packages; returns (jax sim, torch sim,
    jax params, torch params)."""
    per, ex, ey = _data()
    jb = JBatcher(per, BATCH, seed=0)
    tb = TBatcher(per, BATCH, seed=0, device="cpu")

    def jgrads(params, key, t):
        batch = jb.sample(key)
        return jax.vmap(lambda a, b: jax.grad(j_loss)(params, a, b))(
            batch["x"], batch["y"])

    jopt, topt = OPTS[opt]
    jsim = JSim(grads_fn=jgrads, p=jb.p, optimizer=jopt(0.05),
                scheduler=j_make_scheduler(sched, N),
                energy=JDet.periodic(TAUS, T),
                loss_fn=lambda p: j_loss(p, jnp.asarray(ex), jnp.asarray(ey)),
                use_kernel=use_kernel)
    tsim = TSim(grads_fn=client_grads_fn(tb), p=tb.p, optimizer=topt(0.05),
                scheduler=t_make_scheduler(sched, N),
                energy=TDet.periodic(TAUS, T),
                loss_fn=lambda p: t_loss(p, torch.from_numpy(ex),
                                         torch.from_numpy(ey)),
                use_kernel=use_kernel, device="cpu")
    jparams = j_init_cnn(jax.random.PRNGKey(1), image_hw=HW)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jsim, tsim, jparams, tparams


def _assert_history(th, jh):
    np.testing.assert_array_equal(th.participation.numpy(),
                                  np.asarray(jh.participation))
    np.testing.assert_allclose(th.weight_sum.numpy(), np.asarray(jh.weight_sum),
                               rtol=1e-6)
    np.testing.assert_allclose(th.loss.numpy(), np.asarray(jh.loss),
                               rtol=1e-4, atol=1e-5)
    assert th.finite.all()


def _assert_carry(tc, jc):
    assert int(tc.t) == int(jc.t)
    np.testing.assert_array_equal(tc.key.numpy(), np.asarray(jc.key))
    np.testing.assert_allclose(tc.params.numpy(), np.asarray(jc.params),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sched,opt,use_kernel", [
    ("alg1", "sgd", True), ("alg1", "momentum", True),
    ("benchmark1", "sgd", True), ("benchmark1", "momentum", True),
    ("alg1", "sgd", False),
], ids=lambda v: {True: "kernel", False: "matvec"}.get(v, v))
def test_cnn_slice_matches_jax(sched, opt, use_kernel):
    jsim, tsim, jparams, tparams = _pair(sched, opt, use_kernel)
    spec = jsim.flat_spec(jparams)
    jc = jsim.init(jax.random.PRNGKey(7), jparams, spec=spec)
    jc, jh = jsim.run_carry(jc, T, spec=spec, donate=False)
    tspec = tsim.flat_spec(tparams)
    assert tspec.total == spec.total and tspec.shapes == spec.shapes
    tc = tsim.init(trandom.PRNGKey(7, device="cpu"), tparams, spec=tspec)
    tc, th = tsim.run_carry(tc, T, spec=tspec)
    _assert_history(th, jh)
    _assert_carry(tc, jc)
    assert np.asarray(jh.participation).sum() > 0


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_ragged_active_mask_matches_jax(opt):
    """active_mask zeroes two clients and p is renormalized over the
    rest (a ragged cell's override): the masked kernel bodies run, the
    masked clients never take part, and both packages agree."""
    active = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    p = active / active.sum()
    jsim, tsim, jparams, tparams = _pair("alg1", opt, True)
    spec = jsim.flat_spec(jparams)
    jc = jsim.init(jax.random.PRNGKey(3), jparams, spec=spec)
    jc, jh = jsim.run_carry(jc, T, spec=spec, donate=False, p=jnp.asarray(p),
                            active_mask=jnp.asarray(active))
    tspec = tsim.flat_spec(tparams)
    tc = tsim.init(trandom.PRNGKey(3, device="cpu"), tparams, spec=tspec)
    tc, th = tsim.run_carry(tc, T, spec=tspec, p=p, active_mask=active)
    _assert_history(th, jh)
    _assert_carry(tc, jc)
    assert not th.participation[:, active == 0].any()


def test_run_with_eval_matches_jax():
    jsim, tsim, jparams, tparams = _pair("benchmark1", "sgd", True)
    _, ex, ey = _data()
    jp, jh, jev = jsim.run(
        jax.random.PRNGKey(5), jparams, T, eval_every=5,
        eval_fn=lambda p: j_acc(p, jnp.asarray(ex), jnp.asarray(ey)))
    tp, th, tev = tsim.run(
        trandom.PRNGKey(5, device="cpu"), tparams, T, eval_every=5,
        eval_fn=lambda p: t_acc(p, torch.from_numpy(ex), torch.from_numpy(ey)))
    _assert_history(th, jh)
    assert tev.shape == (2,)
    np.testing.assert_allclose(tev.numpy(), np.asarray(jev), atol=1 / 16 + 1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jp), [tp[k][s] for k in sorted(tp)
                                                     for s in sorted(tp[k])]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        tsim.run(trandom.PRNGKey(5, device="cpu"), tparams, T, eval_every=3,
                 eval_fn=lambda p: t_acc(p, torch.from_numpy(ex),
                                         torch.from_numpy(ey)))


def test_carry_from_jax_resumes():
    """A JAX carry after 3 steps, converted, continues as the JAX run
    does: params, momentum state, appointments, key and t carry over."""
    jsim, tsim, jparams, tparams = _pair("alg1", "momentum", True)
    spec = jsim.flat_spec(jparams)
    jc = jsim.init(jax.random.PRNGKey(9), jparams, spec=spec)
    jc, _ = jsim.run_carry(jc, 3, spec=spec, donate=False)
    tc = carry_from_jax(jc, device="cpu")
    assert type(tc.opt_state).__name__ == "MomentumState"
    jc, jh = jsim.run_carry(jc, 4, spec=spec, donate=False)
    tc, th = tsim.run_carry(tc, 4, spec=tsim.flat_spec(tparams))
    _assert_history(th, jh)
    _assert_carry(tc, jc)


def test_step_is_one_round_of_run_carry():
    _, tsim, _, tparams = _pair("benchmark1", "momentum", True)
    spec = tsim.flat_spec(tparams)
    c0 = tsim.init(trandom.PRNGKey(4, device="cpu"), tparams, spec=spec)
    c1, out = tsim.step(c0, spec=spec)
    c2, hist = tsim.run_carry(c0, 1, spec=spec)
    assert int(c1.t) == int(c2.t) == 1
    assert torch.equal(c1.params, c2.params)
    assert torch.equal(c1.opt_state.velocity, c2.opt_state.velocity)
    assert torch.equal(out["participation"], hist.participation[0])
    assert int(c0.t) == 0, "the input carry stays valid"


def test_default_device_is_the_card():
    kw = dict(grads_fn=lambda p, k, t: p, p=np.ones(2) / 2,
              optimizer=t_sgd(0.1))
    if torch.cuda.is_available():
        assert TSim(**kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TSim(**kw)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trandom.PRNGKey(0)
    assert TSim(**kw, device="cpu").device.type == "cpu"


def test_unported_paths_raise():
    """The refusals the JAX package makes: ``flat=True`` on a mixed-dtype
    tree, faults on the legacy tree carry (``init`` without a spec, as
    in JAX), and faults under a client shard. ``faults=`` on the flat
    carry is accepted, and the constructor's component reaches the
    carry."""
    kw = dict(grads_fn=lambda p, k, t: p, p=np.ones(2) / 2,
              optimizer=t_sgd(0.1), device="cpu")
    mixed = {"a": torch.zeros(2), "b": torch.zeros(2, dtype=torch.float64)}
    with pytest.raises(ValueError, match="single leaf dtype"):
        TSim(**kw, flat=True).flat_spec(mixed)
    assert TSim(**kw).flat_spec(mixed) is None
    assert TSim(**kw, flat=False).flat_spec(torch.zeros(4)) is None
    stale = StaleUpdates(0.5, delay=3)
    faulty = TSim(**kw, faults=stale)
    assert faulty.faults is stale
    comps = dict(scheduler=t_make_scheduler("alg1", 2),
                 energy=TDet.periodic([1, 2], 4))
    w0 = torch.zeros(4)
    carry = faulty.init(trandom.PRNGKey(0, device="cpu"), w0,
                        spec=faulty.flat_spec(w0), **comps)
    assert carry.fault_state.shape == (3, 2, 4)
    with pytest.raises(ValueError, match="requires flat-carry execution"):
        faulty.init(trandom.PRNGKey(0, device="cpu"), w0, **comps)
    with pytest.raises(ValueError, match="requires flat-carry execution"):
        TSim(**kw, faults=stale, flat=False).run(
            trandom.PRNGKey(0, device="cpu"), w0, 2, **comps)
