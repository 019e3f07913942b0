"""Port parity: the convergence machinery and the quadratic quickstart.

``examples/quickstart.py``'s setting (8 clients, the paper's four energy
groups, noisy gradients, ``sgd(0.01)``, 1000 steps) runs through both
packages' ClientSimulator on the same problem. Participation is bitwise
and the parameter trajectory agrees to f32 ``rtol=1e-5``; the
suboptimality F(w) − F(w*) is a difference of two f32 values of size
|F(w*)|, so it is held to ``1e-5·|F(w*)|``. The Theorem-1 constants
agree to f32 ``rtol=1e-6``; ``make_quadratic`` (torch's QR and eigen
solvers on the same threefry draws) to ``rtol=1e-4``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.core import ClientSimulator as JSim
from repro.core import convergence as jconv
from repro.core import make_arrivals as j_make_arrivals
from repro.core import make_scheduler as j_make_scheduler
from repro.optim import sgd as j_sgd
from repro_torch import random as trandom
from repro_torch.core import ClientSimulator as TSim
from repro_torch.core import convergence as tconv
from repro_torch.core import make_arrivals as t_make_arrivals
from repro_torch.core import make_scheduler as t_make_scheduler
from repro_torch.optim import sgd as t_sgd


def _torch_problem(jprob):
    return tconv.QuadraticProblem(
        a=torch.tensor(np.asarray(jprob.a)), b=torch.tensor(np.asarray(jprob.b)),
        p=torch.tensor(np.asarray(jprob.p)),
        w_star=torch.tensor(np.asarray(jprob.w_star)),
        mu=jprob.mu, lsmooth=jprob.lsmooth)


def test_quadratic_quickstart_matches_jax():
    """The quickstart's problem: 8 clients, paper energy groups, noisy
    gradients, sgd(0.01), 1000 steps. The suboptimality trajectories of
    the two packages agree, and Algorithm 1 ends below both benchmarks."""
    n, steps = 8, 1000
    jprob = jconv.make_quadratic(jax.random.PRNGKey(0), n, dim=10, hetero=1.0)
    tprob = _torch_problem(jprob)
    finals = {}
    for sched in ("alg1", "benchmark1", "benchmark2"):
        jsim = JSim(grads_fn=lambda w, k, t: jprob.all_grads(w, key=k, noise=0.05),
                    p=jprob.p, optimizer=j_sgd(0.01),
                    scheduler=j_make_scheduler(sched, n),
                    energy=j_make_arrivals("periodic", n, steps),
                    loss_fn=jprob.suboptimality)
        tsim = TSim(grads_fn=lambda w, k, t: tprob.all_grads(w, key=k, noise=0.05),
                    p=tprob.p, optimizer=t_sgd(0.01),
                    scheduler=t_make_scheduler(sched, n),
                    energy=t_make_arrivals("periodic", n, steps),
                    loss_fn=tprob.suboptimality, device="cpu")
        w0 = np.full((10,), 5.0, np.float32)
        spec = jsim.flat_spec(jnp.asarray(w0))
        jc = jsim.init(jax.random.PRNGKey(1), jnp.asarray(w0), spec=spec)
        jc, jh = jsim.run_carry(jc, steps, spec=spec, donate=False)
        tw, th = tsim.run(trandom.PRNGKey(1, device="cpu"), torch.from_numpy(w0),
                          steps)
        np.testing.assert_array_equal(th.participation.numpy(),
                                      np.asarray(jh.participation))
        # F(w) − F(w*) is a difference of two f32 values of size
        # |F(w*)|, so it is resolved only to that scale.
        f_star = abs(float(jprob.global_loss(jprob.w_star)))
        np.testing.assert_allclose(th.loss.numpy(), np.asarray(jh.loss),
                                   rtol=1e-5, atol=1e-5 * f_star)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jc.params), rtol=1e-5,
                                   atol=1e-6)
        finals[sched] = float(th.loss[-100:].mean())
    assert finals["alg1"] < finals["benchmark1"]
    assert finals["alg1"] < finals["benchmark2"]


def test_theorem1_constants_match_jax():
    p = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    t_max = np.array([1, 5, 10, 20], np.float32)
    np.testing.assert_allclose(float(tconv.variance_constant(p, t_max, 2.5)),
                               float(jconv.variance_constant(p, t_max, 2.5)),
                               rtol=1e-6)
    t = np.arange(0, 200, 7)
    np.testing.assert_allclose(
        tconv.theorem1_bound(t, 3.0, 0.5, 4.0, 0.05, 1.7).numpy(),
        np.asarray(jconv.theorem1_bound(t, 3.0, 0.5, 4.0, 0.05, 1.7)), rtol=1e-6)
    assert tconv.error_floor(0.5, 4.0, 0.05, 1.7) == pytest.approx(
        jconv.error_floor(0.5, 4.0, 0.05, 1.7))
    assert tconv.max_step_size(0.5, 4.0) == jconv.max_step_size(0.5, 4.0)


def test_quadratic_problem_matches_jax():
    jprob = jconv.make_quadratic(jax.random.PRNGKey(3), 6, dim=5, hetero=2.0)
    tprob = tconv.make_quadratic(trandom.PRNGKey(3, device="cpu"), 6, dim=5,
                                 hetero=2.0)
    for name in ("a", "b", "p", "w_star"):
        np.testing.assert_allclose(getattr(tprob, name).numpy(),
                                   np.asarray(getattr(jprob, name)),
                                   rtol=1e-4, atol=1e-4)
    assert tprob.mu == pytest.approx(jprob.mu, rel=1e-4)
    assert tprob.lsmooth == pytest.approx(jprob.lsmooth, rel=1e-4)
    same = _torch_problem(jprob)
    w = np.linspace(-1, 1, 5).astype(np.float32)
    key = jax.random.PRNGKey(4)
    np.testing.assert_allclose(
        same.all_grads(torch.from_numpy(w)).numpy(),
        np.asarray(jprob.all_grads(jnp.asarray(w))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        same.all_grads(torch.from_numpy(w), trandom.PRNGKey(4, device="cpu"),
                       0.1).numpy(),
        np.asarray(jprob.all_grads(jnp.asarray(w), key, 0.1)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(float(same.suboptimality(torch.from_numpy(w))),
                               float(jprob.suboptimality(jnp.asarray(w))),
                               rtol=1e-5)
    assert same.grad_second_moment_bound(2.0) == pytest.approx(
        jprob.grad_second_moment_bound(2.0), rel=1e-5)
    q = np.array([1.0, 0.2, 0.1, 0.05, 1.0, 0.2], np.float32)
    np.testing.assert_allclose(tconv.biased_fixed_point(same, q).numpy(),
                               np.asarray(jconv.biased_fixed_point(jprob, q)),
                               rtol=1e-4, atol=1e-5)
