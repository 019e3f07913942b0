"""Port parity: energy arrivals and scheduler decisions.

Arrivals of every family over T = 50 steps are bitwise equal to the JAX
package's (energy and gap). Scheduler decisions over 50 steps: the
participation mask bitwise, scales and scheduler state to f32
``rtol=1e-6``, with and without a ragged ``active`` mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.core import energy as jenergy
from repro.core import scheduling as jsched
from repro_torch import random as trandom
from repro_torch.core import energy as tenergy
from repro_torch.core import scheduling as tsched

N, T = 8, 50
FAMILIES = ["periodic", "binary", "uniform", "day_night"]
SCHEDULERS = ["alg1", "alg2", "benchmark1", "benchmark2", "oracle",
              "battery_adaptive"]
ACTIVE = np.array([1, 1, 0, 1, 1, 0, 1, 1], np.float32)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree(t, j, exact=False):
    for a, b in zip(jax.tree_util.tree_leaves(j), _leaves(t)):
        if exact:
            np.testing.assert_array_equal(_np(a), _np(b))
        else:
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6)


def _leaves(x):
    from repro_torch._tree import tree_leaves

    return tree_leaves(x)


def _run_arrivals(jproc, tproc, seed):
    jk = jax.random.PRNGKey(seed)
    tk = trandom.PRNGKey(seed, device="cpu")
    js = jproc.init(jk)
    ts = tproc.init(tk)
    _assert_tree(ts, js, exact=True)
    out = []
    for t in range(T):
        jk_t = jax.random.fold_in(jk, t)
        tk_t = trandom.fold_in(tk, t)
        js, ja = jproc.arrivals(js, jnp.asarray(t, jnp.int32), jk_t)
        ts, ta = tproc.arrivals(ts, torch.tensor(t, dtype=torch.int32), tk_t)
        assert _np(ta.energy).tobytes() == np.asarray(ja.energy).tobytes(), t
        assert _np(ta.gap).tobytes() == np.asarray(ja.gap).tobytes(), t
        _assert_tree(ts, js, exact=True)
        out.append((ja, ta))
    return out


@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("seed", [0, 5])
def test_arrivals_bitwise(kind, seed):
    taus = np.array([1, 2, 4, 8, 1, 5, 10, 20])
    jproc = jenergy.make_arrivals(kind, N, T, taus=taus)
    tproc = tenergy.make_arrivals(kind, N, T, taus=taus)
    _run_arrivals(jproc, tproc, seed)
    np.testing.assert_allclose(
        _np(tenergy.expected_participation(tproc)),
        np.asarray(jenergy.expected_participation(jproc)), rtol=1e-6)


@pytest.mark.parametrize("kind", FAMILIES)
def test_padded_arrivals_bitwise(kind):
    """pad_arrivals: the padded process's first rows are the natural
    process's, bit for bit (DESIGN.md §7)."""
    jproc = jenergy.pad_arrivals(jenergy.make_arrivals(kind, 6, T), N)
    tproc = tenergy.pad_arrivals(tenergy.make_arrivals(kind, 6, T), N)
    _run_arrivals(jproc, tproc, 3)


def _arrivals_for(name):
    # Algorithm 1 is defined on deterministic arrivals; the others get
    # stochastic ones.
    return "periodic" if name == "alg1" else "binary"


@pytest.mark.parametrize("name", SCHEDULERS)
@pytest.mark.parametrize("with_active", [False, True], ids=["all", "ragged"])
def test_scheduler_decisions(name, with_active):
    taus = np.array([1, 2, 4, 8, 1, 5, 10, 20])
    kind = _arrivals_for(name)
    jproc = jenergy.make_arrivals(kind, N, T, taus=taus)
    tproc = tenergy.make_arrivals(kind, N, T, taus=taus)
    js_ = jsched.make_scheduler(name, N)
    ts_ = tsched.make_scheduler(name, N)
    jact = jnp.asarray(ACTIVE) if with_active else None
    tact = torch.from_numpy(ACTIVE) if with_active else None
    jk = jax.random.PRNGKey(11)
    tk = trandom.PRNGKey(11, device="cpu")
    jst, tst = js_.init(jk), ts_.init(tk)
    _assert_tree(tst, jst)
    fired = 0.0
    for t, (ja, ta) in enumerate(_run_arrivals(jproc, tproc, 2)):
        jk_t = jax.random.fold_in(jk, t)
        tk_t = trandom.fold_in(tk, t)
        jst, jd = js_.step(jst, jnp.asarray(t, jnp.int32), jk_t, ja, active=jact)
        tst, td = ts_.step(tst, torch.tensor(t, dtype=torch.int32), tk_t, ta,
                           active=tact)
        np.testing.assert_array_equal(_np(td.mask), np.asarray(jd.mask))
        np.testing.assert_allclose(_np(td.scale), np.asarray(jd.scale), rtol=1e-6)
        _assert_tree(tst, jst)
        fired += float(np.asarray(jd.mask).sum())
        if with_active:
            assert not np.any(_np(td.mask)[ACTIVE == 0])
    assert fired > 0


def test_registries_and_strictness():
    assert tsched.scheduler_names() == jsched.scheduler_names()
    assert tenergy.arrival_family_names() == jenergy.arrival_family_names()
    with pytest.raises(TypeError, match="extra kwargs"):
        tsched.make_scheduler("alg1", 4, scaled=False)
    with pytest.raises(ValueError, match="unknown scheduler"):
        tsched.make_scheduler("nope", 4)
    with pytest.raises(ValueError, match="unknown arrival kind"):
        tenergy.make_arrivals("nope", 4, 10)
    with pytest.raises(ValueError, match=r"\(0, 1\]"):
        tenergy.BinaryArrivals(np.array([0.5, 0.0]))
    with pytest.raises(ValueError, match="cannot pad"):
        tsched.pad_scheduler(tsched.make_scheduler("oracle", 4), 3)
    wide = tsched.pad_scheduler(tsched.make_scheduler("battery_adaptive", 4), 6)
    assert wide.n_clients == 6

    @tsched.register_scheduler("test_always")
    def _always(n, **kw):
        return tsched.AlwaysOnScheduler(n)

    assert isinstance(tsched.make_scheduler("test_always", 3),
                      tsched.AlwaysOnScheduler)
    tsched._REGISTRY.pop("test_always")
    np.testing.assert_array_equal(tenergy.default_taus(6),
                                  jenergy.default_taus(6))
