"""Port parity: optimizers and schedules against ``repro.optim``.

Each optimizer runs 5 updates on the same parameter tree and gradients
(numpy, from a seed) in both packages; parameters and state agree to
f32 ``rtol=1e-6``. Schedules agree at every step of a range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro import optim as jo
from repro_torch import optim as to
from repro_torch._tree import tree_leaves

OPTIMIZERS = {
    "sgd": lambda o: o.sgd(0.05),
    "sgd_schedule": lambda o: o.sgd(o.inverse_time_schedule(0.1, 0.3)),
    "momentum": lambda o: o.momentum(0.05),
    "nesterov": lambda o: o.momentum(0.05, beta=0.8, nesterov=True),
    "adam": lambda o: o.adam(1e-2),
    "adamw": lambda o: o.adamw(1e-2, weight_decay=0.1),
    "clip_sgd": lambda o: o.chain_clip(o.sgd(0.1), max_norm=0.5),
    "clip_adam": lambda o: o.chain_clip(o.adam(3e-3), max_norm=1.0),
}


def _tree(rng):
    return {"dense": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                      "b": rng.normal(size=(3,)).astype(np.float32)},
            "scale": rng.normal(size=(5,)).astype(np.float32)}


def _torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_over_5_updates(name):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jopt, topt = OPTIMIZERS[name](jo), OPTIMIZERS[name](to)
    assert topt.kind == jopt.kind
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        grads = _tree(rng)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tu, ts = topt.update(_torch(grads), ts, tp)
        jp = jo.apply_updates(jp, ju)
        tp = to.apply_updates(tp, tu)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    for a, b in zip(jax.tree_util.tree_leaves(js), tree_leaves(ts)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


def test_flat_buffer_optimizers():
    """The simulator's flat (P,) buffer is a one-leaf tree."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=(50,)).astype(np.float32)
    for name in ("momentum", "adam"):
        jopt, topt = OPTIMIZERS[name](jo), OPTIMIZERS[name](to)
        jp, tp = jnp.asarray(p), torch.from_numpy(p)
        js, ts = jopt.init(jp), topt.init(tp)
        for _ in range(5):
            g = rng.normal(size=(50,)).astype(np.float32)
            ju, js = jopt.update(jnp.asarray(g), js, jp)
            tu, ts = topt.update(torch.from_numpy(g), ts, tp)
            jp, tp = jo.apply_updates(jp, ju), to.apply_updates(tp, tu)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_fusion_tags():
    assert to.sgd(0.1).kind == "sgd" and to.sgd(0.1).hyper == 0.1
    assert to.momentum(0.1).kind == ""
    assert to.adam(0.1).kind == ""
    assert to.chain_clip(to.sgd(0.1), 1.0).kind == ""


SCHEDULES = {
    "constant": lambda o: o.constant_schedule(0.05),
    "inverse_time": lambda o: o.inverse_time_schedule(0.1, 0.07),
    "cosine": lambda o: o.cosine_schedule(0.1, 30, lr_min=0.01),
    "warmup_cosine": lambda o: o.warmup_cosine_schedule(0.1, 5, 30),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    jf, tf = SCHEDULES[name](jo), SCHEDULES[name](to)
    for step in range(40):
        jv = jf(jnp.asarray(step, jnp.int32))
        tv = tf(torch.tensor(step, dtype=torch.int32))
        assert tv.dtype == torch.float32
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(
        float(to.resolve_lr(0.3, torch.tensor(4, dtype=torch.int32))),
        float(jo.resolve_lr(0.3, jnp.asarray(4))), rtol=0)
