"""Port parity: energy-weighted LM training against the JAX package.

The same numpy inputs (seeded) go through ``repro`` and ``repro_torch``
on the CPU. The model is a 2-layer reduced stablelm (``reduced()`` with
two ``attn_mlp`` layers: d_model 256, 4 heads of 64, d_ff 512, vocab
512, f32), one JAX parameter tree carried into the port
(``params_from_jax``); JAX's train steps are its own
``build_energy_train_step``, which does not reach
``run_carry(donate=True)`` (ROADMAP R1). The train driver's tests are in
``tests/test_torch_train_driver.py``.

Held:
- bitwise: ``per_example_coefficients`` (scalar and per-client b),
  ``iid_partition`` and ``dirichlet_partition``, ``GlobalBatcher``
  (IID and with ``client_index``); inside the port, remat on against
  off, a masked client's data, flat against per-leaf;
- ``per_example_loss`` ``rtol=1e-5`` (plain, ``loss_chunk``,
  ``loss_mask``, ``window``); the quadratic train steps of
  ``tests/test_trainer_spmd.py`` ``rtol=1e-5``;
- ``make_sgd_train_step`` over 3 steps: losses ``rtol=1e-4``, params
  ``rtol=1e-4, atol=1e-6``; ``make_train_step`` (adamw) over 3 steps:
  losses and the pre-optimizer gradients ``rtol=1e-4, atol=1e-6``, and
  params to ``atol = 2·lr·steps`` (Adam's first steps move a parameter
  by about ``lr·sign(g)``, so a near-zero gradient whose sign differs by
  sum order moves it by up to 2·lr);
- the bf16 plain attention's gradient against ``jax.grad`` of JAX's
  ``_sdpa`` to a few bf16 roundings of its largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.configs import get_config as j_get_config
from repro.core import aggregation as jagg
from repro.core.trainer import build_energy_train_step as j_build
from repro.data import loader as jloader
from repro.data import partition as jpart
from repro.launch.steps import make_sgd_train_step as j_sgd_step
from repro.launch.steps import make_train_step as j_train_step
from repro.models import transformer as jt
from repro.optim import adam as j_adam
from repro.optim import adamw as j_adamw
from repro.optim import sgd as j_sgd
from repro.optim.optimizers import Optimizer as JOptimizer
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core import aggregation as tagg
from repro_torch.core.trainer import build_energy_train_step as t_build
from repro_torch.data import GlobalBatcher, dirichlet_partition, iid_partition
from repro_torch.launch.steps import make_sgd_train_step as t_sgd_step
from repro_torch.launch.steps import make_train_step as t_train_step
from repro_torch.models import transformer as tt
from repro_torch.optim import Optimizer as TOptimizer
from repro_torch.optim import adam as t_adam
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import sgd as t_sgd

TWO_LAYERS = (("attn_mlp", 2, False),)
N, B, S = 4, 8, 32


def _cfgs(**kw):
    j = j_get_config("stablelm-1.6b").reduced().replace(superblock=TWO_LAYERS, **kw)
    t = t_get_config("stablelm-1.6b").reduced().replace(superblock=TWO_LAYERS, **kw)
    return j, t


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _cfgs()
    jp = jt.init_lm(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _lm_batch(vocab, seed=0, b=B, s=S, loss_mask=False):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": raw[:, :-1], "labels": raw[:, 1:],
             "client_ids": np.repeat(np.arange(N, dtype=np.int32), b // N)}
    if loss_mask:
        batch["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _decision(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    scale = rng.uniform(0.5, 3.0, N).astype(np.float32)
    return ((jnp.asarray(mask), jnp.asarray(scale)),
            (torch.from_numpy(mask), torch.from_numpy(scale)))


# ----------------------------------------------------------- bitwise pieces

@pytest.mark.parametrize("b_form", ["scalar", "per-client"])
def test_per_example_coefficients_bitwise(b_form):
    rng = np.random.default_rng(1)
    w = rng.uniform(0, 2, 5).astype(np.float32)
    w[2] = 0.0
    ids = rng.integers(0, 5, 23).astype(np.int32)
    b = 3 if b_form == "scalar" else np.array([3, 0, 2, 7, 1], np.float32)
    want = np.asarray(jagg.per_example_coefficients(jnp.asarray(ids),
                                                    jnp.asarray(w), b))
    got = tagg.per_example_coefficients(torch.from_numpy(ids),
                                        torch.from_numpy(w), b)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_iid_partition_bitwise():
    for seed, n, k in ((0, 1000, 40), (3, 17, 4)):
        want, got = jpart.iid_partition(seed, n, k), iid_partition(seed, n, k)
        assert len(got) == k
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_dirichlet_partition_bitwise():
    labels = np.random.default_rng(2).integers(0, 10, 500)
    for alpha in (0.3, 5.0):
        want = jpart.dirichlet_partition(4, labels, 8, alpha)
        got = dirichlet_partition(4, labels, 8, alpha)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("index", ["iid", "client_index"])
def test_global_batcher_sample_bitwise(index):
    data = {"raw": np.random.default_rng(3).integers(0, 99, (60, 9)).astype(np.int32),
            "y": np.arange(60, dtype=np.float32)}
    client_index = None
    if index == "client_index":
        labels = np.random.default_rng(5).integers(0, 4, 60)
        client_index = dirichlet_partition(0, labels, 4, 0.5)
    jb = jloader.GlobalBatcher(data, n_clients=4, global_batch=12,
                               client_index=client_index)
    tb = GlobalBatcher(data, n_clients=4, global_batch=12,
                       client_index=client_index, device="cpu")
    for seed in range(3):
        want = jb.sample(jax.random.PRNGKey(seed))
        got = tb.sample(trandom.PRNGKey(seed, device="cpu"))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got["client_ids"].dtype == torch.int32


def test_global_batcher_refuses_uneven_batch():
    with pytest.raises(ValueError, match="global_batch"):
        GlobalBatcher({"raw": np.zeros((4, 2))}, n_clients=3, global_batch=8,
                      device="cpu")


# ------------------------------------------------------------------ the loss

LOSS_CASES = {
    "plain": ({}, {}, None),
    "loss_chunk": ({"loss_chunk": 8}, {}, None),
    "loss_mask": ({"loss_chunk": 8}, {"loss_mask": True}, None),
    "window": ({}, {}, 8),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_per_example_loss_matches_jax(params, case):
    cfg_kw, batch_kw, window = LOSS_CASES[case]
    jp, tp = params
    jcfg, tcfg = _cfgs(**cfg_kw)
    jb, tb = _lm_batch(jcfg.vocab, seed=4, **batch_kw)
    want, jaux = jt.per_example_loss(jp, jcfg, jb, window=window)
    got, aux = tt.per_example_loss(tp, tcfg, tb, window=window)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert float(aux) == float(jaux) == 0.0


def test_chunked_ce_equals_the_plain_loss_in_port(params):
    _, tp = params
    _, tcfg = _cfgs()
    _, tb = _lm_batch(tcfg.vocab, seed=5)
    plain, _ = tt.per_example_loss(tp, tcfg, tb)
    chunked, _ = tt.per_example_loss(tp, tcfg.replace(loss_chunk=8), tb)
    torch.testing.assert_close(chunked, plain, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_remat_gives_the_same_bits(params, policy):
    """The loss and every gradient with each layer recomputed in the
    backward equal those without remat, bit for bit."""
    _, tp = params
    _, base = _cfgs()
    _, tb = _lm_batch(base.vocab, seed=6)

    def loss_and_grads(cfg):
        wrt = tree_map(lambda x: x.detach().requires_grad_(), tp)
        losses, _ = tt.per_example_loss(wrt, cfg, tb)
        loss = torch.sum(losses * torch.linspace(0.1, 1.0, B))
        return loss, torch.autograd.grad(loss, tree_leaves(wrt))

    ref_loss, ref_grads = loss_and_grads(base)
    cfg = base if policy is None else base.replace(remat=True,
                                                   remat_policy=policy)
    loss, grads = loss_and_grads(cfg)
    assert torch.equal(loss, ref_loss)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


def test_sdpa_bf16_gradient_matches_jax():
    """The bf16 plain attention's gradients (q, k, v) follow JAX's
    transpose rule for an f32-output product: f32 cotangents, the other
    operand upcast, each gradient in its operand's dtype."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 2, 64)).astype(np.float32)
            for _ in range(2))
    ct = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
    mask = np.array(jattn.causal_mask(9, 9, window=5))

    def jloss(q, k, v):
        out = jattn._sdpa(q, k, v, jnp.asarray(mask)).astype(jnp.float32)
        return jnp.sum(out * ct)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v)]
    out = tattn._sdpa(*ts, torch.from_numpy(mask))
    got = torch.autograd.grad(torch.sum(out.float() * torch.from_numpy(ct)), ts)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=4 * 2 ** -8 * np.abs(w).max())


def test_flash_prefill_refuses_gradients(params):
    _, tp = params
    _, tcfg = _cfgs(use_flash=True)
    _, tb = _lm_batch(tcfg.vocab)
    wrt = tree_map(lambda x: x.detach().requires_grad_(), tp)
    with pytest.raises(NotImplementedError, match="no backward"):
        tt.per_example_loss(wrt, tcfg, tb)


# ------------------------------------------- the SPMD train step, quadratic

def _quad_loss(xp):
    def loss(params, batch):
        diff = params["w"][None, :] - batch["x"]
        return xp.sum(diff * diff, axis=-1)
    return loss


def _quad(n=N, b=3, dim=5, seed=0, extra=None):
    x = np.random.default_rng(seed).normal(size=(n * b, dim)).astype(np.float32)
    if extra is not None:
        x = extra(x)
    ids = np.repeat(np.arange(n, dtype=np.int32), b)
    return ({"x": jnp.asarray(x), "client_ids": jnp.asarray(ids)},
            {"x": torch.from_numpy(x), "client_ids": torch.from_numpy(ids)}, x)


def _t_quad_loss(params, batch):
    diff = params["w"][None, :] - batch["x"]
    return torch.sum(diff * diff, dim=-1)


def test_masked_scaled_update_matches_paper_formula():
    n, b, dim, lr = N, 3, 5, 0.1
    jb, tb, x = _quad()
    mask, scale = np.array([1.0, 0.0, 1.0, 0.0], np.float32), \
        np.array([2.0, 2.0, 4.0, 4.0], np.float32)
    ji, js = j_build(per_example_loss_fn=_quad_loss(jnp), optimizer=j_sgd(lr),
                     n_clients=n)
    want, jm = jax.jit(js)(ji({"w": jnp.zeros((dim,))}), jb, jnp.asarray(mask),
                           jnp.asarray(scale))
    ti, ts = t_build(per_example_loss_fn=_t_quad_loss, optimizer=t_sgd(lr),
                     n_clients=n)
    got, m = ts(ti({"w": torch.zeros(dim)}), tb, torch.from_numpy(mask),
                torch.from_numpy(scale))
    g = sum(0.25 * mask[i] * scale[i] * np.mean(2 * -x[i * b:(i + 1) * b], 0)
            for i in range(n))
    np.testing.assert_allclose(got.params["w"].numpy(), -lr * g, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.params["w"].numpy(),
                               np.asarray(want.params["w"]), rtol=1e-5)
    for k in ("weighted_loss", "loss", "active_clients", "weight_sum"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-6)
    assert int(got.step) == 1 and got.step.dtype == torch.int32


def test_masked_client_contributes_nothing():
    """Client 1 is masked: moving only its data leaves the update
    unchanged, bit for bit in the port (JAX holds it to 1e-6)."""
    mask, scale = torch.tensor([1.0, 0.0, 1.0, 1.0]), torch.ones(N)
    init, step = t_build(per_example_loss_fn=_t_quad_loss, optimizer=t_sgd(0.1),
                         n_clients=N)
    ji, js = j_build(per_example_loss_fn=_quad_loss(jnp), optimizer=j_sgd(0.1),
                     n_clients=N)
    outs = []
    for shift in (0.0, 100.0):
        def moved(x):
            x = x.copy()
            x[3:6] += shift
            return x
        jb, tb, _ = _quad(extra=moved)
        s, _ = step(init({"w": torch.zeros(5)}), tb, mask, scale)
        j, _ = jax.jit(js)(ji({"w": jnp.zeros((5,))}), jb,
                           jnp.asarray(mask.numpy()), jnp.ones((N,)))
        np.testing.assert_allclose(s.params["w"].numpy(), np.asarray(j.params["w"]),
                                   rtol=1e-5)
        outs.append(s.params["w"])
    assert torch.equal(outs[0], outs[1])


def test_full_participation_equals_plain_sgd():
    jb, tb, _ = _quad()
    init, step = t_build(per_example_loss_fn=_t_quad_loss, optimizer=t_sgd(0.1),
                         n_clients=N)
    ones = torch.ones(N)
    s, _ = step(init({"w": torch.zeros(5)}), tb, ones, ones)
    w = torch.zeros(5, requires_grad=True)
    (grad,) = torch.autograd.grad(torch.mean(_t_quad_loss({"w": w}, tb)), [w])
    torch.testing.assert_close(s.params["w"], -0.1 * grad, rtol=1e-5, atol=0)
    want = jax.grad(lambda p: jnp.mean(_quad_loss(jnp)(p, jb)))({"w": jnp.zeros((5,))})
    np.testing.assert_allclose(s.params["w"].numpy(), -0.1 * np.asarray(want["w"]),
                               rtol=1e-5)


@pytest.mark.parametrize("opt", ["adam", "sgd-fused"])
def test_flat_loss_path_matches_per_leaf(opt):
    """``flat=True`` (gradient raveled into one (P,) buffer, flat
    optimizer state) is bitwise the per-leaf route; the tagged sgd goes
    through ``fused_flat_sgd_update`` as a one-row stack, through K2's
    plain version here (``use_kernel=True`` on CPU tensors). Against JAX
    (adam, its own flat route) ``rtol=1e-5``."""
    from repro_torch.kernels.aggregate import ops as agg_ops
    jb, tb, _ = _quad()
    mask, scale = torch.tensor([1.0, 0.0, 1.0, 1.0]), torch.tensor([2.0, 1.0, 1.0, 3.0])

    def loss2(p, bt):
        diff = p["w"][None, :] - bt["x"] * p["v"][None, :]
        return torch.sum(diff * diff, dim=-1)

    def jloss2(p, bt):
        diff = p["w"][None, :] - bt["x"] * p["v"][None, :]
        return jnp.sum(diff * diff, axis=-1)

    make = (lambda: t_adam(0.05)) if opt == "adam" else (lambda: t_sgd(0.05))
    outs = {}
    for flat in (False, True):
        init, step = t_build(per_example_loss_fn=loss2, optimizer=make(),
                             n_clients=N, flat=flat, use_kernel=True)
        state = init({"w": torch.zeros(5), "v": torch.ones(5)})
        before = dict(agg_ops.launch_counts)
        for _ in range(3):
            state, metrics = step(state, tb, mask, scale)
        assert agg_ops.launch_counts == before  # CPU: no launch
        outs[flat] = (state, metrics)
    for leaf in ("w", "v"):
        assert torch.equal(outs[False][0].params[leaf], outs[True][0].params[leaf])
    assert torch.equal(outs[False][1]["weighted_loss"],
                       outs[True][1]["weighted_loss"])
    if opt == "adam":
        assert outs[True][0].opt_state.mu.shape == (10,)
        ji, js = j_build(per_example_loss_fn=jloss2, optimizer=j_adam(0.05),
                         n_clients=N, flat=True)
        j = ji({"w": jnp.zeros((5,)), "v": jnp.ones((5,))})
        for _ in range(3):
            j, _ = jax.jit(js)(j, jb, jnp.asarray(mask.numpy()),
                               jnp.asarray(scale.numpy()))
        for leaf in ("w", "v"):
            np.testing.assert_allclose(outs[True][0].params[leaf].numpy(),
                                       np.asarray(j.params[leaf]), rtol=1e-5)
        np.testing.assert_allclose(outs[True][0].opt_state.nu.numpy(),
                                   np.asarray(j.opt_state.nu), rtol=1e-5)
    else:
        assert int(outs[True][0].opt_state.step) == 3


def test_per_example_coefficients():
    w = torch.tensor([0.4, 0.0, 0.6])
    ids = torch.tensor([0, 0, 1, 1, 2, 2])
    c = tagg.per_example_coefficients(ids, w, 2)
    torch.testing.assert_close(c, torch.tensor([0.2, 0.2, 0.0, 0.0, 0.3, 0.3]))
    want = jagg.per_example_coefficients(jnp.asarray(ids.numpy()),
                                         jnp.asarray(w.numpy()), 2)
    np.testing.assert_array_equal(c.numpy(), np.asarray(want))


def test_aux_loss_is_weighted_by_the_client_weights():
    """A per-example loss that returns (losses, aux): the total gains
    ``aux_loss_weight·aux·Σω`` and its gradient, as in JAX."""
    jb, tb, _ = _quad()
    (jm, js_), (tm, ts_) = _decision(7)

    def jloss(p, bt):
        return _quad_loss(jnp)(p, bt), jnp.sum(p["w"] ** 2)

    def tloss(p, bt):
        return _t_quad_loss(p, bt), torch.sum(p["w"] ** 2)

    p0 = np.linspace(-1, 1, 5).astype(np.float32)
    ji, js = j_build(per_example_loss_fn=jloss, optimizer=j_sgd(0.1),
                     n_clients=N, aux_loss_weight=0.5)
    want, wm = jax.jit(js)(ji({"w": jnp.asarray(p0)}), jb, jm, js_)
    ti, ts = t_build(per_example_loss_fn=tloss, optimizer=t_sgd(0.1),
                     n_clients=N, aux_loss_weight=0.5)
    got, m = ts(ti({"w": torch.from_numpy(p0)}), tb, tm, ts_)
    np.testing.assert_allclose(got.params["w"].numpy(), np.asarray(want.params["w"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["weighted_loss"]),
                               float(wm["weighted_loss"]), rtol=1e-6)
    ti0, ts0 = t_build(per_example_loss_fn=tloss, optimizer=t_sgd(0.1),
                       n_clients=N)
    _, m0 = ts0(ti0({"w": torch.from_numpy(p0)}), tb, tm, ts_)
    torch.testing.assert_close(
        m["weighted_loss"] - m0["weighted_loss"],
        0.5 * torch.sum(torch.from_numpy(p0) ** 2) * m["weight_sum"])


# ------------------------------------------------- the LM train steps

def _recording(opt, log, convert):
    """``opt`` with every gradient it is handed recorded (as numpy)."""
    def update(grads, state, params=None):
        log.append(convert(grads))
        return opt.update(grads, state, params)
    return update


def _steps(jstep, jstate, tstep, tstate, n=3):
    losses = ([], [])
    for i in range(n):
        jb, tb = _lm_batch(512, seed=20 + i)
        (jm, js_), (tm, ts_) = _decision(30 + i)
        jstate, jmet = jstep(jstate, jb, jm, js_)
        tstate, tmet = tstep(tstate, tb, tm, ts_)
        losses[0].append(float(jmet["loss"]))
        losses[1].append(float(tmet["loss"]))
        np.testing.assert_array_equal(tmet["active_clients"].numpy(),
                                      np.asarray(jmet["active_clients"]))
    return jstate, tstate, losses


def test_make_sgd_train_step_matches_jax(params):
    jp, tp = params
    jcfg, tcfg = _cfgs()
    ji, js = j_sgd_step(jcfg, N, lr=0.05)
    ti, ts = t_sgd_step(tcfg, N, lr=0.05)
    jstate, tstate, (jl, tl) = _steps(jax.jit(js), ji(jp), ts, ti(tp))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for g, w in zip(tree_leaves(tstate.params),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    assert int(tstate.opt_state.step) == int(jstate.opt_state.step) == 3


def test_make_train_step_adamw_matches_jax(params):
    """Three adamw steps in each package from one tree: losses, and
    params to ``2·lr·steps``. The pre-optimizer gradients are held on
    the same inputs each step: the port steps JAX's state before the
    step, carried over (``train_state_from_jax``), beside the
    independent run (a parameter moved by a flipped Adam sign moves the
    later gradients by more than their tolerance). JAX's step runs
    eagerly, so a wrapped optimizer sees concrete gradients."""
    jp, tp = params
    jcfg, tcfg = _cfgs()
    lr, steps = 3e-4, 3
    jlog, tlog = [], []
    jopt, topt = j_adamw(lr), t_adamw(lr)
    jopt = JOptimizer(jopt.init, _recording(
        jopt, jlog, lambda g: [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]))
    topt = TOptimizer(topt.init, _recording(
        topt, tlog, lambda g: [x.numpy().copy() for x in tree_leaves(g)]))
    ji, js = j_train_step(jcfg, N, optimizer=jopt)
    _, ts_rec = t_train_step(tcfg, N, optimizer=topt)
    ti, ts = t_train_step(tcfg, N, lr=lr)
    jstate, tstate = ji(jp), ti(tp)
    jl, tl = [], []
    for i in range(steps):
        jb, tb = _lm_batch(512, seed=20 + i)
        (jm, js_), (tm, ts_) = _decision(30 + i)
        carried = train_state_from_jax(
            jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
        assert type(carried).__name__ == "TrainState"
        assert type(carried.opt_state).__name__ == "AdamState"
        for a, b in zip(tree_leaves(carried), jax.tree_util.tree_leaves(jstate)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _, cm = ts_rec(carried, tb, tm, ts_)
        jstate, jmet = js(jstate, jb, jm, js_)
        tstate, tmet = ts(tstate, tb, tm, ts_)
        np.testing.assert_allclose(float(cm["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert len(jlog) == len(tlog) == steps
    for jg, tg in zip(jlog, tlog):
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    worst = max(np.abs(g.numpy() - np.asarray(w)).max()
                for g, w in zip(tree_leaves(tstate.params),
                                jax.tree_util.tree_leaves(jstate.params)))
    assert worst <= 2 * lr * steps, worst
    assert int(tstate.opt_state.step) == int(jstate.opt_state.step) == steps
