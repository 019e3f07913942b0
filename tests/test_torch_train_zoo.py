"""Port parity: energy-weighted training of the zoo's other families
through the LM train driver, against the JAX package.

Five families at ``reduced()`` width (f32): qwen2-vl-2b (vision tokens,
M-RoPE), whisper-tiny (the encoder-decoder), zamba2-2.7b (Mamba2 and the
shared attention block), xlstm-1.3b (mLSTM and sLSTM) and phi3.5-moe
(the MoE block and its aux loss). Each is trained by both drivers on
the CPU with ``tests/test_torch_train_driver.py``'s arguments (alg1 on
periodic arrivals, 4 clients, B 4 x S 16), on 3 steps. JAX's ``main``
does not reach ``run_carry(donate=True)`` (ROADMAP R1). One module
fixture runs JAX's driver once an arch and records, for each jitted
train step, its inputs (copied before the call: the step donates its
state) and its outputs.

Held:
- the driver: the loss stream ``rtol=1e-4``, the active clients and
  Σω a step bitwise. The batch carries zero vision tokens / audio
  frames as the JAX driver's does; without them qwen2-vl trains
  another model and whisper raises;
- one ``make_train_step`` adamw step from JAX's step-0 weights
  (``params_from_jax``) on JAX's step-0 batch and decision, which
  masks a client: the loss ``rtol=1e-5``, the first moment (0.1 of
  the gradient) ``rtol=1e-4`` with ``atol`` 1e-5 of the tree's largest
  value (f32 sums in another order; a leaf whose gradient is zero but
  for rounding, as whisper's key bias under softmax, holds noise), the
  params to
  ``atol = 2·lr`` (Adam's first step moves a parameter by about
  ``lr·sign(g)``, and a near-zero gradient's sign may differ by sum
  order) with all but a thousandth of them within ``1e-6``;
- phi3.5-moe: the same step with the masked client's tokens replaced
  by other random tokens, JAX against the port at the same tolerance.
  The masked client's tokens still take expert capacity (counted over
  the whole batch in both packages), so its tokens may move the update;
  both packages must move it alike;
- the driver's zero vision tokens at qwen2-vl-2b's full width (2 of its
  layers): the gradient at those rows, which grows ~1,000-fold a layer
  (ROADMAP R5), the same in both packages ``rtol=1e-4``;
- ``chunked_gla``'s gradients finite for decays of 1e-6 (a Mamba2 layer
  in training reaches them: zamba2's driver run on the card gave NaN
  from its third step when the select covered the product alone),
  against a sequential scan differentiated by autograd;
- the sLSTM's hand-written backward (one autograd node for the loop
  over time) against autograd through its cell step by step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

import repro.launch.train as j_train
from repro.configs import get_config as j_get_config
from repro.models import transformer as j_transformer
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as t_train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as t_transformer
from repro_torch.models.ssm import (_SLSTMScan, chunked_gla, init_slstm_state,
                                    slstm_cell)
from repro_torch.optim import adamw

ARCHS = ("qwen2-vl-2b", "whisper-tiny", "zamba2-2.7b", "xlstm-1.3b",
         "phi3.5-moe-42b-a6.6b")
STEPS, N_CLIENTS, LR = 3, 4, 3e-4


def _driver_args(arch):
    return ["--arch", arch, "--reduced", "--steps", str(STEPS),
            "--global-batch", "4", "--seq-len", "16",
            "--n-clients", str(N_CLIENTS), "--scheduler", "alg1",
            "--arrivals", "periodic", "--lr", str(LR)]


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


class _RecordingJax:
    """``jax`` for ``repro.launch.train``, with ``jax.jit`` recording each
    jitted train step: the jitted function, its inputs and outputs."""

    def __init__(self, log):
        self._log = log

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def call(*args):
            if len(args) != 4 or not isinstance(args[1], dict):
                return jitted(*args)  # the scheduler's step
            inputs = _np(args)
            out = jitted(*args)
            self._log.append({"fn": jitted, "inputs": inputs,
                              "state": _np(out[0]), "metrics": _np(out[1])})
            return out
        return call


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    mp = pytest.MonkeyPatch()
    try:
        for arch in ARCHS:
            log = []
            mp.setattr(j_train, "jax", _RecordingJax(log))
            runs[arch] = (j_train.main(_driver_args(arch)), log)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_matches_jax_main(jax_runs, arch):
    jlosses, jlog = jax_runs[arch]
    log = []
    losses = t_train.main(
        _driver_args(arch) + ["--device", "cpu"],
        on_step=lambda step, state, metrics: log.append(
            {k: v.numpy().copy() for k, v in metrics.items()}))
    assert len(losses) == len(jlosses) == len(log) == len(jlog) == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for got, want in zip(log, jlog):
        for k in ("active_clients", "weight_sum"):
            np.testing.assert_array_equal(got[k], want["metrics"][k])
    assert {float(m["active_clients"]) for m in log} != {4.0}  # alg1 masks


def test_driver_batch_carries_the_side_inputs():
    qwen = t_get_config("qwen2-vl-2b").reduced()
    whisper = t_get_config("whisper-tiny").reduced()
    extra = t_train.zero_side_inputs(qwen, 4, "cpu")
    assert list(extra) == ["vision_embeds"]
    assert extra["vision_embeds"].shape == (4, qwen.n_vision_tokens, qwen.d_model)
    extra = t_train.zero_side_inputs(whisper, 4, "cpu")
    assert list(extra) == ["audio_feats"]
    assert extra["audio_feats"].shape == (4, whisper.enc_len, whisper.d_model)
    assert not any(extra["audio_feats"].flatten().tolist())
    assert t_train.zero_side_inputs(t_get_config("zamba2-2.7b"), 4, "cpu") == {}
    bf16 = t_train.zero_side_inputs(t_get_config("qwen2-vl-2b"), 2, "cpu")
    assert bf16["vision_embeds"].dtype == torch.bfloat16


def _first_step(jlog):
    """JAX's step 0: its inputs (state, batch, mask, scale) as numpy."""
    state, batch, mask, scale = jlog[0]["inputs"]
    assert 0 < mask.sum() < N_CLIENTS, "alg1's step 0 masks no client"
    return state, batch, mask, scale


def _port_step(arch, params, batch, mask, scale):
    cfg = t_get_config(arch).reduced()
    init, step = make_train_step(cfg, N_CLIENTS, optimizer=adamw(LR))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return step(init(params_from_jax(params, device="cpu")), tb,
                torch.from_numpy(mask), torch.from_numpy(scale))


def _hold_update(got, got_metrics, want, want_metrics):
    np.testing.assert_allclose(float(got_metrics["loss"]),
                               float(want_metrics["loss"]), rtol=1e-5)
    mus = jax.tree_util.tree_leaves(want.opt_state.mu)
    atol = 1e-5 * max(np.abs(b).max() for b in mus)
    for a, b in zip(tree_leaves(got.opt_state.mu), mus):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=atol)
    pairs = list(zip(tree_leaves(got.params),
                     jax.tree_util.tree_leaves(want.params)))
    assert len(pairs) == len(jax.tree_util.tree_leaves(want.params))
    worst = max(np.abs(a.numpy() - b).max() for a, b in pairs)
    assert worst <= 2 * LR, worst
    off = sum(int((np.abs(a.numpy() - b) > 1e-6).sum()) for a, b in pairs)
    assert off <= sum(b.size for _, b in pairs) // 1000, off


@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_adamw_matches_jax(jax_runs, arch):
    _, jlog = jax_runs[arch]
    state, batch, mask, scale = _first_step(jlog)
    got, metrics = _port_step(arch, state.params, batch, mask, scale)
    assert int(got.opt_state.step) == int(jlog[0]["state"].opt_state.step) == 1
    _hold_update(got, metrics, jlog[0]["state"], jlog[0]["metrics"])


def test_moe_masked_client_tokens_move_both_packages_alike(jax_runs):
    """phi3.5-moe: the masked client's tokens replaced. JAX's jitted
    driver step and the port's step on the new batch agree."""
    arch = "phi3.5-moe-42b-a6.6b"
    _, jlog = jax_runs[arch]
    state, batch, mask, scale = _first_step(jlog)
    client = int(np.flatnonzero(mask == 0)[0])
    rows = batch["client_ids"] == client
    other = dict(batch)
    for k in ("tokens", "labels"):
        other[k] = batch[k].copy()
    rng = np.random.default_rng(7)
    vocab = j_get_config(arch).reduced().vocab
    fresh = rng.integers(0, vocab, (int(rows.sum()), batch["tokens"].shape[1] + 1))
    other["tokens"][rows] = fresh[:, :-1]
    other["labels"][rows] = fresh[:, 1:]
    assert not np.array_equal(other["tokens"], batch["tokens"])
    jstate, jmetrics = jlog[0]["fn"](
        jax.tree_util.tree_map(jnp.asarray, state),
        {k: jnp.asarray(v) for k, v in other.items()},
        jnp.asarray(mask), jnp.asarray(scale))
    got, metrics = _port_step(arch, state.params, other, mask, scale)
    _hold_update(got, metrics, _np(jstate), _np(jmetrics))


def _sequential_gla(a, k, v, q):
    """H_t = a_t·H_{t−1} + k_t v_tᵀ, y_t = q_tᵀ H_t, one step at a time."""
    b, s, h = a.shape
    state = torch.zeros(b, h, k.shape[-1], v.shape[-1])
    ys = []
    for t in range(s):
        state = (a[:, t, :, None, None] * state
                 + k[:, t, :, :, None] * v[:, t, :, None, :])
        ys.append(torch.einsum("bhd,bhdv->bhv", q[:, t], state))
    return torch.stack(ys, 1)


def test_chunked_gla_gradients_finite_for_small_decays():
    """Decays of 1e-6 (ROADMAP R4's input) and 1e-3 beside ordinary ones,
    two chunks and a padded third: exp(la_t − la_s) of each chunk's upper
    triangle overflows. y and the gradients of k, v and q within 1e-5 of
    the largest reference value; a's as a·∂/∂a, the gradient of log a
    that the blocks' parameters reach (∂/∂a alone is 1/a times a sum
    that cancels to its rounding)."""
    gen = torch.Generator().manual_seed(0)
    b, s, h, d = 2, 80, 3, 8
    a = torch.rand(b, s, h, generator=gen) * 0.5 + 0.5
    a[:, :, 0] = 1e-6
    a[:, 40:, 1] = 1e-3
    a.requires_grad_()
    k, v, q = (torch.randn(b, s, h, d, generator=gen).requires_grad_()
               for _ in range(3))
    w = torch.randn(b, s, h, d, generator=gen)
    y, _ = chunked_gla(a, k, v, q, chunk=32)
    want = _sequential_gla(a, k, v, q)
    got_g = torch.autograd.grad((y * w).sum(), (a, k, v, q))
    want_g = torch.autograd.grad((want * w).sum(), (a, k, v, q))
    got_g = (a.detach() * got_g[0],) + got_g[1:]
    want_g = (a.detach() * want_g[0],) + want_g[1:]
    for got, ref in ((y, want),) + tuple(zip(got_g, want_g)):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * ref.abs().max().item())


def _slstm_by_autograd(pre, r):
    """The sLSTM loop step by step through ``slstm_cell``, autograd
    recording every step: the route the one-node backward replaces."""
    b, s, n_heads, _ = pre.shape
    state = init_slstm_state(b, n_heads * r.shape[1], n_heads)
    hs = []
    for t in range(s):
        state = slstm_cell(pre[:, t], r, state)
        hs.append(state["h"])
    return torch.stack(hs, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_backward_matches_autograd(dtype):
    """The sLSTM as one autograd node (its backward written by hand, the
    route a training step takes) against autograd through the cell
    step by step: the outputs bitwise, the gradients of the input
    projection (in its dtype) and of r within 1e-5 of the largest, a
    bf16 one also within one bf16 ulp (2**-7 relative) of each element,
    since its f32 sums run in another order. The
    gates are pushed past n = 1 and below it, so both sides of the
    normaliser's clamp are crossed; the input projection is in f32 or
    bf16 (a training step's)."""
    gen = torch.Generator().manual_seed(0)
    b, s, h, dh = 2, 24, 2, 4
    pre = (torch.randn(b, s, h, 4 * dh, generator=gen) * 2).to(dtype)
    r = torch.randn(h, dh, 4 * dh, generator=gen) * dh ** -0.5
    w = torch.randn(b, s, h, dh, generator=gen)
    outs = []
    for fn in (lambda p, q: _SLSTMScan.apply(p, q), _slstm_by_autograd):
        p, q = pre.clone().requires_grad_(), r.clone().requires_grad_()
        y = fn(p, q)
        outs.append((y,) + torch.autograd.grad((y * w).sum(), (p, q)))
    (y, d_pre, d_r), (y_ref, d_pre_ref, d_r_ref) = outs
    assert torch.equal(y, y_ref)
    assert d_pre.dtype == dtype
    for got, ref in ((d_pre, d_pre_ref), (d_r, d_r_ref)):
        torch.testing.assert_close(
            got.float(), ref.float(),
            rtol=2 ** -7 if got.dtype == torch.bfloat16 else 0,
            atol=1e-5 * ref.abs().max().item())


def test_zero_vision_tokens_grow_the_gradient_alike():
    """qwen2-vl-2b at full width (d_model 1,536, 256 vision tokens) cut to
    2 layers and a 512-token vocabulary, f32. The zero vision tokens the
    driver feeds (as JAX's does) stay exactly 0 through every layer of a
    random model, whose biases start at 0, and each RMSNorm multiplies
    their gradient by rsqrt(1e-6) = 1,000: the gradient at those rows
    grows ~1,000-fold a layer, and at the config's 28 layers overflows
    f32 (ROADMAP R5). Both packages give the same gradient there."""
    arch = "qwen2-vl-2b"
    cut = dict(n_layers=2, vocab=512, dtype_name="float32", remat=False)
    jcfg = j_get_config(arch).replace(**cut)
    tcfg = t_get_config(arch).replace(**cut)
    jp = j_transformer.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    nv = jcfg.n_vision_tokens
    raw = np.random.default_rng(3).integers(0, jcfg.vocab, (1, nv + 17))
    raw = raw.astype(np.int32)
    zeros = np.zeros((1, nv, jcfg.d_model), np.float32)

    def jax_loss(vision):
        batch = {"tokens": jnp.asarray(raw[:, :-1]),
                 "labels": jnp.asarray(raw[:, 1:]), "vision_embeds": vision}
        return j_transformer.per_example_loss(jp, jcfg, batch)[0].mean()

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(zeros)))
    vision = torch.from_numpy(zeros).requires_grad_()
    batch = {"tokens": torch.from_numpy(raw[:, :-1]),
             "labels": torch.from_numpy(raw[:, 1:]), "vision_embeds": vision}
    loss = t_transformer.per_example_loss(tp, tcfg, batch)[0].mean()
    got, = torch.autograd.grad(loss, vision)
    assert np.abs(want).max() > 1e4
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
