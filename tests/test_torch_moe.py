"""Port parity: the Mixture-of-Experts layer and the ``attn_moe`` block
against the JAX package.

``repro_torch.models.moe`` against ``repro.models.moe`` off a mesh (one
data shard, the path the JAX package takes on one device): ``init_moe``
key for key, ``apply_moe`` with top-k 1 and 2, with and without the
shared expert, at capacity factors 1.25 and 0.5 (tokens drop), then the
``attn_moe`` block's prefill and decode, the ``moe`` case of
``tests/test_decode_consistency.py``, and an MoE tree carried over by
``params_from_jax``. Inputs are numpy arrays from a seed; one JAX
parameter tree goes to both packages, the port on ``device="cpu"``.

JAX's routing is read off the lines of its ``apply_moe``
(``src/repro/models/moe.py:182–195``): the f32 router logits, softmax,
``lax.top_k``, the renormalised weights and the slot positions from a
cumsum of one-hots.

Tolerances: in f32 the chosen experts (``top_e``) and the drop mask
(``keep``) bitwise, the output and the aux loss ``1e-5·max|JAX|``
(products summed in other orders); in bf16 the output
``8·2⁻⁸·max|JAX|``, as ``tests/test_torch_lm.py`` holds a bf16 prefill,
with the routing taken from the same f32 logits; ``init_moe``
``rtol=1e-5`` (``normal``'s erfinv is torch's); decode against JAX's
forward and greedy serve ``1e-4``, greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.configs import get_config as j_get_config
from repro.configs.base import ArchConfig as JArchConfig
from repro.launch.steps import make_serve_step as j_serve
from repro.models import blocks as jblocks
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import make_serve_step as t_serve
from repro_torch.models import blocks as tblocks
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt

D, F, E = 64, 96, 4
B, S = 2, 24


def _to_port(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _close(got, want, scale):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * np.abs(want).max())


def _j_routing(router_w, x, top_k, capacity_factor, n_experts=E):
    """JAX's top_e and keep, by the lines of its ``apply_moe``."""
    xt = jnp.asarray(x, jnp.float32).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt @ router_w, axis=-1)
    _, top_e = jax.lax.top_k(probs, top_k)
    t = xt.shape[0]
    cap = int(max(1, (t * top_k * capacity_factor) // n_experts))
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, n_experts, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, -1) - 1
    return np.asarray(top_e), np.asarray(pos < cap)


def _inputs(seed, zero_rows=()):
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)
    for b, s in zero_rows:
        x[b, s] = 0.0
    return x


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
def test_init_moe_matches_jax(shared):
    """Key for key: an f32 router beside bf16 experts, each leaf within
    ``normal``'s ``rtol=1e-5`` of JAX's (bf16 leaves: one bf16 step, where
    the two f32 draws round to neighbouring bf16 values)."""
    jp = jmoe.init_moe(jax.random.PRNGKey(3), D, F, E, jnp.bfloat16,
                       shared_expert=shared)
    tp = tmoe.init_moe(trandom.PRNGKey(3, device="cpu"), D, F, E,
                       torch.bfloat16, shared_expert=shared)
    assert sorted(tp) == sorted(jp)
    assert tp["router"]["w"].dtype == torch.float32
    assert tp["w_gate"].dtype == torch.bfloat16
    assert tp["w_down"].shape == (E, F, D)
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   rtol=1e-5 if a.dtype == jnp.float32 else 2 ** -7,
                                   atol=1e-7)


CASES = [(1, False, 1.25), (2, False, 1.25), (1, True, 1.25), (2, True, 1.25),
         (1, False, 0.5), (2, True, 0.5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k,shared,cf", CASES,
                         ids=[f"top{k}-{'shared' if s else 'routed'}-cf{c}"
                              for k, s, c in CASES])
def test_apply_moe_matches_jax(top_k, shared, cf, dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = jmoe.init_moe(jax.random.PRNGKey(1), D, F, E, jdt,
                       shared_expert=shared)
    tp = _to_port(jp)
    x = _inputs(top_k + 2 * shared)
    kw = dict(n_experts=E, top_k=top_k, capacity_factor=cf,
              shared_expert=shared)
    jx = jnp.asarray(x).astype(jdt)
    jy, jaux = jmoe.apply_moe(jp, jx, **kw)
    tx = torch.from_numpy(x).to(tdt)
    tmoe.reset_dispatch_counts()
    ty, taux = tmoe.apply_moe(tp, tx, **kw)
    assert ty.dtype == tdt and ty.shape == (B, S, D)
    assert taux.dtype == torch.float32 and taux.shape == ()

    # The routing: bitwise JAX's, read from the same (bf16-rounded) input.
    want_e, want_keep = _j_routing(jp["router"]["w"], np.asarray(
        jx.astype(jnp.float32)), top_k, cf)
    _, _, top_e, pos, cap = tmoe.route(tp["router"], tx.reshape(-1, D),
                                       n_experts=E, top_k=top_k,
                                       capacity_factor=cf)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal((pos < cap).numpy(), want_keep)
    assert tmoe.dispatch_counts["assigned"] == B * S * top_k
    assert int(tmoe.dispatch_counts["dropped"]) == int((~want_keep).sum())
    if cf < 1:  # at most half the assignments fit
        assert (~want_keep).sum() >= want_keep.size // 2

    scale = 1e-5 if dtype == "float32" else 8 * 2 ** -8
    _close(ty.float().numpy(), np.asarray(jy, np.float32), scale)
    _close(taux.numpy(), np.asarray(jaux), 1e-5)


def test_all_zero_rows_route_in_jax_tie_order():
    """A zero row gives equal logits, so every expert ties: ``lax.top_k``
    takes the lowest indices first, and so does the port."""
    jp = jmoe.init_moe(jax.random.PRNGKey(2), D, F, E, jnp.float32)
    tp = _to_port(jp)
    x = _inputs(5, zero_rows=[(0, 0), (0, 7), (1, 23)])
    for top_k in (1, 2, 3):
        want_e, want_keep = _j_routing(jp["router"]["w"], x, top_k, 1.25)
        _, _, top_e, pos, cap = tmoe.route(
            tp["router"], torch.from_numpy(x).reshape(-1, D), n_experts=E,
            top_k=top_k, capacity_factor=1.25)
        for row in (0, 7, S + 23):
            assert top_e[row].tolist() == list(range(top_k))
        np.testing.assert_array_equal(top_e.numpy(), want_e)
        np.testing.assert_array_equal((pos < cap).numpy(), want_keep)
        jy, _ = jmoe.apply_moe(jp, jnp.asarray(x), n_experts=E, top_k=top_k)
        ty, _ = tmoe.apply_moe(tp, torch.from_numpy(x), n_experts=E,
                               top_k=top_k)
        _close(ty.numpy(), np.asarray(jy), 1e-5)


def _block_cfgs(name, **kw):
    return (j_get_config(name).reduced().replace(**kw),
            t_get_config(name).reduced().replace(**kw))


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e"])
def test_attn_moe_block_prefill_and_decode_match_jax(name):
    """The block's prefill on 24 positions (its aux too), then 6 decode
    steps from an empty cache, against JAX's; the decode batch is the
    MoE layer's tokens, so its capacity is the batch's."""
    jcfg, tcfg = _block_cfgs(name)
    jdef, tdef = jblocks.BLOCKS["attn_moe"], tblocks.get_block("attn_moe")
    jp = jdef.init(jax.random.PRNGKey(5), jcfg)
    tp = _to_port(jp)
    assert ("shared" in tp["moe"]) == tcfg.shared_expert
    x = np.random.default_rng(7).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    ctx = {"positions": torch.from_numpy(pos.copy()), "window": 0,
           "use_flash": False}
    jctx = dict(ctx, positions=jnp.asarray(pos), memory=None)
    want, jaux = jax.jit(lambda p, x: jdef.apply(p, x, jctx, jcfg))(
        jp, jnp.asarray(x))
    got, aux = tdef.apply(tp, torch.from_numpy(x), ctx, tcfg)
    _close(got.numpy(), want, 1e-4)
    _close(aux.numpy(), np.asarray(jaux), 1e-5)

    js = jdef.state(jcfg, B, 8, jnp.float32)
    ts = tdef.state(tcfg, B, 8, torch.float32, "cpu")
    jdecode = jax.jit(lambda pr, x, s, p: jdef.decode(pr, x, s, p, jctx, jcfg))
    for p in range(6):
        jy, js = jdecode(jp, jnp.asarray(x[:, p:p + 1]), js, jnp.asarray(p))
        ty, ts2 = tdef.decode(tp, torch.from_numpy(x[:, p:p + 1]), ts, p,
                              ctx, tcfg)
        assert ts2 is ts  # written in place
        _close(ty.numpy(), jy, 1e-4)
    np.testing.assert_allclose(ts["k"].transpose(1, 2).numpy(),
                               np.asarray(js["k"]), rtol=1e-4, atol=1e-4)


# The moe case of tests/test_decode_consistency.py: capacity factor 4, so
# neither the prefill nor a decode step drops an assignment.
DECODE_CASE = dict(name="t", arch_type="moe", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=4, d_ff=64, vocab=61, n_experts=4,
                   top_k=2, moe_capacity_factor=4.0)


def test_moe_decode_matches_jax_forward():
    """Token-by-token decode through the port against JAX's
    teacher-forced forward at every position (1e-4), and greedy decode's
    tokens equal to JAX's own greedy decode."""
    jcfg, tcfg = JArchConfig(**DECODE_CASE), TArchConfig(**DECODE_CASE)
    jp = jax.jit(lambda k: jt.init_lm(k, jcfg))(jax.random.PRNGKey(42))
    tp = _to_port(jp)
    s = 12
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, s), 0,
                                         jcfg.vocab)).astype(np.int32)
    want, jaux = jax.jit(lambda p, t: jt.forward(p, jcfg, t))(
        jp, jnp.asarray(toks))
    got, aux = tt.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    _close(aux.numpy(), np.asarray(jaux), 1e-5)
    ts = tt.init_decode_state(tcfg, B, s, device="cpu")
    for t in range(s):
        logits, ts = tt.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]),
                                    ts, t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want)[:, t],
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"position {t}")

    js = jt.init_decode_state(jcfg, B, s)
    ts = tt.init_decode_state(tcfg, B, s, device="cpu")
    jstep, tstep = jax.jit(j_serve(jcfg)), t_serve(tcfg)
    jtok, ttok = jnp.asarray(toks[:, :1]), torch.from_numpy(toks[:, :1])
    for pos in range(s):
        jn, jl, js = jstep(jp, jtok, js, jnp.asarray(pos))
        tn, tl, ts = tstep(tp, ttok, ts, pos)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn),
                                      err_msg=f"greedy step {pos}")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        jtok, ttok = jn[:, None], tn[:, None]


def test_params_from_jax_carries_a_moe_tree():
    """A bf16 llama4 tree holds an f32 router beside bf16 experts and a
    bf16 shared expert, under the stack's leading layer axis: each leaf
    arrives in its own dtype, bf16 bit for bit."""
    jcfg, _ = _block_cfgs("llama4-scout-17b-a16e", dtype_name="bfloat16")
    jp = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: jt.init_lm(k, jcfg))(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, device="cpu")
    moe = tp["stack"]["seg0"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["router"]["w"].shape == (1, jcfg.d_model, jcfg.n_experts)
    assert moe["w_up"].dtype == torch.bfloat16
    assert moe["shared"]["gate"]["w"].dtype == torch.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        assert tuple(b.shape) == a.shape
        if a.dtype == ml_dtypes.bfloat16:
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)


def test_dispatch_counts_reset_and_share():
    tmoe.reset_dispatch_counts()
    assert tmoe.dropped_share() == 0.0
    jp = jmoe.init_moe(jax.random.PRNGKey(4), D, F, E, jnp.float32)
    tp = _to_port(jp)
    x = torch.from_numpy(_inputs(9))
    tmoe.apply_moe(tp, x, n_experts=E, top_k=2, capacity_factor=0.5)
    # 96 assignments, capacity 12 an expert: at most 48 kept.
    assert tmoe.dispatch_counts["assigned"] == 96
    assert tmoe.dropped_share() >= 0.5
    tmoe.reset_dispatch_counts()
    assert tmoe.dispatch_counts == {"assigned": 0, "dropped": 0}
