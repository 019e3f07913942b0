"""Port parity: the stablelm-1.6b serving slice against the JAX package.

A 2-layer reduced stablelm (``reduced()`` keeps one layer, so the
superblock is set to two ``attn_mlp`` layers): d_model 256, 4 heads of
64, d_ff 512, vocab 512, LayerNorm with bias, gated SiLU, f32. One JAX
parameter tree goes to both packages (``params_from_jax``); the port
runs on ``device="cpu"``, where the flash-attention wrapper runs its
plain version and the JAX side runs its Pallas kernel in interpret mode
(its ``ops._interpret()`` off-TPU), as ``tests/test_kernels.py`` does.

Held, f32: prefill last-position logits ``rtol=atol=1e-4`` (products
summed in other orders by XLA and torch, through two layers and a head);
greedy decode tokens bitwise and logits ``1e-4``; the port's decode at
position t against its own ``forward`` at t (JAX's
``test_decode_consistency`` invariant, here at ``1e-4`` since both are
f32); ``init_lm`` against JAX's to ``normal``'s ``rtol=1e-5``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.configs import get_config as j_get_config
from repro.launch.steps import make_prefill_step as j_prefill
from repro.launch.steps import make_serve_step as j_serve
from repro.models import transformer as jt
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import make_lm_tokens as t_make_lm_tokens
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.steps import make_prefill_step as t_prefill
from repro_torch.launch.steps import make_serve_step as t_serve
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as tt

TWO_LAYERS = (("attn_mlp", 2, False),)
B, S = 2, 32


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


def _tokens(vocab, seed=0, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(np.int32)


def test_reduced_config_matches_jax():
    jcfg, tcfg = _cfgs()
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
            tcfg.resolved_head_dim, tcfg.d_ff, tcfg.vocab, tcfg.norm,
            tcfg.act, tcfg.use_bias, tcfg.total_layers) == \
        (jcfg.n_layers, jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
         jcfg.resolved_head_dim, jcfg.d_ff, jcfg.vocab, jcfg.norm,
         jcfg.act, jcfg.use_bias, jcfg.total_layers)
    assert tcfg.dtype == torch.float32 and tcfg.total_layers == 2


def test_full_width_config_matches_jax():
    j, t = j_get_config("stablelm-1.6b"), t_get_config("stablelm-1.6b")
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert jf == tf
    assert t.dtype == torch.bfloat16 and t.resolved_head_dim == 64


def test_init_lm_matches_jax(params):
    jp, _ = params
    jcfg, tcfg = _cfgs()
    tp = tt.init_lm(trandom.PRNGKey(0, device="cpu"), tcfg)
    jl = jax.tree_util.tree_leaves(jp)
    tl = tree_leaves(tp)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    assert tp["stack"]["seg0"]["attn"]["wq"]["w"].shape == (2, 256, 256)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)
    assert tcommon.count_params(tp) == sum(x.size for x in jl)


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
def test_prefill_matches_jax(params, use_flash):
    jp, tp = params
    jcfg, tcfg = _cfgs(use_flash=use_flash)
    toks = _tokens(jcfg.vocab)
    want = np.asarray(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)}))
    before = dict(fa_ops.launch_counts)
    got = t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert fa_ops.launch_counts == before  # CPU: the plain version, no launch
    assert got.shape == (B, jcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


VARIANTS = {  # options of the attn_mlp stack beside stablelm's own
    "gqa": dict(n_kv_heads=2, use_flash=True),
    "window": dict(sliding_window=8, use_flash=True),
    "rmsnorm-gelu-ungated-tied": dict(norm="rmsnorm", act="gelu",
                                      gated_mlp=False, tie_embeddings=True,
                                      use_bias=False),
    "relu-no-rope": dict(act="relu", pos_embed="none", use_flash=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_stack_variants_match_jax(variant):
    """Prefill and 6 greedy decode steps of each variant, port against
    JAX from one parameter tree, at the tolerances above."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    jp = jt.init_lm(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert ("lm_head" in tp) == (not tcfg.tie_embeddings)
    toks = _tokens(jcfg.vocab, seed=6)
    want = np.asarray(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)}))
    got = t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    cache = tt.decode_cache_len(tcfg, 6)
    js = jt.init_decode_state(jcfg, B, cache)
    ts = tt.init_decode_state(tcfg, B, cache, device="cpu")
    jstep, tstep = jax.jit(j_serve(jcfg)), t_serve(tcfg)
    jtok, ttok = jnp.asarray(toks[:, :1]), torch.from_numpy(toks[:, :1])
    for pos in range(6):
        jn, jl, js = jstep(jp, jtok, js, jnp.asarray(pos))
        tn, tl, ts = tstep(tp, ttok, ts, pos)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"position {pos}")
        jtok, ttok = jn[:, None], tn[:, None]


@pytest.mark.parametrize("window", [None, 8], ids=["full-cache", "ring"])
def test_greedy_decode_matches_jax(params, window):
    """16 greedy steps from one prompt token: the same tokens, bitwise,
    and logits to 1e-4; ``window=8`` runs the ring-buffer cache."""
    jp, tp = params
    jcfg, tcfg = _cfgs()
    steps = 16
    cache = tt.decode_cache_len(tcfg, steps, window=window)
    assert cache == jt.decode_cache_len(jcfg, steps, window=window)
    js = jt.init_decode_state(jcfg, B, cache)
    ts = tt.init_decode_state(tcfg, B, cache, device="cpu")
    jstep = jax.jit(j_serve(jcfg, window=window))
    tstep = t_serve(tcfg, window=window)
    first = _tokens(jcfg.vocab, seed=1, s=1)
    jtok, ttok = jnp.asarray(first), torch.from_numpy(first)
    for pos in range(steps):
        jn, jl, js = jstep(jp, jtok, js, jnp.asarray(pos))
        tn, tl, ts = tstep(tp, ttok, ts, pos)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"position {pos}")
        jtok, ttok = jn[:, None], tn[:, None]
    assert tn.dtype == torch.int32
    # The port's cache is head-major: (L, B, Hkv, T, Dh) against JAX's
    # (L, B, T, Hkv, Dh).
    np.testing.assert_allclose(ts["seg0"]["k"].transpose(2, 3).numpy(),
                               np.asarray(js["seg0"]["k"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window", [0, 5], ids=["full", "sliding"])
def test_decode_matches_forward(params, window):
    """Token-by-token decode reproduces the teacher-forced forward."""
    _, tp = params
    _, tcfg = _cfgs(sliding_window=window)
    s = 12
    toks = torch.from_numpy(_tokens(tcfg.vocab, seed=2, s=s))
    want, _ = tt.forward(tp, tcfg, toks)
    states = tt.init_decode_state(tcfg, B, tt.decode_cache_len(tcfg, s),
                                  device="cpu")
    for t in range(s):
        logits, states = tt.decode_step(tp, tcfg, toks[:, t:t + 1], states, t)
        torch.testing.assert_close(logits, want[:, t], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["prefill", "decode-cache"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_matches_jax(layout, dtype):
    """The plain attention at JAX's rounding points, GQA 4/2, masked. The
    decode layout runs the head-major cache through ``_sdpa_heads``. bf16
    to one bf16 rounding of the output (2^-8 of its largest value): the
    f32 sums of the two products may differ in order."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(11)
    s = 1 if layout == "decode-cache" else 9
    q = rng.standard_normal((2, s, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, 2, 64)).astype(np.float32)
            for _ in range(2))
    mask = np.array(jattn.causal_mask(s, 12, window=5, offset=12 - s))
    jdt = jnp.dtype(dtype)
    want = np.asarray(jattn._sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                  jnp.asarray(mask)).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    if layout == "decode-cache":
        got = tattn._sdpa_heads(tq, tk.transpose(1, 2).contiguous(),
                                tv.transpose(1, 2).contiguous(),
                                torch.from_numpy(mask))
    else:
        got = tattn._sdpa(tq, tk, tv, torch.from_numpy(mask))
    assert got.dtype == tq.dtype
    tol = 1e-5 if dtype == "float32" else 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=0, atol=tol)


def test_flash_prefill_matches_plain_prefill_in_port(params):
    _, tp = params
    _, tcfg = _cfgs()
    toks = torch.from_numpy(_tokens(tcfg.vocab, seed=3))
    flash = t_prefill(tcfg.replace(use_flash=True))(tp, {"tokens": toks})
    plain = t_prefill(tcfg)(tp, {"tokens": toks})
    torch.testing.assert_close(flash, plain, rtol=1e-4, atol=1e-4)


def test_lm_tokens_match_jax():
    from repro.data.synthetic import make_lm_tokens as j_make_lm_tokens
    want = j_make_lm_tokens(5, 3, 40, 512)
    got = t_make_lm_tokens(5, 3, 40, 512)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens.dtype == np.int32 and got.vocab == want.vocab


def test_params_from_jax_carries_bf16_bit_for_bit():
    """bf16 leaves (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    refuses) arrive with identical bits; f32 leaves are unchanged."""
    rng = np.random.default_rng(4)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    bf = jnp.asarray(f32).astype(jnp.bfloat16)
    tree = {"a": {"w": np.asarray(bf)}, "b": f32, "c": [np.asarray(bf)[0]]}
    assert tree["a"]["w"].dtype == ml_dtypes.bfloat16
    out = params_from_jax(tree, device="cpu")
    for got, want in ((out["a"]["w"], tree["a"]["w"]), (out["c"][0], tree["c"][0])):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    assert out["b"].dtype == torch.float32
    np.testing.assert_array_equal(out["b"].numpy(), f32)


def test_bf16_tree_runs_through_the_port():
    """A bf16 JAX tree carried over runs the port's bf16 prefill: the
    logits stay within bf16 rounding of the JAX package's."""
    jcfg, tcfg = _cfgs(dtype_name="bfloat16", use_flash=True)
    jp = jt.init_lm(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert tp["embed"]["w"].dtype == torch.bfloat16
    toks = _tokens(jcfg.vocab, seed=5)
    want = np.asarray(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)}),
                      np.float32)
    got = t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks)}).float().numpy()
    # bf16 activations round at slightly different points in the two
    # frameworks; a few bf16 steps of the largest logit.
    assert np.abs(got - want).max() <= 8 * 2 ** -8 * np.abs(want).max()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.init_decode_state(tcfg, 1, 4)
