"""Port parity: whisper-tiny (the encoder-decoder) against JAX.

whisper-tiny at ``reduced()`` width: d_model 256, 4 heads of 64 (MHA),
LayerNorm with biases, a non-gated gelu MLP, biases in every dense
layer, sinusoidal positions, 2 ``enc_attn_mlp`` encoder layers over 16
frames and one ``xattn`` decoder layer, f32. Inputs are numpy arrays
from a seed: token ids and frame embeddings (B, 16, 256). One JAX
parameter tree goes to both packages (``params_from_jax``), the port on
``device="cpu"``. On the ``flash`` route the decoder's causal
self-attention goes through the port's K3 wrapper (its plain version on
the CPU) and JAX's Pallas kernel in interpret mode; the encoder and the
cross attention take the plain attention in both packages.

Held, f32: ``sinusoidal`` at positions 0…1,499 (see its test for the
bound); ``attention`` bidirectional and with ``kv_override``, and
``decode_attention`` with ``kv_override``, ``1e-5``; ``init_lm`` with
its encoder tree ``rtol=1e-5``; ``params_from_jax`` carries the encoder
tree leaf for leaf; ``encode`` ``1e-5``; the prefill's last-position
logits and the forward's ``rtol=atol=1e-4`` on both routes; greedy serve
through ``memory``: tokens equal, logits ``1e-4``; ``per_example_loss``
with the frames ``1e-5``; in bf16 the prefill within
``8·2⁻⁸·max|JAX|``; K3's wrapper at whisper's 6 heads of 64 with a
ragged S against JAX's plain attention ``1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.configs import get_config as j_get_config
from repro.launch.steps import make_prefill_step as j_prefill
from repro.launch.steps import make_serve_step as j_serve
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro_torch import random as trandom
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.steps import make_prefill_step as t_prefill
from repro_torch.launch.steps import make_serve_step as t_serve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.common import count_params

NAME = "whisper-tiny"
B, S = 2, 20


def _cfgs(**kw):
    return (j_get_config(NAME).reduced().replace(**kw),
            t_get_config(NAME).reduced().replace(**kw))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    jcfg, _ = _cfgs()
    jp = jax.jit(lambda k: jt.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    return jp, params_from_jax(_np_tree(jp), device="cpu")


def _inputs(cfg, seed=0, s=S, b=B):
    """Token ids and frame embeddings (B, enc_len, D) of unit scale."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    feats = rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return toks, feats


def _layer(tree, i=0):
    """Layer ``i`` of a stacked parameter tree (a dict of tensors)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def test_full_width_config_matches_jax():
    j, t = j_get_config(NAME), t_get_config(NAME)
    assert (t.enc_dec, t.n_enc_layers, t.enc_len, t.pos_embed, t.norm, t.act,
            t.gated_mlp, t.use_bias, t.n_heads, t.n_kv_heads,
            t.resolved_head_dim) == \
        (True, 4, 1500, "sinusoidal", "layernorm", "gelu", False, True, 6, 6,
         64)
    assert t.resolved_superblock == j.resolved_superblock == (
        ("xattn", 4, False),)
    jcfg, tcfg = _cfgs()
    assert (tcfg.n_enc_layers, tcfg.enc_len) == (jcfg.n_enc_layers,
                                                 jcfg.enc_len) == (2, 16)


@pytest.mark.parametrize("d_model", [384, 256])
def test_sinusoidal_matches_jax(d_model):
    """Positions 0…1,499 (whisper's frames). The frequencies
    ``exp(-log(1e4)·i/half)`` agree to one f32 ulp: XLA's f32 ``exp`` and
    torch's round some of them to neighbouring floats. Where a frequency
    is the same float, the embedding agrees within 1e-6; where it is
    not, the angle ``p·f`` moves by ``p·|Δf|`` plus the rounding of the
    product, so the bound there is ``1e-6 + p·|Δf| + ulp(p·f)``."""
    half = d_model // 2
    jf = np.asarray(jnp.exp(-jnp.log(10000.0)
                            * jnp.arange(half, dtype=jnp.float32) / half))
    tf = tt._sinusoidal_freqs(d_model).numpy()
    np.testing.assert_allclose(tf, jf, rtol=2 ** -23, atol=0)
    pos = np.arange(1500)
    want = np.asarray(jt.sinusoidal(jnp.asarray(pos), d_model))
    got = tt.sinusoidal(torch.from_numpy(pos), d_model).numpy()
    assert got.shape == want.shape == (1500, d_model)
    ang = (pos[:, None] * jf[None, :]).astype(np.float32)
    slack = pos[:, None] * np.abs(tf - jf)[None, :] + np.spacing(ang)
    bound = 1e-6 + np.where(tf == jf, 0.0, slack)
    assert (np.abs(got - want) <= np.concatenate([bound, bound], 1)).all()
    same = np.concatenate([tf == jf] * 2)
    assert same.sum() >= d_model // 2
    np.testing.assert_allclose(got[:, same], want[:, same], rtol=0, atol=1e-6)


def test_attention_over_memory_matches_jax(model):
    """The decoder layer's cross attention over a (B, 16, D) memory and
    its self attention bidirectionally, in prefill; and one decode step
    of the cross attention, which returns its cache untouched."""
    jp, tp = model
    _, tcfg = _cfgs()
    jx, tx = (_layer(p["stack"]["seg0"]) for p in (jp, tp))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 7, tcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 16, tcfg.d_model)).astype(np.float32)
    kw = dict(n_heads=tcfg.n_heads, n_kv_heads=tcfg.n_kv_heads,
              head_dim=tcfg.resolved_head_dim)
    for name, extra in (("cross", {"kv_override": mem}),
                        ("self", {"causal": False})):
        want = jattn.attention(jx[name], jnp.asarray(x), **kw, **{
            k: jnp.asarray(v) if k == "kv_override" else v
            for k, v in extra.items()})
        got = tattn.attention(tx[name], torch.from_numpy(x), **kw, **{
            k: torch.from_numpy(v) if k == "kv_override" else v
            for k, v in extra.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    want, _ = jattn.decode_attention(jx["cross"], jnp.asarray(x[:, :1]), None,
                                     3, kv_override=jnp.asarray(mem), **kw)
    cache = object()
    got, same = tattn.decode_attention(tx["cross"], torch.from_numpy(x[:, :1]),
                                       cache, 3, kv_override=torch.from_numpy(mem),
                                       **kw)
    assert same is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_init_lm_matches_jax(model):
    """The decoder, the head and the encoder tree (``encoder.stack`` of 2
    ``enc_attn_mlp`` layers and its final norm), drawn from the fourth
    of ``split(key, 4)``, as JAX draws them."""
    jp, _ = model
    _, tcfg = _cfgs()
    tp = tt.init_lm(trandom.PRNGKey(0, device="cpu"), tcfg)
    assert sorted(tp) == sorted(jp) == ["embed", "encoder", "final_norm",
                                        "lm_head", "stack"]
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)
    assert count_params(tp) == sum(x.size for x in jl)
    enc = tp["encoder"]["stack"]["seg0"]
    assert enc["attn"]["wq"]["w"].shape == (2, 256, 256)
    assert set(enc["ln1"]) == {"scale", "bias"} and "gate" not in enc["mlp"]
    assert set(tp["stack"]["seg0"]) == {"ln1", "self", "ln2", "cross", "ln3",
                                        "mlp"}


def test_params_from_jax_carries_the_encoder_tree(model):
    """Every leaf under ``encoder``, by path, dtype and value."""
    jp, tp = model
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jp["encoder"])[0]}
    got = {"/".join(str(k) for k in p): v
           for p, v in tree_flatten_with_path(tp["encoder"])[0]}
    assert sorted(got) == sorted(want) and len(got) == 18
    for path, w in want.items():
        assert str(got[path].dtype)[6:] == str(w.dtype)
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=path)


def test_encode_matches_jax(model):
    jp, tp = model
    jcfg, tcfg = _cfgs()
    _, feats = _inputs(tcfg, seed=1)
    want = jax.jit(lambda p, f: jt.encode(p, jcfg, f))(jp, jnp.asarray(feats))
    got = tt.encode(tp, tcfg, torch.from_numpy(feats))
    assert got.shape == (B, 16, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_prefill_with_audio_matches_jax(model, use_flash):
    """The forward's logits at every position (the frames encoded once,
    the decoder reading them in its cross attention) and the prefill
    step's last position."""
    jp, tp = model
    jcfg, tcfg = _cfgs(use_flash=use_flash)
    toks, feats = _inputs(tcfg, seed=3)
    want, _ = jax.jit(lambda p, t, f: jt.forward(p, jcfg, t, audio_feats=f))(
        jp, jnp.asarray(toks), jnp.asarray(feats))
    got, aux = tt.forward(tp, tcfg, torch.from_numpy(toks),
                          audio_feats=torch.from_numpy(feats))
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    before = dict(fa_ops.launch_counts)
    batch = {"tokens": toks, "audio_feats": feats}
    last = t_prefill(tcfg)(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert fa_ops.launch_counts == before  # CPU: the plain version, no launch
    jlast = np.asarray(j_prefill(jcfg)(jp, {k: jnp.asarray(v)
                                            for k, v in batch.items()}))
    np.testing.assert_allclose(last.numpy(), jlast, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="audio_feats"):
        t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks)})


def test_greedy_serve_with_memory_matches_jax(model):
    """``make_serve_step`` 10 greedy steps from one token with the
    encoder's memory, against JAX's jitted serve step: tokens equal,
    logits 1e-4, the self-attention KV cache 1e-4."""
    jp, tp = model
    jcfg, tcfg = _cfgs()
    first, feats = _inputs(tcfg, seed=4, s=1)
    jmem = jt.encode(jp, jcfg, jnp.asarray(feats))
    tmem = tt.encode(tp, tcfg, torch.from_numpy(feats))
    steps = 10
    js = jt.init_decode_state(jcfg, B, steps)
    ts = tt.init_decode_state(tcfg, B, steps, device="cpu")
    jstep, tstep = jax.jit(j_serve(jcfg)), t_serve(tcfg)
    jtok, ttok = jnp.asarray(first), torch.from_numpy(first)
    for pos in range(steps):
        jn, jl, js = jstep(jp, jtok, js, jnp.asarray(pos), jmem)
        tn, tl, ts = tstep(tp, ttok, ts, pos, tmem)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"position {pos}")
        jtok, ttok = jn[:, None], tn[:, None]
    np.testing.assert_allclose(ts["seg0"]["k"].transpose(2, 3).numpy(),
                               np.asarray(js["seg0"]["k"]), rtol=1e-4,
                               atol=1e-4)


def test_per_example_loss_with_audio_matches_jax(model):
    jp, tp = model
    jcfg, tcfg = _cfgs()
    toks, feats = _inputs(tcfg, seed=5, s=S + 1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "audio_feats": feats}
    want, _ = jt.per_example_loss(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = tt.per_example_loss(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_bf16_prefill_matches_jax():
    """One bf16 JAX tree through the port's bf16 flash prefill with the
    frames: within bf16 rounding of JAX's."""
    jcfg, tcfg = _cfgs(dtype_name="bfloat16", use_flash=True)
    jp = jax.jit(lambda k: jt.init_lm(k, jcfg))(jax.random.PRNGKey(1))
    tp = params_from_jax(_np_tree(jp), device="cpu")
    toks, feats = _inputs(tcfg, seed=6)
    want = np.asarray(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks),
                                           "audio_feats": jnp.asarray(feats)}),
                      np.float32)
    got = t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks),
                               "audio_feats": torch.from_numpy(feats)})
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 8 * 2 ** -8 * np.abs(want).max()


def test_flash_attention_6_heads_of_64_ragged_matches_jax_plain_attention():
    """K3's wrapper on the CPU (its plain version) at whisper-tiny's
    decoder self-attention, 6 heads of 64 (MHA), causal, at an S that is
    no multiple of the kernel's 128-row tile (448, whisper's text
    context, is none either), against JAX's plain attention."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((B, 45, 6, 64)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jattn._sdpa(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jattn.causal_mask(45, 45)))
    got = fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
