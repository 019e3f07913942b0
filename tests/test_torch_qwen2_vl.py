"""Port parity: qwen2-vl-2b (M-RoPE and vision tokens) against JAX.

qwen2-vl-2b at ``reduced()`` width: d_model 256, 4 heads over 2 kv
heads of 64, qkv biases, ``rope_theta`` 1e6, M-RoPE sections (8, 12,
12), 4 vision tokens, one ``attn_mlp`` layer, f32. Inputs are numpy
arrays from a seed: token ids, vision embeddings (B, 4, 256) at the
embedding's scale, and three distinct position rows (a 2 × 2 grid for
the vision tokens, text positions after it, as Qwen2-VL numbers them).
One JAX parameter tree goes to both packages (``params_from_jax``), the
port on ``device="cpu"``. On the ``flash`` route the port's K3 wrapper
runs its plain version on the CPU and JAX its Pallas kernel in
interpret mode.

The default positions put one ``arange`` in all three rows, where
M-RoPE is plain RoPE; so the prefill and the forward are also held with
three distinct rows, which plain RoPE would fail.

Held, f32: ``apply_mrope`` ``atol=rtol=1e-6`` (reduced and full
sections), and within the port, equal rows give ``apply_rope``'s bits;
``decode_attention`` with M-RoPE ``1e-5``; ``init_lm`` ``rtol=1e-5``;
the prefill's last-position logits and the forward's
``rtol=atol=1e-4`` on both routes; greedy serve tokens equal and logits
``1e-4``; ``per_example_loss`` with vision tokens ``1e-5``; in bf16 the
prefill within ``8·2⁻⁸·max|JAX|``; K3's wrapper at qwen2-vl's 12/2
heads of 128 against JAX's plain attention ``1e-5``.
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
from repro.models import common as jcommon
from repro.models import transformer as jt
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.steps import make_prefill_step as t_prefill
from repro_torch.launch.steps import make_serve_step as t_serve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as tt
from repro_torch.models.common import count_params

NAME = "qwen2-vl-2b"
B, S = 2, 24


def _cfgs(**kw):
    return (j_get_config(NAME).reduced().replace(**kw),
            t_get_config(NAME).reduced().replace(**kw))


def _to_port(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@pytest.fixture(scope="module")
def model():
    jcfg, _ = _cfgs()
    jp = jax.jit(lambda k: jt.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    return jp, _to_port(jp)


def _inputs(cfg, seed=0, s=S, b=B):
    """Token ids and vision embeddings (B, nv, D) at the embedding's
    scale, d_model**-0.5."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    vis = (rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model))
           * cfg.d_model ** -0.5).astype(np.float32)
    return toks, vis


def _positions3(nv, s, b=B):
    """Qwen2-VL's three rows (temporal, height, width): the nv vision
    tokens on a square grid at time 0, the text after them at
    ``grid + i`` in all three rows."""
    side = int(round(nv ** 0.5))
    assert side * side == nv
    t = np.zeros(nv, np.int32)
    h, w = np.divmod(np.arange(nv, dtype=np.int32), side)
    text = side + np.arange(s - nv, dtype=np.int32)
    rows = np.stack([np.concatenate([r, text]) for r in (t, h, w)])
    assert len({tuple(r) for r in rows}) == 3
    return np.ascontiguousarray(np.broadcast_to(rows[:, None], (3, b, s)))


def test_full_width_config_matches_jax():
    j, t = j_get_config(NAME), t_get_config(NAME)
    assert (t.m_rope, t.mrope_sections, t.n_vision_tokens, t.use_bias,
            t.rope_theta, t.n_heads, t.n_kv_heads, t.resolved_head_dim) == \
        (True, (16, 24, 24), 256, True, 1e6, 12, 2, 128)
    assert t.resolved_superblock == j.resolved_superblock == (
        ("attn_mlp", 28, False),)
    jcfg, tcfg = _cfgs()
    assert tcfg.mrope_sections == jcfg.mrope_sections == (8, 12, 12)
    assert tcfg.n_vision_tokens == jcfg.n_vision_tokens == 4


@pytest.mark.parametrize("dh,sections", [(64, (8, 12, 12)),
                                         (128, (16, 24, 24))],
                         ids=["reduced", "full"])
def test_apply_mrope_matches_jax(dh, sections):
    """Three distinct position rows drawn from a seed; then three equal
    rows give ``apply_rope``'s bits."""
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((B, S, 3, dh)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (3, B, S)).astype(np.int32)
    want = np.asarray(jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                          1e6, sections))
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              1e6, sections)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    same = torch.from_numpy(pos3[0])
    assert torch.equal(
        tcommon.apply_mrope(torch.from_numpy(x), same.expand(3, B, S), 1e6,
                            sections),
        tcommon.apply_rope(torch.from_numpy(x), same, 1e6))


def test_decode_attention_with_mrope_matches_jax(model):
    """One decode step of the layer's attention at position 5 over a
    cache filled from a seed: the query and the new key rotated by three
    broadcast rows of ``pos``."""
    jp, tp = model
    jcfg, tcfg = _cfgs()
    jattn_p = jax.tree_util.tree_map(lambda a: a[0], jp["stack"]["seg0"]["attn"])
    tattn_p = {k: {n: a[0] for n, a in v.items()}
               for k, v in tp["stack"]["seg0"]["attn"].items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    hkv, dh, t = tcfg.n_kv_heads, tcfg.resolved_head_dim, 12
    ck, cv = (rng.standard_normal((B, t, hkv, dh)).astype(np.float32)
              for _ in range(2))
    kw = dict(n_heads=tcfg.n_heads, n_kv_heads=hkv, head_dim=dh,
              rope_theta=tcfg.rope_theta, m_rope=True,
              mrope_sections=tcfg.mrope_sections)
    want, jcache = jattn.decode_attention(
        jattn_p, jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        5, **kw)
    cache = {"k": torch.from_numpy(ck).transpose(1, 2).contiguous(),
             "v": torch.from_numpy(cv).transpose(1, 2).contiguous()}
    got, cache = tattn.decode_attention(tattn_p, torch.from_numpy(x), cache,
                                        5, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(cache["k"].transpose(1, 2).numpy(),
                               np.asarray(jcache["k"]), rtol=1e-5, atol=1e-5)


def test_init_lm_matches_jax(model):
    jp, _ = model
    _, tcfg = _cfgs()
    tp = tt.init_lm(trandom.PRNGKey(0, device="cpu"), tcfg)
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)
    assert count_params(tp) == sum(x.size for x in jl)
    assert set(tp["stack"]["seg0"]["attn"]["wq"]) == {"w", "b"}


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_prefill_with_vision_tokens_matches_jax(model, use_flash):
    """The forward's logits at every position and the prefill step's
    last position, the vision embeddings spliced over the first 4 token
    embeddings; then the forward with three distinct position rows."""
    jp, tp = model
    jcfg, tcfg = _cfgs(use_flash=use_flash)
    toks, vis = _inputs(tcfg, seed=3)
    jfwd = jax.jit(lambda p, t, v, pos: jt.forward(
        p, jcfg, t, vision_embeds=v, positions=pos)[0])
    want = jfwd(jp, jnp.asarray(toks), jnp.asarray(vis), None)
    got, _ = tt.forward(tp, tcfg, torch.from_numpy(toks),
                        vision_embeds=torch.from_numpy(vis))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    plain_text, _ = tt.forward(tp, tcfg, torch.from_numpy(toks))
    assert not torch.allclose(plain_text[:, -1], got[:, -1], atol=1e-3)
    before = dict(fa_ops.launch_counts)
    last = t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks),
                                "vision_embeds": torch.from_numpy(vis)})
    assert fa_ops.launch_counts == before  # CPU: the plain version, no launch
    jlast = np.asarray(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks),
                                            "vision_embeds": jnp.asarray(vis)}))
    np.testing.assert_allclose(last.numpy(), jlast, rtol=1e-4, atol=1e-4)

    pos3 = _positions3(tcfg.n_vision_tokens, S)
    want3 = jfwd(jp, jnp.asarray(toks), jnp.asarray(vis), jnp.asarray(pos3))
    got3, _ = tt.forward(tp, tcfg, torch.from_numpy(toks),
                         vision_embeds=torch.from_numpy(vis),
                         positions=torch.from_numpy(pos3))
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), rtol=1e-4,
                               atol=1e-4)
    assert not np.allclose(np.asarray(want3), np.asarray(want), atol=1e-3)


def test_greedy_serve_matches_jax(model):
    """``make_serve_step`` 10 greedy steps from one token against JAX's
    jitted serve step: tokens equal, logits 1e-4, the KV cache 1e-4."""
    jp, tp = model
    jcfg, tcfg = _cfgs()
    steps = 10
    js = jt.init_decode_state(jcfg, B, steps)
    ts = tt.init_decode_state(tcfg, B, steps, device="cpu")
    jstep, tstep = jax.jit(j_serve(jcfg)), t_serve(tcfg)
    first, _ = _inputs(tcfg, seed=4, s=1)
    jtok, ttok = jnp.asarray(first), torch.from_numpy(first)
    for pos in range(steps):
        jn, jl, js = jstep(jp, jtok, js, jnp.asarray(pos))
        tn, tl, ts = tstep(tp, ttok, ts, pos)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"position {pos}")
        jtok, ttok = jn[:, None], tn[:, None]
    np.testing.assert_allclose(ts["seg0"]["k"].transpose(2, 3).numpy(),
                               np.asarray(js["seg0"]["k"]), rtol=1e-4,
                               atol=1e-4)


def test_per_example_loss_with_vision_tokens_matches_jax(model):
    jp, tp = model
    jcfg, tcfg = _cfgs()
    toks, vis = _inputs(tcfg, seed=5, s=S + 1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "vision_embeds": vis}
    want, _ = jt.per_example_loss(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = tt.per_example_loss(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (B,) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_bf16_prefill_matches_jax():
    """One bf16 JAX tree through the port's bf16 flash prefill with the
    vision tokens: within bf16 rounding of JAX's."""
    jcfg, tcfg = _cfgs(dtype_name="bfloat16", use_flash=True)
    jp = jax.jit(lambda k: jt.init_lm(k, jcfg))(jax.random.PRNGKey(1))
    tp = _to_port(jp)
    toks, vis = _inputs(tcfg, seed=6)
    want = np.asarray(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks),
                                           "vision_embeds": jnp.asarray(vis)}),
                      np.float32)
    got = t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks),
                               "vision_embeds": torch.from_numpy(vis)})
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 8 * 2 ** -8 * np.abs(want).max()


def test_flash_attention_12_over_2_heads_matches_jax_plain_attention():
    """K3's wrapper on the CPU (its plain version) at qwen2-vl-2b's GQA
    ratio 6, 12 query heads over 2 kv heads of 128, causal, against JAX's
    plain attention."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((B, 40, 12, 128)).astype(np.float32)
    k, v = (rng.standard_normal((B, 40, 2, 128)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jattn._sdpa(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jattn.causal_mask(40, 40)))
    got = fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
