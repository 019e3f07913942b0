"""Port parity: the five decoder-only configs of the LM zoo against JAX.

minitron-4b, deepseek-coder-33b and command-r-35b (``attn_mlp``: a
non-gated MLP, GQA 56/8, a LayerNorm without bias terms in its dense
layers) and phi3.5-moe-42b-a6.6b and llama4-scout-17b-a16e
(``attn_moe``: 16 experts top-2; top-1 with a shared expert), at
``reduced()`` width (d_model 256, 4 heads of 64, d_ff 512, vocab 512,
4 experts, one layer, f32). Inputs are numpy arrays from a seed; one JAX
parameter tree goes to both packages (``params_from_jax``), the port on
``device="cpu"``. On the ``flash`` route the port's K3 wrapper runs its
plain version on the CPU and JAX its Pallas kernel in interpret mode.

Held, f32: ``init_lm`` ``rtol=1e-5`` (``normal``'s erfinv is torch's);
the prefill's last-position logits and the forward's ``rtol=atol=1e-4``
on both routes, its aux (the MoE layers' load-balance loss, 0 for a
dense stack) ``1e-5·|JAX|``; greedy serve tokens equal and logits
``1e-4``; in bf16 (one bf16 JAX tree carried over) the prefill within
``8·2⁻⁸·max|JAX|``, as ``tests/test_torch_lm.py`` holds stablelm's. K3's
wrapper at the two new GQA ratios (56/8 and 40/8 heads of 128) against
JAX's plain attention ``1e-5``. The registry holds the JAX package's ten
configs, each with its fields; qwen2-vl-2b's and whisper-tiny's parity
tests are ``tests/test_torch_qwen2_vl.py`` and
``tests/test_torch_whisper.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import get_config as j_get_config
from repro.launch.steps import make_prefill_step as j_prefill
from repro.launch.steps import make_serve_step as j_serve
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves
from repro_torch.configs import arch_names
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.steps import make_prefill_step as t_prefill
from repro_torch.launch.steps import make_serve_step as t_serve
from repro_torch.models import transformer as tt
from repro_torch.models.blocks import BLOCKS, get_block
from repro_torch.models.common import count_params

NAMES = ("minitron-4b", "deepseek-coder-33b", "command-r-35b",
         "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
MOE = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
B, S = 2, 24


def _cfgs(name, **kw):
    return (j_get_config(name).reduced().replace(**kw),
            t_get_config(name).reduced().replace(**kw))


def _j_init(key, jcfg):
    return jax.jit(lambda k: jt.init_lm(k, jcfg))(key)


def _to_port(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    jcfg, _ = _cfgs(request.param)
    jp = _j_init(jax.random.PRNGKey(0), jcfg)
    return request.param, jp, _to_port(jp)


def _tokens(vocab, seed=0, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(np.int32)


@pytest.mark.parametrize("name", NAMES + ("qwen2-vl-2b", "whisper-tiny"))
def test_full_width_config_matches_jax(name):
    j, t = j_get_config(name), t_get_config(name)
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert jf == tf
    assert t.dtype == torch.bfloat16
    assert t.resolved_superblock == j.resolved_superblock
    kind = {"whisper-tiny": "xattn"}.get(
        name, "attn_moe" if name in MOE else "attn_mlp")
    assert t.resolved_superblock[0][0] == kind


def test_registry_serves_all_but_two_configs():
    """The port registers all ten of the JAX package's configs with
    equal fields (the name is from when it served eight), and each
    builds without a refusal: every block kind of its stack and of its
    encoder resolves, and its decode state forms at ``reduced()`` size."""
    assert sorted(arch_names()) == sorted(J_REGISTRY) and len(J_REGISTRY) == 10
    for name, jcfg in J_REGISTRY.items():
        fields = {f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg)}
        cfg = TArchConfig(**fields)
        assert cfg == t_get_config(name)
        kinds = [k for k, _, _ in cfg.resolved_superblock]
        kinds += ["enc_attn_mlp"] if cfg.enc_dec else []
        for kind in kinds:
            assert get_block(kind) is BLOCKS[kind]
        state = tt.init_decode_state(cfg.reduced(), 1, 4, device="cpu")
        assert sorted(state) == [f"seg{i}" for i, (k, _, _) in enumerate(
            cfg.resolved_superblock) if BLOCKS[k].state is not None]


def test_init_lm_matches_jax(model):
    name, jp, _ = model
    _, tcfg = _cfgs(name)
    tp = tt.init_lm(trandom.PRNGKey(0, device="cpu"), tcfg)
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    assert [str(x.dtype)[6:] for x in tl] == [str(x.dtype) for x in jl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)
    assert count_params(tp) == sum(x.size for x in jl)
    layer = tp["stack"]["seg0"]
    if name in MOE:
        assert layer["moe"]["w_gate"].shape == (1, tcfg.n_experts, 256, 512)
        assert ("shared" in layer["moe"]) == tcfg.shared_expert
    else:
        assert ("gate" in layer["mlp"]) == tcfg.gated_mlp
        assert ("bias" in layer["ln1"]) == (tcfg.norm == "layernorm")
        assert "b" not in layer["attn"]["wq"]


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_prefill_matches_jax(model, use_flash):
    """The forward's logits at every position and its aux, and the
    prefill step's last position, against JAX's."""
    name, jp, tp = model
    jcfg, tcfg = _cfgs(name, use_flash=use_flash)
    toks = _tokens(jcfg.vocab, seed=3)
    want, jaux = jax.jit(lambda p, t: jt.forward(p, jcfg, t))(
        jp, jnp.asarray(toks))
    got, aux = tt.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-5,
                               atol=0)
    assert (float(aux) > 0) == (name in MOE)
    before = dict(fa_ops.launch_counts)
    last = t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert fa_ops.launch_counts == before  # CPU: the plain version, no launch
    jlast = np.asarray(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)}))
    np.testing.assert_allclose(last.numpy(), jlast, rtol=1e-4, atol=1e-4)


def test_greedy_serve_matches_jax(model):
    """``make_serve_step`` 10 greedy steps from one token against JAX's
    jitted serve step: tokens equal, logits 1e-4, the KV caches 1e-4
    (head-major in the port). At B = 2 a decode step routes two tokens,
    with the capacity of two."""
    name, jp, tp = model
    jcfg, tcfg = _cfgs(name)
    steps = 10
    js = jt.init_decode_state(jcfg, B, steps)
    ts = tt.init_decode_state(tcfg, B, steps, device="cpu")
    jstep, tstep = jax.jit(j_serve(jcfg)), t_serve(tcfg)
    first = _tokens(jcfg.vocab, seed=4, s=1)
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


@pytest.mark.parametrize("name", NAMES)
def test_bf16_prefill_matches_jax(name):
    """One bf16 JAX tree (an MoE config's router stays f32) through the
    port's bf16 flash prefill: within bf16 rounding of JAX's."""
    jcfg, tcfg = _cfgs(name, dtype_name="bfloat16", use_flash=True)
    jp = _j_init(jax.random.PRNGKey(1), jcfg)
    tp = _to_port(jp)
    toks = _tokens(jcfg.vocab, seed=5)
    want = np.asarray(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)}),
                      np.float32)
    got = t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 8 * 2 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("name", MOE)
def test_moe_drops_on_zipf_tokens_match_jax(name, monkeypatch):
    """The dropped assignments of a prefill of the Zipf-Markov token
    stream that ``chip_smoke.py`` serves (``make_lm_tokens``), two layers
    deep: each MoE layer's routing, recomputed by JAX's lines from the
    hidden states the port's layer received and the same router, gives
    the port's chosen experts and drop mask bitwise, so its dropped share
    too."""
    from test_torch_moe import _j_routing

    from repro_torch.data import make_lm_tokens
    from repro_torch.models import moe as tmoe

    jcfg, tcfg = _cfgs(name, n_layers=2, superblock=())
    tp = _to_port(_j_init(jax.random.PRNGKey(2), jcfg))
    toks = make_lm_tokens(0, 8, 64, tcfg.vocab).tokens[:, :64]
    inputs, route = [], tmoe.route

    def recording(router, xt, **kw):
        inputs.append((router["w"], xt))
        return route(router, xt, **kw)

    monkeypatch.setattr(tmoe, "route", recording)
    monkeypatch.setattr(tmoe, "routing_log", [])
    tmoe.reset_dispatch_counts()
    t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks.astype(np.int32))})
    assert len(inputs) == len(tmoe.routing_log) == 2
    dropped = 0
    for (w, xt), (top_e, keep) in zip(inputs, tmoe.routing_log):
        want_e, want_keep = _j_routing(
            jnp.asarray(w.numpy()), xt.numpy(), tcfg.top_k,
            tcfg.moe_capacity_factor, n_experts=tcfg.n_experts)
        np.testing.assert_array_equal(top_e.numpy(), want_e)
        np.testing.assert_array_equal(keep.reshape(-1).numpy(), want_keep)
        dropped += int((~want_keep).sum())
    assert int(tmoe.dispatch_counts["dropped"]) == dropped > 0


@pytest.mark.parametrize("h", [56, 40, 64, 32],
                         ids=["deepseek-56/8", "llama4-40/8", "command-r-64/8",
                              "phi3.5-32/8"])
def test_flash_attention_gqa_ratios_match_jax_plain_attention(h):
    """K3's wrapper on the CPU (its plain version) at the GQA ratios of
    deepseek-coder-33b (7), llama4-scout (5), command-r-35b (8) and
    phi3.5-moe (4), 8 kv heads of 128, causal, against JAX's plain
    attention."""
    rng = np.random.default_rng(h)
    q = rng.standard_normal((1, 40, h, 128)).astype(np.float32)
    k, v = (rng.standard_normal((1, 40, 8, 128)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jattn._sdpa(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jattn.causal_mask(40, 40)))
    got = fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
