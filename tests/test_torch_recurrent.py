"""Port parity: the recurrent blocks and their two configs against JAX.

zamba2-2.7b (9 × (5 Mamba2 + 1 shared attention)) and xlstm-1.3b (6 × (7
mLSTM + 1 sLSTM)) at ``reduced()`` width (d_model 256, f32; each segment
one block, two super-blocks), and the four recurrent cases of
``tests/test_decode_consistency.py``. Inputs are numpy arrays from a
seed; one JAX parameter tree goes to both packages (``params_from_jax``),
the port on ``device="cpu"``.

Two routes. The plain route runs ``chunked_gla`` and plain attention in
both packages (``reduced()``'s chunk 8). The kernel route
(``use_flash=True``) sends the port's scan through K4's wrapper and its
attention through K3's, which on the CPU run their plain versions (the
sequential recurrence, f32 attention), while JAX still runs
``chunked_gla`` and its Pallas flash kernel in interpret mode. K4 takes
chunks of 16, 32 and 64 only, so kernel-route cases set ``gla_chunk=16``
on both sides.

Tolerances, f32: ``causal_conv`` 1e-6; a block's output ``1e-4·max|JAX|``
(the sequential recurrence and the chunked one sum in other orders);
logits ``rtol=atol=1e-4`` (as ``tests/test_torch_lm.py``); keys bitwise;
``init_lm`` ``rtol=1e-5`` (``normal``'s erfinv is torch's); greedy tokens
equal.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.configs import get_config as j_get_config
from repro.configs.base import ArchConfig as JArchConfig
from repro.launch.steps import make_prefill_step as j_prefill
from repro.launch.steps import make_serve_step as j_serve
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.launch.steps import make_prefill_step as t_prefill
from repro_torch.launch.steps import make_serve_step as t_serve
from repro_torch.models import blocks as tblocks
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.common import count_params

NAMES = ("zamba2-2.7b", "xlstm-1.3b")
B, S = 2, 24


def _cfgs(name, **kw):
    return (j_get_config(name).reduced().replace(**kw),
            t_get_config(name).reduced().replace(**kw))


def _j_init(key, jcfg):
    """JAX's ``init_lm``, jitted (one compile, not one an op)."""
    return jax.jit(lambda k: jt.init_lm(k, jcfg))(key)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_port(tree):
    return params_from_jax(_np_tree(tree), device="cpu")


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = _j_init(jax.random.PRNGKey(0), jcfg)
    return request.param, jp, _to_port(jp)


def _tokens(vocab, seed=0, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(np.int32)


def _j_forward(jp, jcfg, toks):
    """JAX's ``forward`` logits, jitted (one compile, not one an op)."""
    return jax.jit(lambda p, t: jt.forward(p, jcfg, t)[0])(jp, jnp.asarray(toks))


def _close(got, want, scale=1e-4):
    """``max|got − want| <= scale · max|want|``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * np.abs(want).max())


# ------------------------------------------------------------ configs, keys

@pytest.mark.parametrize("name", NAMES)
def test_full_width_config_matches_jax(name):
    j, t = j_get_config(name), t_get_config(name)
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert jf == tf
    assert t.dtype == torch.bfloat16 and t.n_super > 1
    assert t.total_layers == j.n_layers


@pytest.mark.parametrize("shape", [(9, 5), (6, 7), (1, 3)])
def test_split_keys_at_a_shape_bitwise(shape):
    """``jax.random.split(key, (n_super, count))``, the keys of a
    repeated segment."""
    for seed in (0, 42):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), shape))
        got = trandom.split(trandom.PRNGKey(seed, device="cpu"), shape)
        assert tuple(got.shape) == shape + (2,)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    batched = trandom.split(trandom.split(trandom.PRNGKey(3, device="cpu"), 2),
                            shape)
    assert tuple(batched.shape) == (2,) + shape + (2,)


def test_init_lm_matches_jax(model):
    name, jp, _ = model
    jcfg, tcfg = _cfgs(name)
    tp = tt.init_lm(trandom.PRNGKey(0, device="cpu"), tcfg)
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    assert [str(x.dtype)[6:] for x in tl] == [str(x.dtype) for x in jl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)
    assert count_params(tp) == sum(x.size for x in jl)
    seg0 = tp["stack"]["seg0"]
    lead = (tcfg.n_super, 1)
    assert tree_leaves(seg0)[0].shape[:2] == lead
    if name == "zamba2-2.7b":  # the shared attention block: one set
        assert tp["stack"]["seg1"]["attn"]["wq"]["w"].shape == (256, 256)


def test_params_from_jax_carries_each_leaf_dtype():
    """A bf16 zamba2 tree mixes f32 leaves (a_log, dt_bias, d_skip;
    xlstm's w_gates) with bf16 ones under leading (n_super, count) axes:
    each arrives in its own dtype, bf16 bit for bit."""
    for name in NAMES:
        jcfg, _ = _cfgs(name, dtype_name="bfloat16")
        jp = _np_tree(_j_init(jax.random.PRNGKey(1), jcfg))
        tp = params_from_jax(jp, device="cpu")
        for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
            assert tuple(b.shape) == a.shape
            if a.dtype == ml_dtypes.bfloat16:
                assert b.dtype == torch.bfloat16
                np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                              a.view(np.int16))
            else:
                assert a.dtype == np.float32 and b.dtype == torch.float32
                np.testing.assert_array_equal(b.numpy(), a)
        mixer = tp["stack"]["seg0"]["mixer"]
        f32 = ("a_log", "dt_bias", "d_skip") if name == "zamba2-2.7b" else ()
        for leaf in f32:
            assert mixer[leaf].dtype == torch.float32
            assert mixer[leaf].shape[:2] == (jcfg.n_super, 1)
        if name == "xlstm-1.3b":
            assert mixer["w_gates"]["w"].dtype == torch.float32


# ------------------------------------------------------------------ pieces

@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 9, 20)).astype(np.float32)
    jparams = jssm.init_causal_conv(jax.random.PRNGKey(2), 20, 4, jnp.float32)
    jparams = dict(jparams, b=jnp.asarray(rng.standard_normal(20), jnp.float32))
    state = rng.standard_normal((B, 3, 20)).astype(np.float32) if with_state else None
    jy, js = jssm.causal_conv(jparams, jnp.asarray(x),
                              None if state is None else jnp.asarray(state))
    ty, ts = tssm.causal_conv(
        _to_port(jparams), torch.from_numpy(x),
        None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=0)


BLOCK_CFGS = {"mamba2": "zamba2-2.7b", "mlstm": "xlstm-1.3b",
              "slstm": "xlstm-1.3b"}


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("kind", sorted(BLOCK_CFGS))
def test_block_apply_and_decode_match_jax(kind, use_flash):
    """A block's prefill on 24 positions, then 6 decode steps from a zero
    state, against JAX's, and the states after them."""
    jcfg, tcfg = _cfgs(BLOCK_CFGS[kind], gla_chunk=16, use_flash=use_flash)
    jdef, tdef = jblocks.BLOCKS[kind], tblocks.get_block(kind)
    jp = jdef.init(jax.random.PRNGKey(5), jcfg)
    tp = _to_port(jp)
    x = np.random.default_rng(7).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    ctx = {"positions": None, "window": 0, "use_flash": use_flash}
    jctx = dict(ctx, memory=None)
    want, _ = jax.jit(lambda p, x: jdef.apply(p, x, jctx, jcfg))(jp, jnp.asarray(x))
    before = scan_ops.launch_counts["gla_scan"]
    got, aux = tdef.apply(tp, torch.from_numpy(x), ctx, tcfg)
    assert scan_ops.launch_counts["gla_scan"] == before  # CPU: no launch
    assert float(aux) == 0.0
    _close(got.numpy(), want)

    js = jdef.state(jcfg, B, 8, jnp.float32)
    ts = tdef.state(tcfg, B, 8, torch.float32, "cpu")
    jdecode = jax.jit(lambda p, x, s: jdef.decode(p, x, s, 0, jctx, jcfg))
    for pos in range(6):
        jy, js = jdecode(jp, jnp.asarray(x[:, pos:pos + 1]), js)
        ty, ts2 = tdef.decode(tp, torch.from_numpy(x[:, pos:pos + 1]), ts, pos,
                              ctx, tcfg)
        assert ts2 is ts  # written in place
        _close(ty.numpy(), jy)
    for name in ts:
        _close(ts[name].numpy(), js[name])


def test_kernel_route_refuses_gradients_and_chunk_8():
    """K4 has no backward, and takes chunks of 16, 32 and 64 only:
    ``reduced()``'s chunk 8 raises on the kernel route, on any device."""
    _, tcfg = _cfgs("zamba2-2.7b", use_flash=True)
    tp = tt.init_lm(trandom.PRNGKey(0, device="cpu"), tcfg)
    toks = torch.from_numpy(_tokens(tcfg.vocab))
    with pytest.raises(ValueError, match="chunk 8 not in"):
        t_prefill(tcfg)(tp, {"tokens": toks})
    cfg16 = tcfg.replace(gla_chunk=16)
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        tt.forward(tp, cfg16, toks)
    # the plain route trains: a loss with gradients through chunked_gla
    loss, _ = tt.per_example_loss(tp, cfg16.replace(use_flash=False),
                                  {"tokens": toks, "labels": toks})
    grads = torch.autograd.grad(loss.sum(), tree_leaves(tp))
    assert all(torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------- whole models

@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "kernel"])
def test_prefill_matches_jax_forward(model, use_flash):
    """All positions' logits (``forward``) and the prefill step's last
    position, against JAX's forward."""
    name, jp, tp = model
    kw = dict(use_flash=True, gla_chunk=16) if use_flash else {}
    jcfg, tcfg = _cfgs(name, **kw)
    toks = _tokens(jcfg.vocab, seed=3)
    want = np.asarray(_j_forward(jp, jcfg, toks))
    counts = dict(fa_ops.launch_counts), dict(scan_ops.launch_counts)
    got, _ = tt.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    last = t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert (dict(fa_ops.launch_counts), dict(scan_ops.launch_counts)) == counts
    np.testing.assert_allclose(last.numpy(), want[:, -1], rtol=1e-4, atol=1e-4)
    jlast = np.asarray(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)}))
    np.testing.assert_allclose(last.numpy(), jlast, rtol=1e-4, atol=1e-4)


def test_greedy_serve_matches_jax(model):
    """``make_serve_step`` 12 greedy steps from one token against JAX's
    jitted serve step: tokens equal, logits 1e-4, and the decode states
    (the shared block's KV cache a call site, head-major in the port)."""
    name, jp, tp = model
    jcfg, tcfg = _cfgs(name)
    steps = 12
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
    for (jpath, jleaf), tleaf in zip(
            jax.tree_util.tree_flatten_with_path(js)[0], tree_leaves(ts)):
        jleaf = np.asarray(jleaf)
        if jpath[-1].key in ("k", "v"):  # (..., B, T, Hkv, Dh) in JAX
            tleaf = tleaf.transpose(-3, -2)
        assert tuple(tleaf.shape) == jleaf.shape
        np.testing.assert_allclose(tleaf.numpy(), jleaf, rtol=1e-4, atol=1e-4)
    if name == "zamba2-2.7b":
        assert ts["seg1"]["k"].shape[0] == tcfg.n_super  # one cache a call site
        assert ts["seg0"]["ssm"].shape[:2] == (tcfg.n_super, 1)


# The recurrent cases of tests/test_decode_consistency.py.
DECODE_CASES = {
    "mamba2": dict(name="t", arch_type="ssm", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=4, d_ff=0, vocab=61, ssm_state=8,
                   ssm_head_dim=8, gla_chunk=4,
                   superblock=(("mamba2", 2, False),)),
    "mlstm": dict(name="t", arch_type="ssm", n_layers=2, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=0, vocab=61, gla_chunk=4,
                  superblock=(("mlstm", 2, False),)),
    "slstm": dict(name="t", arch_type="ssm", n_layers=2, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=64, vocab=61, slstm_heads=2,
                  superblock=(("slstm", 2, False),)),
    "hybrid_shared": dict(
        name="t", arch_type="hybrid", n_layers=4, d_model=32, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=61, ssm_state=8, ssm_head_dim=8,
        gla_chunk=4, superblock=(("mamba2", 1, False), ("attn_mlp", 1, True)),
        n_super=2),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_matches_jax_forward(case):
    """Token-by-token decode through the port against JAX's teacher-forced
    forward at every position (1e-4), and greedy decode's tokens equal
    to JAX's own greedy decode."""
    jcfg, tcfg = JArchConfig(**DECODE_CASES[case]), TArchConfig(**DECODE_CASES[case])
    jp = _j_init(jax.random.PRNGKey(42), jcfg)
    tp = _to_port(jp)
    s = 12
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, s), 0,
                                         jcfg.vocab)).astype(np.int32)
    want = np.asarray(_j_forward(jp, jcfg, toks))
    cache = tt.decode_cache_len(tcfg, s)
    ts = tt.init_decode_state(tcfg, B, cache, device="cpu")
    for t in range(s):
        logits, ts = tt.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]),
                                    ts, t)
        np.testing.assert_allclose(logits.numpy(), want[:, t], rtol=1e-4,
                                   atol=1e-4, err_msg=f"{case}: position {t}")

    js = jt.init_decode_state(jcfg, B, cache)
    ts = tt.init_decode_state(tcfg, B, cache, device="cpu")
    jstep, tstep = jax.jit(j_serve(jcfg)), t_serve(tcfg)
    jtok, ttok = jnp.asarray(toks[:, :1]), torch.from_numpy(toks[:, :1])
    for pos in range(s):
        jn, _, js = jstep(jp, jtok, js, jnp.asarray(pos))
        tn, _, ts = tstep(tp, ttok, ts, pos)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn),
                                      err_msg=f"{case}: greedy step {pos}")
        jtok, ttok = jn[:, None], tn[:, None]


@pytest.mark.parametrize("name", NAMES)
def test_bf16_port_is_as_close_to_f32_as_jax_bf16(name):
    """bf16 through a deeper reduced stack (3 blocks a segment, 2
    super-blocks: 12 layers). bf16 rounding grows with depth in these
    models, in the JAX package as in the port: the port's bf16 forward
    (one bf16 JAX tree carried over) is no farther from JAX's f32 forward
    of the same weights than 1.5x JAX's own bf16 forward is. The card's
    reference rule, whose floor is the plain bf16 prefill's distance from
    an f32 reference, rests on this."""
    sb = tuple((k, 3, sh) for k, _, sh in j_get_config(name).superblock)
    j16, t16 = _cfgs(name, superblock=sb, dtype_name="bfloat16")
    j32 = j16.replace(dtype_name="float32")
    jp = _j_init(jax.random.PRNGKey(0), j16)
    jp32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp)
    toks = _tokens(j16.vocab, seed=10, s=32)
    want = np.asarray(_j_forward(jp32, j32, toks))[:, -1]
    jax16 = np.asarray(_j_forward(jp, j16, toks), np.float32)[:, -1]
    got, _ = tt.forward(_to_port(jp), t16, torch.from_numpy(toks))
    got = got[:, -1].float().numpy()
    jax_dist = np.abs(jax16 - want).max()
    assert 0 < np.abs(got - want).max() <= 1.5 * jax_dist


# ---------------------------------------------------------------- Dh = 80

def test_flash_attention_dh80_matches_jax_plain_attention():
    """K3's wrapper at zamba2's head dim (80) on the CPU (its plain
    version) against JAX's plain attention, GQA 4/2, causal."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, 40, 4, 80)).astype(np.float32)
    k, v = (rng.standard_normal((B, 40, 2, 80)).astype(np.float32)
            for _ in range(2))
    mask = jattn.causal_mask(40, 40)
    want = np.asarray(jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  mask))
    assert 80 in fa_ops.HEAD_DIMS
    got = fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_zamba2_dh80_prefill_matches_jax():
    """A reduced zamba2 whose shared attention has zamba2's Dh = 80
    (``reduced()`` makes it 64): the port's kernel route (K3's and K4's
    CPU routes) against JAX's plain route."""
    kw = dict(head_dim=80, gla_chunk=16)
    jcfg, tcfg = _cfgs("zamba2-2.7b", **kw)
    assert tcfg.resolved_head_dim == 80
    jp = _j_init(jax.random.PRNGKey(9), jcfg)
    tp = _to_port(jp)
    toks = _tokens(jcfg.vocab, seed=9)
    want = np.asarray(_j_forward(jp, jcfg, toks))
    got, _ = tt.forward(tp, tcfg.replace(use_flash=True), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# -------------------------------------------------------------------- R4

def test_small_decays_give_nan_in_jax_and_finite_values_in_the_port():
    """ROADMAP caveat R4 at the block: a Mamba2 block whose decays are
    near 1e-6 (dt ≈ 20, exp(a_log)·dt ≈ 13.8). JAX's chunked_gla masks
    the upper triangle by ``× 0`` after ``exp`` overflowed to inf, so its
    block gives NaN; the port's chunked_gla selects, and its block is
    finite and equal to the sequential recurrence (the kernel route's
    plain version) within ``1e-4·max``."""
    jcfg, tcfg = _cfgs("zamba2-2.7b", gla_chunk=16)
    jdef, tdef = jblocks.BLOCKS["mamba2"], tblocks.get_block("mamba2")
    jp = jdef.init(jax.random.PRNGKey(6), jcfg)
    h = jp["mixer"]["a_log"].shape
    jp["mixer"]["dt_bias"] = jnp.full(h, 20.0, jnp.float32)
    jp["mixer"]["a_log"] = jnp.full(h, math.log(-math.log(1e-6) / 20.0), jnp.float32)
    tp = _to_port(jp)
    x = np.random.default_rng(2).standard_normal((B, 32, jcfg.d_model)).astype(np.float32)
    # The decays the block feeds the scan.
    _, _, a, *_ = tssm._mamba2_preact(tp["mixer"], torch.from_numpy(x),
                                      tcfg.ssm_state, tcfg.ssm_head_dim)
    assert 1e-7 < a.min() and a.max() < 1e-5
    ctx = {"positions": None, "window": 0, "use_flash": False}
    jy, _ = jdef.apply(jp, jnp.asarray(x), dict(ctx, memory=None), jcfg)
    assert np.isnan(np.asarray(jy)).any()
    plain, _ = tdef.apply(tp, torch.from_numpy(x), ctx, tcfg)
    seq, _ = tdef.apply(tp, torch.from_numpy(x), dict(ctx, use_flash=True), tcfg)
    assert torch.isfinite(plain).all() and torch.isfinite(seq).all()
    _close(plain.numpy(), seq.numpy())
