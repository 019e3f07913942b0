"""Port parity: the aggregate kernels K1/K2 and the flat aggregation layer.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode on the CPU, and its pure-jnp references) and through
``repro_torch`` (whose wrappers take the plain PyTorch versions for CPU
tensors). Tolerances: f32 rtol=atol=1e-6 (XLA and torch sum the client
axis in different orders); bf16 gradients with an f32 result 1e-5, as
in ``tests/test_fused_update.py``. The weights are drawn at the scale
the trainer gives them, ω_i = p_i·mask_i·scale_i with Σ ω ≈ 1 (the
unbiased schedulers' expectation): the rounding error of a reordered
f32 sum grows with Σ_i |ω_i g_i|, and these tolerances are stated for
that scale. Inside the port the guarantees are
bitwise: masked inf/NaN rows give exact zeros, and the fused update
equals reduce → −η·agg → add.

The CUDA kernels themselves run only on the card:
``test_torch_cuda.py`` holds them against the plain versions there.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.core import aggregation as jagg
from repro.kernels.aggregate import ops as jops
from repro.kernels.aggregate import ref as jref
from repro.optim import sgd as jsgd
from repro_torch.core import aggregation as tagg
from repro_torch.kernels.aggregate import ops as tops
from repro_torch.kernels.aggregate import probe as tprobe
from repro_torch.optim import apply_updates, momentum, sgd

SHAPES = [(1, 1), (8, 300), (40, 1000), (40, 2049)]


def _inputs(n, p, seed, g_dtype=np.float32, poison=False):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, p)).astype(np.float32)
    w = (rng.uniform(size=(n,)) * 2 / n).astype(np.float32)
    mask = (rng.uniform(size=(n,)) > 0.3).astype(np.float32)
    params = rng.normal(size=(p,)).astype(np.float32)
    if poison:
        g[mask == 0] = np.inf
        g[np.flatnonzero(mask == 0)[::2]] = np.nan
    jg = jnp.asarray(g, g_dtype)
    tg = torch.from_numpy(g).to(torch.bfloat16 if g_dtype == jnp.bfloat16
                                else torch.float32)
    return g, w, mask, params, jg, tg


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("n,p", SHAPES)
@pytest.mark.parametrize("with_mask", [False, True], ids=["dense", "masked"])
def test_k1_plain_matches_jax(n, p, with_mask):
    g, w, mask, _, jg, tg = _inputs(n, p, n * 7 + p)
    m = mask if with_mask else None
    jout = jops.masked_scaled_aggregate(jg, jnp.asarray(w),
                                        mask=None if m is None else jnp.asarray(m))
    jr = jref.masked_scaled_aggregate_ref(jg, jnp.asarray(w),
                                          None if m is None else jnp.asarray(m))
    tout = tops.masked_scaled_aggregate(tg, _t(w),
                                        mask=None if m is None else _t(m))
    assert tout.dtype == torch.float32 and tout.shape == (p,)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,p", SHAPES)
@pytest.mark.parametrize("with_params", [False, True], ids=["delta", "update"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["dense", "masked"])
def test_k2_plain_matches_jax(n, p, with_params, with_mask):
    g, w, mask, params, jg, tg = _inputs(n, p, n * 11 + p)
    m = mask if with_mask else None
    prm = params if with_params else None
    jout = jops.masked_scaled_aggregate_update(
        jg, jnp.asarray(w), 0.07, None if prm is None else jnp.asarray(prm),
        None if m is None else jnp.asarray(m))
    tout = tops.masked_scaled_aggregate_update(
        tg, _t(w), 0.07, None if prm is None else _t(prm),
        None if m is None else _t(m))
    assert tout.dtype == torch.float32 and tout.shape == (p,)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("p", [1000, 2049])
@pytest.mark.parametrize("form", ["k1", "update", "delta"])
def test_bf16_gradients_f32_result(p, form):
    n = 40
    g, w, mask, params, jg, tg = _inputs(n, p, p, g_dtype=jnp.bfloat16)
    jw, tw = jnp.asarray(w), _t(w)
    if form == "k1":
        jout = jops.masked_scaled_aggregate(jg, jw, out_dtype=jnp.float32)
        tout = tops.masked_scaled_aggregate(tg, tw, out_dtype=torch.float32)
    else:
        jp = jnp.asarray(params) if form == "update" else None
        tp = _t(params) if form == "update" else None
        jout = jops.masked_scaled_aggregate_update(jg, jw, 0.01, jp)
        tout = tops.masked_scaled_aggregate_update(tg, tw, 0.01, tp)
    assert tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)


def test_bf16_params_update_cast_back():
    n, p = 8, 300
    g, w, _, params, jg, tg = _inputs(n, p, 5)
    jp = jnp.asarray(params, jnp.bfloat16)
    tp = torch.from_numpy(params).to(torch.bfloat16)
    jout = jops.masked_scaled_aggregate_update(jg, jnp.asarray(w), 0.05, jp)
    tout = tops.masked_scaled_aggregate_update(tg, _t(w), 0.05, tp)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_array_equal(tout.float().numpy(),
                                  np.asarray(jout, np.float32))


@pytest.mark.parametrize("form", ["k1", "update", "delta"])
def test_masked_nonfinite_rows_are_exact_zeros(form):
    n, p = 16, 260
    g, w, mask, params, _, tg = _inputs(n, p, 3, poison=True)
    clean = torch.from_numpy(np.where(mask[:, None] > 0, g, 0.0))
    tw, tm = _t(w), _t(mask)
    if form == "k1":
        out = tops.masked_scaled_aggregate(tg, tw, mask=tm)
        ref = tops.masked_scaled_aggregate(clean, tw, mask=tm)
    else:
        tp = _t(params) if form == "update" else None
        out = tops.masked_scaled_aggregate_update(tg, tw, 0.05, tp, tm)
        ref = tops.masked_scaled_aggregate_update(clean, tw, 0.05, tp, tm)
    assert torch.isfinite(out).all()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("with_mask", [False, True], ids=["dense", "masked"])
def test_fused_equals_unfused_bitwise(with_mask):
    """DESIGN.md §9 inside the port: the fused step equals reduce →
    sgd's −η·agg → params + update, bit for bit."""
    n, p = 40, 2049
    g, w, mask, params, _, tg = _inputs(n, p, 9)
    tw, tp = _t(w), _t(params)
    m = _t(mask) if with_mask else None
    opt = sgd(0.05)
    st = opt.init(tp)
    fused, fst, wsum = tagg.fused_flat_sgd_update(tg, tw, tp, st, opt, mask=m,
                                                  use_kernel=True)
    agg = tagg.reduce_flat(tg, tw, use_kernel=True, mask=m)
    updates, ust = opt.update(agg, st, tp)
    assert torch.equal(fused, apply_updates(tp, updates))
    assert int(fst.step) == int(ust.step) == 1
    assert torch.equal(wsum, torch.sum(tw))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["matvec", "kernel"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["dense", "masked"])
def test_reduce_and_fused_update_match_jax(use_kernel, with_mask):
    n, p = 40, 1000
    g, w, mask, params, jg, tg = _inputs(n, p, 21)
    jm = jnp.asarray(mask) if with_mask else None
    tm = _t(mask) if with_mask else None
    jr = jagg.reduce_flat(jg, jnp.asarray(w), use_kernel=use_kernel, mask=jm)
    tr = tagg.reduce_flat(tg, _t(w), use_kernel=use_kernel, mask=tm)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
    jopt = jsgd(0.05)
    topt = sgd(0.05)
    jp, jst, jws = jagg.fused_flat_sgd_update(
        jg, jnp.asarray(w), jnp.asarray(params), jopt.init(jnp.asarray(params)),
        jopt, mask=jm, use_kernel=use_kernel)
    tp, tst, tws = tagg.fused_flat_sgd_update(
        tg, _t(w), _t(params), topt.init(_t(params)), topt, mask=tm,
        use_kernel=use_kernel)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    assert int(tst.step) == int(jst.step)
    np.testing.assert_allclose(float(tws), float(jws), rtol=1e-6)


def test_fused_update_refuses_untagged_optimizer():
    g, w, p = torch.ones(2, 4), torch.ones(2), torch.zeros(4)
    opt = momentum(0.1)
    with pytest.raises(ValueError, match="sgd"):
        tagg.fused_flat_sgd_update(g, w, p, opt.init(p), opt)


def test_ravel_layout_matches_jax():
    """Leaves in jax.tree_util order (sorted keys), each row-major: the
    flat vectors of the two packages agree element for element."""
    rng = np.random.default_rng(0)
    tree = {"z": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "b": rng.normal(size=(4,)).astype(np.float32)},
            "a": rng.normal(size=(2, 2, 2)).astype(np.float32)}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = {"z": {"w": _t(tree["z"]["w"]), "b": _t(tree["z"]["b"])},
             "a": _t(tree["a"])}
    jspec = jagg.ravel_spec(jtree)
    tspec = tagg.ravel_spec(ttree)
    assert tspec.shapes == jspec.shapes and tspec.offsets == jspec.offsets
    jflat = jagg.ravel_pytree(jtree, jspec)
    tflat = tagg.ravel_pytree(ttree, tspec)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = tagg.unravel_pytree(tflat, tspec)
    assert torch.equal(back["z"]["w"], ttree["z"]["w"])
    stacked = {"z": {"w": torch.stack([ttree["z"]["w"]] * 3),
                     "b": torch.stack([ttree["z"]["b"]] * 3)},
               "a": torch.stack([ttree["a"]] * 3)}
    flat_grads = tagg.make_flat_grads_fn(lambda prm, k, t: stacked, tspec, 3)
    g = flat_grads(None, None, None)
    assert g.shape == (3, tspec.total)
    assert torch.equal(g[1], tflat)
    with pytest.raises(ValueError, match="mirror"):
        tagg.make_flat_grads_fn(lambda prm, k, t: {"a": stacked["a"]},
                                tspec, 3)(None, None, None)
    with pytest.raises(ValueError, match="single leaf dtype"):
        tagg.ravel_spec({"a": torch.zeros(2), "b": torch.zeros(2, dtype=torch.float64)})


@pytest.mark.parametrize("with_mask", [False, True], ids=["dense", "masked"])
def test_per_leaf_oracle_matches_jax_and_flat_path(with_mask):
    rng = np.random.default_rng(2)
    n = 6
    tree = {"w": rng.normal(size=(n, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(n, 4)).astype(np.float32)}
    w = rng.uniform(size=(n,)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32) if with_mask else None
    jout = jagg.aggregate_client_grads(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(w),
        None if mask is None else jnp.asarray(mask))
    ttree = {k: _t(v) for k, v in tree.items()}
    tm = None if mask is None else _t(mask)
    tout = tagg.aggregate_client_grads(ttree, _t(w), tm)
    for k in tree:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-6, atol=1e-6)
    spec = tagg.ravel_spec(ttree, lead_axes=1)
    flat = tagg.reduce_flat(tagg.ravel_stacked(ttree, spec), _t(w), mask=tm)
    back = tagg.unravel_pytree(flat, spec)
    for k in tree:
        np.testing.assert_allclose(back[k].numpy(), tout[k].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_compose_masks_and_client_weights():
    a = torch.tensor([1.0, 0.0, 1.0])
    b = torch.tensor([1.0, 1.0, 0.0])
    assert tagg.compose_masks(None, None) is None
    assert torch.equal(tagg.compose_masks(a, None), a)
    assert torch.equal(tagg.compose_masks(a, b), torch.tensor([1.0, 0.0, 0.0]))
    from repro_torch.core.scheduling import Decision

    p = torch.tensor([0.5, 0.25, 0.25])
    dec = Decision(mask=a, scale=torch.tensor([2.0, 3.0, 4.0]))
    assert torch.equal(tagg.client_weights(p, dec), torch.tensor([1.0, 0.0, 1.0]))


def test_wrapper_checks():
    g, w = torch.zeros(3, 5), torch.zeros(3)
    with pytest.raises(ValueError, match="several devices"):
        tops.masked_scaled_aggregate(g, w.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.masked_scaled_aggregate(g.to("meta"), w.to("meta"))
    before = dict(tops.launch_counts)
    tops.masked_scaled_aggregate(g, w)
    assert tops.launch_counts == before, "CPU calls launch no kernel"


@pytest.mark.parametrize("p", [1, 3, 5, 17, 2049, 316_554, 10_000_019])
@pytest.mark.parametrize("esize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("blocks", [132, 7])
def test_geometry_spans_cover_p_once_on_16_byte_units(p, esize, blocks):
    """The card kernel's cut of P (``ops.geometry``): the blocks' spans
    cover [0, P) once, in order, each starting on a 16-byte unit and
    ending on one or at P; every block launched owns columns, at most
    ``blocks`` of them, and fewer only where the span is at least
    ``MIN_UNITS`` 16-byte units; a chunk, a stage and the ring fit what
    the kernel takes."""
    geo = tops.geometry(p, esize, blocks)
    spans = geo.spans(p)
    assert spans[0][0] == 0 and spans[-1][1] == p
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(start < end for start, end in spans)
    for start, end in spans:
        assert start * esize % 16 == 0
        assert end == p or end * esize % 16 == 0
    assert len(spans) == geo.blocks <= blocks
    assert geo.blocks == blocks or geo.span * esize // 16 >= tops.MIN_UNITS or geo.blocks == 1
    assert geo.span * esize % 16 == 0 and geo.chunk * esize % 16 == 0
    assert geo.chunk <= min(geo.span, tops.CONSUMERS * tops.COLS_PER_THREAD)
    assert geo.pitch % 16 == 0 and geo.pitch >= geo.chunk * esize + 16
    assert geo.rows in (1, 2, 4, 8) and 2 <= geo.stages <= tops.MAX_STAGES
    assert geo.smem <= tops.MAX_SMEM


def test_geometry_at_the_fig1_shape():
    """One block a SM on a 132-SM card: 2,400 columns (9.6 KB of an f32
    row) a block in one chunk, eight rows a stage, two stages, ~150 KB a
    block in flight; the last block owns the ragged rest."""
    geo = tops.geometry(316_554, 4, 132)
    assert (geo.span, geo.chunk, geo.rows, geo.stages) == (2400, 2400, 8, 2)
    assert geo.spans(316_554)[-1] == (131 * 2400, 316_554)
    assert geo.stages * geo.rows * geo.pitch == 153_856


@pytest.mark.parametrize("p,esize,blocks", [(2049, 4, 31), (2049, 2, 16), (4096, 4, 64),
                                            (1, 4, 1), (8_448, 4, 132), (20_000, 4, 132)])
def test_geometry_small_p_runs_few_blocks(p, esize, blocks):
    """A small P runs fewer blocks than SMs, each owning at least
    ``MIN_UNITS`` 16-byte units of a row (256 B at 16), rather than 132
    blocks of a few columns; from 132 × ``MIN_UNITS`` units on, one
    block a SM. With ``min_units=1`` the span is the fewest units that
    132 blocks cover P with."""
    geo = tops.geometry(p, esize, 132)
    assert geo.blocks == blocks
    units = -(-p * esize // 16)
    assert geo.blocks == 1 or geo.span * esize // 16 >= tops.MIN_UNITS
    assert tops.geometry(p, esize, 132, min_units=1).span * esize // 16 == -(-units // 132)


@pytest.mark.parametrize("p", [1, 3, 5, 17, 2049, 316_554])
@pytest.mark.parametrize("esize,offset", [(4, 0), (4, 4), (4, 12), (2, 0),
                                          (2, 2), (2, 14)])
def test_geometry_row_shifts(p, esize, offset):
    """Row n of a span starting at column s begins (n·P + s)·esize bytes
    past g, ``shift(n)`` elements into its 16-byte unit, whatever the
    span and for g at any offset (a view at an odd storage offset)."""
    n_rows = 45
    geo = tops.geometry(p, esize, 5, offset=1024 + offset)
    for start, _ in geo.spans(p):
        for n in range(n_rows):
            byte = offset + (n * p + start) * esize
            assert geo.shift(n) * esize == byte % 16


@pytest.mark.parametrize("name", sorted(tprobe.PATCHES))
def test_k12_probe_variants_apply_to_the_kernel_source(name):
    """Every variant of the K1/K2 probe finds each of its anchors once in
    ``csrc/aggregate.cu`` (``variant_source`` raises otherwise), so the
    probe still builds after an edit of the kernel; a variant that only
    changes the geometry builds the kernel as it is."""
    src = tprobe.variant_source(name)
    assert (src == tops.SOURCE.read_text()) == (not tprobe.PATCHES[name])
    assert name == "base" or tprobe.PATCHES[name] or name in tprobe.GEOMETRY


def test_k12_probe_imports_another_checkout():
    """``probe trees`` reaches another checkout's kernels through its
    public wrappers: ``other_tree`` imports that checkout's ``ops`` as a
    module of its own and leaves this checkout's in place. Here the
    other checkout is this one; on the CPU both wrappers take the plain
    version, so they agree bitwise."""
    root = tops.SOURCE.parents[5]
    other = tprobe.other_tree(str(root))
    assert other is not tops and other.SOURCE == tops.SOURCE
    assert sys.modules["repro_torch.kernels.aggregate.ops"] is tops
    g, w = torch.randn(5, 7), torch.rand(5)
    assert torch.equal(other.masked_scaled_aggregate(g, w),
                       tops.masked_scaled_aggregate(g, w))
