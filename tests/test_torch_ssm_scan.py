"""Port parity: the gated-linear-recurrence scan K4 and the GLA engine.

The same numpy inputs go through the JAX package and the port on the
CPU. JAX's ``gla_scan`` runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it; the port's ``gla_scan`` runs its plain
sequential version (``kernels/ssm_scan/ref.py``), which is what the CUDA
kernel is held against on the card. Tolerances: the scan
``rtol=atol=2e-4`` (``test_kernels.py``'s, the chunked kernel against the
sequential recurrence); the chunked engine ``chunked_gla`` / ``gla_step``
against JAX's ``rtol=atol=1e-5`` (both f32, the same chunked algorithm,
products summed in other orders).

Small decays (caveat R4 in ROADMAP.md): JAX's ``chunked_gla`` masks the
upper triangle of each chunk by multiplying, and ``exp(la_t − la_s)``
overflows there, so it gives NaN; the TPU kernel, the sequential version
and the port select instead and stay finite.

Last, the variants of the card-only measurement tool ``probe.py`` still
apply to the kernel source they patch.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.kernels.ssm_scan import gla_scan as j_gla_scan
from repro.kernels.ssm_scan import gla_scan_ref as j_gla_scan_ref
from repro.models.ssm import chunked_gla as j_chunked_gla
from repro.models.ssm import gla_step as j_gla_step
from repro_torch.kernels.ssm_scan import ops, probe, ref
from repro_torch.models.ssm import chunked_gla, gla_step

SCAN_TOL = 2e-4
GLA_TOL = 1e-5

SWEEP = [  # b, s, h, dk, dv, chunk: test_kernels.py's sweep, then ragged dv
    (1, 32, 2, 8, 8, 8), (2, 64, 3, 16, 32, 16), (1, 50, 1, 4, 4, 16),
    (2, 40, 2, 16, 17, 16),
]


def _inputs(b, s, h, dk, dv, seed=0, a_lo=0.6):
    rng = np.random.default_rng(seed)
    a = rng.uniform(a_lo, 1.0, (b, s, h)).astype(np.float32)
    k = (rng.normal(size=(b, s, h, dk)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    q = (rng.normal(size=(b, s, h, dk)) * 0.3).astype(np.float32)
    return a, k, v, q


def _both(x, dtypes):
    """The same values as JAX and torch arrays, each in its dtype (bf16
    rounds to nearest even on both sides)."""
    j = tuple(jnp.asarray(t).astype(getattr(jnp, d)) for t, d in zip(x, dtypes))
    t = tuple(torch.from_numpy(t).to(getattr(torch, d)) for t, d in zip(x, dtypes))
    return j, t


def _fold(x):
    """(B, S, H, ...) -> (B·H, S, ...), as both wrappers fold."""
    b, s, h = x.shape[:3]
    return x.swapaxes(1, 2).reshape((b * h, s) + x.shape[3:])


def _j_ref(j):
    b, s, h = j[0].shape
    dv = j[2].shape[-1]
    y = j_gla_scan_ref(*(_fold(t) for t in j))
    return np.asarray(y.reshape(b, h, s, dv).swapaxes(1, 2))


F32 = ("float32",) * 4
KQ_BF16 = ("float32", "bfloat16", "float32", "bfloat16")  # as Mamba2 feeds it


@pytest.mark.parametrize("dtypes", [F32, KQ_BF16], ids=["f32", "kq_bf16"])
@pytest.mark.parametrize("b,s,h,dk,dv,chunk", SWEEP)
def test_gla_scan_matches_jax(b, s, h, dk, dv, chunk, dtypes):
    """JAX at the sweep's chunk; the port at its default chunk (the
    result does not depend on it, and the kernel takes 16, 32 or 64)."""
    j, t = _both(_inputs(b, s, h, dk, dv), dtypes)
    want = np.asarray(j_gla_scan(*j, chunk=chunk))
    got = ops.gla_scan(*t)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, dv)
    np.testing.assert_allclose(got.numpy(), want, rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(got.numpy(), _j_ref(j), rtol=SCAN_TOL, atol=SCAN_TOL)


def test_ref_matches_jax_ref_in_folded_layout():
    x = _inputs(2, 48, 3, 16, 17, seed=1)
    j, t = _both(x, KQ_BF16)
    got = ref.gla_scan_ref(*(_fold(u) for u in t)).numpy()
    want = np.asarray(j_gla_scan_ref(*(_fold(u) for u in j)))
    np.testing.assert_allclose(got, want, rtol=GLA_TOL, atol=GLA_TOL)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_zero", "h0"])
@pytest.mark.parametrize("b,s,h,dk,dv,chunk,dtypes", [
    (2, 64, 3, 16, 32, 16, F32),
    (1, 50, 2, 8, 9, 16, F32),          # ragged S: padded with identity steps
    (2, 40, 2, 16, 16, 64, KQ_BF16),    # one chunk longer than S
])
def test_chunked_gla_matches_jax(b, s, h, dk, dv, chunk, dtypes, with_h0):
    j, t = _both(_inputs(b, s, h, dk, dv, seed=2), dtypes)
    h0 = (np.random.default_rng(3).normal(size=(b, h, dk, dv)).astype(np.float32)
          if with_h0 else None)
    jy, jh = j_chunked_gla(*j, h0=None if h0 is None else jnp.asarray(h0),
                           chunk=chunk)
    y, hf = chunked_gla(*t, h0=None if h0 is None else torch.from_numpy(h0),
                        chunk=chunk)
    assert y.shape == (b, s, h, dv) and hf.shape == (b, h, dk, dv)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=GLA_TOL, atol=GLA_TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jh), rtol=GLA_TOL, atol=GLA_TOL)


def test_gla_step_matches_jax():
    rng = np.random.default_rng(4)
    b, h, dk, dv = 2, 3, 16, 17
    hs = rng.normal(size=(b, h, dk, dv)).astype(np.float32)
    a = rng.uniform(0.6, 1.0, (b, h)).astype(np.float32)
    k, q = (rng.normal(size=(b, h, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(b, h, dv)).astype(np.float32)
    jy, jh = j_gla_step(*(jnp.asarray(x) for x in (hs, a, k, v, q)))
    y, hn = gla_step(*(torch.from_numpy(x) for x in (hs, a, k, v, q)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=GLA_TOL, atol=GLA_TOL)
    np.testing.assert_allclose(hn.numpy(), np.asarray(jh), rtol=GLA_TOL, atol=GLA_TOL)


def test_decode_continues_the_chunked_prefill():
    """chunked_gla over 80 positions, then gla_step over 16 more from its
    final state, equals chunked_gla over all 96."""
    _, t = _both(_inputs(2, 96, 3, 16, 17, seed=5), F32)
    y_all, h_all = chunked_gla(*t, chunk=16)
    _, hs = chunked_gla(*(x[:, :80] for x in t), chunk=16)
    ys = []
    for i in range(80, 96):
        y, hs = gla_step(hs, *(x[:, i] for x in t))
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), y_all[:, 80:],
                               rtol=GLA_TOL, atol=GLA_TOL)
    torch.testing.assert_close(hs, h_all, rtol=GLA_TOL, atol=GLA_TOL)


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_chunked_gla_chunk_invariance(chunk):
    """Every chunk length gives the single-chunk result and the
    sequential recurrence (the algorithm is exact)."""
    _, t = _both(_inputs(2, 96, 3, 16, 17, seed=6), F32)
    y, hf = chunked_gla(*t, chunk=chunk)
    y1, h1 = chunked_gla(*t, chunk=96)
    torch.testing.assert_close(y, y1, rtol=GLA_TOL, atol=GLA_TOL)
    torch.testing.assert_close(hf, h1, rtol=GLA_TOL, atol=GLA_TOL)
    torch.testing.assert_close(y, ops.gla_scan(*t), rtol=GLA_TOL, atol=GLA_TOL)


def test_small_decays_nan_in_jax_chunked_gla_finite_in_port():
    """Caveat R4: a = 1e-6, B = 1, S = 64, H = 1, dk = dv = 8, chunk 64.
    JAX's chunked_gla is NaN (inf · 0 in its multiplied mask); its TPU
    kernel (interpret mode) and the port's chunked_gla and gla_scan stay
    finite and agree with the sequential recurrence."""
    a, k, v, q = _inputs(1, 64, 1, 8, 8, seed=7)
    a = np.full_like(a, 1e-6)
    j, t = _both((a, k, v, q), F32)
    jy, _ = j_chunked_gla(*j, chunk=64)
    assert np.isnan(np.asarray(jy)).any()
    want = _j_ref(j)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(np.asarray(j_gla_scan(*j, chunk=64)), want,
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    y, hf = chunked_gla(*t, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    np.testing.assert_allclose(y.numpy(), want, rtol=GLA_TOL, atol=GLA_TOL)
    np.testing.assert_allclose(ops.gla_scan(*t, chunk=64).numpy(), want,
                               rtol=GLA_TOL, atol=GLA_TOL)


def _mamba2_like(rng, b, s, h, d_state, head_dim):
    """Narrow Mamba2 operands: decay exp(−exp(a_log)·dt), dt = softplus,
    v = x·dt in f32, k and q in bf16, as ``_mamba2_preact`` makes them."""
    dt = np.log1p(np.exp(rng.normal(-2.0, 1.0, (b, s, h)))).astype(np.float32)
    a = np.exp(-dt).astype(np.float32)
    k = rng.normal(size=(b, s, h, d_state)).astype(np.float32) * d_state ** -0.5
    q = rng.normal(size=(b, s, h, d_state)).astype(np.float32) * d_state ** -0.5
    v = (rng.normal(size=(b, s, h, head_dim)) * dt[..., None]).astype(np.float32)
    return (a, k, v, q), KQ_BF16


def _mlstm_like(rng, b, s, h, dh):
    """Narrow mLSTM operands: sigmoid forget gate, k scaled by the input
    gate, v with the normaliser column of ones (dv = dh + 1), all f32."""
    a = (1 / (1 + np.exp(-(rng.normal(size=(b, s, h)) + 3.0)))).astype(np.float32)
    i_g = 1 / (1 + np.exp(-rng.normal(size=(b, s, h, 1))))
    k = (rng.normal(size=(b, s, h, dh)) * dh ** -0.5 * i_g).astype(np.float32)
    q = (rng.normal(size=(b, s, h, dh)) * dh ** -0.5).astype(np.float32)
    v = np.concatenate([rng.normal(size=(b, s, h, dh)),
                        np.ones((b, s, h, 1))], -1).astype(np.float32)
    return (a, k, v, q), F32


@pytest.mark.parametrize("layer", ["mamba2", "mlstm"])
def test_slice_matches_jax(layer):
    """The slice as a whole at narrow widths of the two layers it serves:
    the port's gla_scan and chunked_gla against JAX's gla_scan (interpret)
    and chunked_gla, at chunk 64 over a ragged S."""
    rng = np.random.default_rng(8)
    x, dtypes = (_mamba2_like(rng, 2, 100, 4, 16, 16) if layer == "mamba2"
                 else _mlstm_like(rng, 2, 100, 2, 32))
    j, t = _both(x, dtypes)
    want = np.asarray(j_gla_scan(*j, chunk=64))
    jy, jh = j_chunked_gla(*j, chunk=64)
    np.testing.assert_allclose(ops.gla_scan(*t, chunk=64).numpy(), want,
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    y, hf = chunked_gla(*t, chunk=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=GLA_TOL, atol=GLA_TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jh), rtol=GLA_TOL, atol=GLA_TOL)
    np.testing.assert_allclose(y.numpy(), want, rtol=SCAN_TOL, atol=SCAN_TOL)


def test_cpu_wrapper_is_ref_in_model_layout():
    """On CPU tensors the wrapper runs the plain version, launches
    nothing and returns a contiguous f32 (B, S, H, dv)."""
    _, t = _both(_inputs(2, 30, 3, 8, 5, seed=9), KQ_BF16)
    before = dict(ops.launch_counts)
    y = ops.gla_scan(*t, chunk=16)
    assert ops.launch_counts == before
    assert y.dtype == torch.float32 and y.shape == (2, 30, 3, 5) and y.is_contiguous()
    want = ref.gla_scan_ref(*(_fold(x) for x in t)).reshape(2, 3, 30, 5).transpose(1, 2)
    assert torch.equal(y, want)


def test_cpu_wrapper_rejects_what_the_kernel_does_not_take():
    a, k, v = torch.ones(1, 8, 2), torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 4)
    with pytest.raises(TypeError, match="a must be"):
        ops.gla_scan(a.double(), k, v, k)
    with pytest.raises(TypeError, match="k must be"):
        ops.gla_scan(a, k.half(), v, k)
    with pytest.raises(ValueError, match="3-D"):
        ops.gla_scan(a[0], k, v, k)
    with pytest.raises(ValueError, match="4-D"):
        ops.gla_scan(a, k[0], v, k)
    with pytest.raises(ValueError, match=r"\(B, S, H, dk\)"):
        ops.gla_scan(a, k, v, torch.zeros(1, 8, 2, 15))
    with pytest.raises(ValueError, match=r"\(B, S, H, dv\)"):
        ops.gla_scan(a, k, torch.zeros(1, 9, 2, 4), k)
    for chunk in (8, 12, 128, 64.0, 0):
        with pytest.raises(ValueError, match="chunk"):
            ops.gla_scan(a, k, v, k, chunk=chunk)
    big = torch.zeros(1, 8, 2, ops.MAX_DK + 1)
    with pytest.raises(ValueError, match="dk"):
        ops.gla_scan(a, big, v, big)
    with pytest.raises(ValueError, match="last axis"):
        ops.gla_scan(a, torch.zeros(1, 8, 2, 32)[..., ::2], v, k)
    with pytest.raises(ValueError, match="several devices"):
        ops.gla_scan(a.to("meta"), k, v, k)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.gla_scan(*(x.to("meta") for x in (a, k, v, k)))


@pytest.mark.parametrize("name", sorted(probe.PATCHES))
def test_k4_probe_variants_apply_to_the_kernel_source(name):
    """Every variant of the K4 probe finds each of its anchors once in
    ``csrc/gla_scan.cu`` (``variant_source`` raises otherwise), so the
    probe still builds after an edit of the kernel. Every variant, the
    base too, drops the chunks other than 64."""
    src = probe.variant_source(name)
    assert src != ops.SOURCE.read_text()
    assert (src == probe.variant_source("base")) == (name == "base")
    assert re.search(r"@\d", src) is None
