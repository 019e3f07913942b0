"""Port parity: the flash-attention kernel K3's plain version and wrapper.

The port's plain version (``kernels/flash_attention/ref.py``) is what
its wrapper runs on the CPU and what the CUDA kernel is held against on
the card. Here it is held against the JAX package's Pallas kernel
``flash_attention_kernel`` run in interpret mode, exactly as
``tests/test_kernels.py`` runs it, over that file's sweep plus a case
with rows that see no key: same numpy inputs, f32, ``rtol=atol=1e-5``
(both compute in f32, the products summed in other orders). On rows
with no visible key both give exact zeros; the JAX package's own
``ref.py`` gives the mean of v there, which the port does not follow.
Last, the variants of the card-only measurement tool ``probe.py`` still
apply to the kernel source they patch.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.kernels.flash_attention.flash_attention import flash_attention_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro_torch.kernels.flash_attention import ops, probe, ref

SWEEP = [  # b, h, hkv, s, t, dh, causal, window, bq, bk
    (1, 2, 1, 64, 64, 16, True, 0, 16, 16),
    (2, 4, 2, 128, 128, 32, True, 0, 32, 32),
    (1, 2, 2, 128, 128, 16, True, 32, 32, 32),
    (1, 8, 1, 64, 64, 64, True, 0, 16, 16),       # extreme GQA
    (1, 2, 1, 64, 64, 16, False, 0, 16, 16),      # bidirectional
    (1, 1, 1, 256, 256, 16, True, 64, 64, 64),    # long + window
    (2, 4, 2, 64, 16, 32, False, 8, 16, 16),      # rows 23.. see no key
]


def _inputs(b, h, hkv, s, t, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, t, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, t, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,h,hkv,s,t,dh,causal,window,bq,bk", SWEEP)
def test_ref_matches_jax_kernel_interpret(b, h, hkv, s, t, dh, causal, window,
                                          bq, bk):
    q, k, v = _inputs(b, h, hkv, s, t, dh)
    want = np.asarray(flash_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=bq, block_k=bk, interpret=True))
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rows_with_no_key_are_exact_zeros():
    """Rows that see no key: exact zeros in the port and in the JAX
    kernel; the JAX ``ref.py`` gives the mean of v there instead."""
    b, h, hkv, s, t, dh, window = 2, 4, 2, 64, 16, 32, 8
    q, k, v = _inputs(b, h, hkv, s, t, dh, seed=1)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False,
                                  window=window).numpy()
    dead = np.arange(s) >= t + window - 1
    assert dead.sum() == s - (t + window - 1)
    assert np.all(got[:, :, dead] == 0.0)
    assert np.all(np.abs(got[:, :, ~dead]).sum(-1) > 0)
    jk = np.asarray(flash_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        window=window, block_q=16, block_k=16, interpret=True))
    assert np.all(jk[:, :, dead] == 0.0)
    jr = np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, window=window))
    mean_v = np.repeat(v.mean(axis=2, keepdims=True), h // hkv, axis=1)
    np.testing.assert_allclose(jr[:, :, dead],
                               np.broadcast_to(mean_v, jr[:, :, dead].shape),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_cpu_wrapper_is_ref_in_model_layout(dtype, causal, window):
    """On CPU tensors the wrapper takes the model layout (B, S, H, Dh),
    runs the plain version, launches nothing and returns q's dtype."""
    q, k, v = _inputs(2, 4, 2, 40, 40, 64, seed=2)
    qm, km, vm = (torch.from_numpy(x).transpose(1, 2).contiguous().to(dtype)
                  for x in (q, k, v))
    before = dict(ops.launch_counts)
    out = ops.flash_attention(qm, km, vm, causal=causal, window=window)
    assert ops.launch_counts == before
    assert out.dtype == dtype and out.shape == qm.shape
    want = ref.flash_attention_ref(qm.transpose(1, 2), km.transpose(1, 2),
                                   vm.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)
    assert torch.equal(out, want)


def test_cpu_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 64)
    kv = torch.zeros(1, 8, 2, 64)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 2, 32),
                            torch.zeros(1, 8, 2, 32))
    with pytest.raises(ValueError, match="4-D"):
        ops.flash_attention(q[0], kv, kv)
    with pytest.raises(ValueError, match=r"\(B, T, Hkv, Dh\)"):
        ops.flash_attention(q, kv, torch.zeros(1, 9, 2, 64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            kv, kv)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, kv, kv, window=-1)


@pytest.mark.parametrize("name", sorted(probe.PATCHES))
def test_k3_probe_variants_apply_to_the_kernel_source(name):
    """Every variant of the K3 probe finds each of its anchors once in
    ``csrc/flash_attention.cu`` (``variant_source`` raises otherwise),
    so the probe still builds after an edit of the kernel."""
    src = probe.variant_source(name)
    assert (src == ops.SOURCE.read_text()) == (name == "base")
    assert re.search(r"@\d", src) is None
