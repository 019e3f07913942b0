"""The port on the CUDA card: kernels K1/K2 and the slice, torch only.

Every test here needs a card (the CUDA kernels have no CPU mode), is
marked ``cuda``, and skips inside the test when there is none. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: f32 kernels against their plain
versions rtol=atol=1e-6 (weights at the trainer's scale, Σω≈1); bf16
gradients into f32 1e-5; bitwise inside the port for masked rows and
for fused against unfused. The slice on the card is held against the
same slice on the CPU to the CNN tolerance of ``test_torch_trainer.py``
(``rtol=1e-4, atol=1e-5``), with TF32 off and cuDNN deterministic.
"""

import numpy as np
import pytest
import torch

from repro_torch import random as trandom
from repro_torch.core import (ClientSimulator, DeterministicArrivals,
                              make_scheduler, ravel_pytree)
from repro_torch.data import ClientBatcher
from repro_torch.kernels.aggregate import ops, ref
from repro_torch.models.cnn import client_grads_fn, init_cnn
from repro_torch.optim import sgd

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def _operands(n, p, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(n, p, device="cuda", generator=gen)
    w = torch.rand(n, device="cuda", generator=gen) * (2.0 / n)
    mask = (torch.arange(n, device="cuda") % 3 != 1).float()
    params = torch.randn(p, device="cuda", generator=gen)
    return g, w, mask, params


@pytest.mark.parametrize("n,p", [(40, 316_554), (40, 2_049), (3, 1)])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_kernels_match_plain_versions(card, n, p, masked):
    g, w, mask, params = _operands(n, p, n + p)
    m = mask if masked else None
    eta = torch.tensor(0.05, device=card)
    before = dict(ops.launch_counts)
    k1 = ops.masked_scaled_aggregate(g, w, mask=m)
    torch.testing.assert_close(k1, ref.masked_scaled_aggregate_ref(g, w, m),
                               rtol=1e-6, atol=1e-6)
    k2 = ops.masked_scaled_aggregate_update(g, w, eta, params, m)
    torch.testing.assert_close(
        k2, ref.masked_scaled_aggregate_update_ref(g, w, eta, params, m),
        rtol=1e-6, atol=1e-6)
    delta = ops.masked_scaled_aggregate_update(g, w, eta, None, m)
    torch.testing.assert_close(
        delta, ref.masked_scaled_aggregate_update_ref(g, w, eta, None, m),
        rtol=1e-6, atol=1e-6)
    assert torch.equal(k2, params + (-eta * k1))
    assert ops.launch_counts["masked_scaled_aggregate"] == \
        before["masked_scaled_aggregate"] + 1
    assert ops.launch_counts["masked_scaled_aggregate_update"] == \
        before["masked_scaled_aggregate_update"] + 2


def test_masked_nonfinite_rows_exact_zeros(card):
    g, w, mask, params = _operands(40, 2_049, 1)
    poisoned = g.clone()
    poisoned[mask == 0] = float("inf")
    poisoned[1] = float("nan")
    clean = torch.where(mask[:, None] > 0, g, 0.0)
    for fn in (lambda x: ops.masked_scaled_aggregate(x, w, mask=mask),
               lambda x: ops.masked_scaled_aggregate_update(x, w, 0.05, params, mask),
               lambda x: ops.masked_scaled_aggregate_update(x, w, 0.05, None, mask)):
        out = fn(poisoned)
        assert torch.isfinite(out).all()
        assert torch.equal(out, fn(clean))


def test_bf16_forms(card):
    g, w, _, params = _operands(40, 2_049, 2)
    gb = g.to(torch.bfloat16)
    torch.testing.assert_close(
        ops.masked_scaled_aggregate(gb, w, out_dtype=torch.float32),
        ref.masked_scaled_aggregate_ref(gb, w, None, torch.float32),
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        ops.masked_scaled_aggregate_update(gb, w, 0.05, params),
        ref.masked_scaled_aggregate_update_ref(gb, w, 0.05, params),
        rtol=1e-5, atol=1e-5)
    out = ops.masked_scaled_aggregate_update(g, w, 0.05, params.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out.float(),
        ref.masked_scaled_aggregate_update_ref(
            g, w, 0.05, params.to(torch.bfloat16)).float(),
        rtol=2 ** -8, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    g, w, mask, params = _operands(8, 300, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.masked_scaled_aggregate(g.t().contiguous().t(), w)
    with pytest.raises(TypeError, match="dtype"):
        ops.masked_scaled_aggregate(g.double(), w)
    with pytest.raises(TypeError, match="dtype"):
        ops.masked_scaled_aggregate(g, w.double())
    with pytest.raises(ValueError, match="shape"):
        ops.masked_scaled_aggregate(g, w, mask=mask[:4])
    with pytest.raises(ValueError, match="shape"):
        ops.masked_scaled_aggregate_update(g, w, 0.1, params[:5])
    with pytest.raises(ValueError, match="several devices"):
        ops.masked_scaled_aggregate(g, w.cpu())


def test_slice_on_card_matches_cpu(card):
    """The small Fig-1 loop (alg1, sgd, fused kernel K2) on the card and
    on the CPU from one seed: same participation, parameters to the CNN
    tolerance, one K2 launch per step."""
    n, steps = 8, 5
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n * 6, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, n * 6).astype(np.int32)
    per = [{"x": x[i * 6:(i + 1) * 6], "y": y[i * 6:(i + 1) * 6]}
           for i in range(n)]
    out = {}
    for dev in ("cpu", "cuda"):
        batcher = ClientBatcher(per, 2, seed=0, device=dev)
        sim = ClientSimulator(
            grads_fn=client_grads_fn(batcher), p=batcher.p, optimizer=sgd(0.05),
            scheduler=make_scheduler("alg1", n),
            energy=DeterministicArrivals.periodic([1, 2, 4, 8] * 2, steps),
            use_kernel=True, device=dev)
        params = init_cnn(trandom.PRNGKey(1, device=dev), image_hw=8)
        before = ops.launch_counts["masked_scaled_aggregate_update"]
        final, hist = sim.run(trandom.PRNGKey(7, device=dev), params, steps)
        launched = ops.launch_counts["masked_scaled_aggregate_update"] - before
        out[dev] = (final, hist, launched)
    cpu_params, cpu_hist, cpu_launched = out["cpu"]
    cuda_params, cuda_hist, cuda_launched = out["cuda"]
    assert cpu_launched == 0 and cuda_launched == steps
    assert torch.equal(cuda_hist.participation.cpu(), cpu_hist.participation)
    torch.testing.assert_close(ravel_pytree(cuda_params).cpu(),
                               ravel_pytree(cpu_params), rtol=1e-4, atol=1e-5)
