"""The port on the CUDA card: kernels K1–K4 and the slices, torch only.

Every test here needs a card (the CUDA kernels have no CPU mode), is
marked ``cuda``, and skips inside the test when there is none. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: f32 kernels against their plain
versions rtol=atol=1e-6 (weights at the trainer's scale, Σω≈1); bf16
gradients into f32 1e-5; bitwise inside the port for masked rows and
for fused against unfused; K1 once a leaf at the Fig-1 CNN's 8 leaves
(the legacy carry's route) bitwise K1 on the raveled buffer. The slice
on the card is held against the same slice on the CPU to the CNN
tolerance of ``test_torch_trainer.py``
(``rtol=1e-4, atol=1e-5``), with TF32 off and cuDNN deterministic.

K3 (flash attention) against its plain version computed in f32 from the
same inputs: bf16 ``max|K3 − plain| ≤ 2**-7·max|plain|`` (p rounded to
bf16 for the tensor-core product, and the output rounded), f32
``rtol=atol=1e-5``; rows with no visible key exact zeros. The reduced
stablelm serving slice on the card (f32, through K3) against the same
slice on the CPU (through the plain version) to ``rtol=atol=1e-4``, the
tolerance ``test_torch_lm.py`` holds the port to against JAX.

The experiments engine on the card: the quadratic ``fig1`` study runs
each cell and seed through K2, one launch a step, and each cell's seed
equals a standalone ``ClientSimulator.run`` bit for bit. Faults on the
card: every row NaN-poisoned and dropped leaves the params unmoved and
finite through the masked K2 and K1; a rate-0 fault equals the clean
cell bit for bit; a checkpointed study, resumed from a middle
checkpoint, equals the uninterrupted one bit for bit. The Study service
on the card: a mixed-population batch counts one compile and one K2
launch a step of every cell and seed, and each response (plain and
checkpointed) equals its solo ``Study.run`` bit for bit.

LM training on the card: the bf16 attention product with an f32
output and its gradient against the upcast product (gradients bitwise);
one reduced train step (adamw, and the flat sgd route through K2)
against the CPU; remat on against off bitwise, deterministic.

Two ranks sharing the card over gloo (a card each over NCCL on a
machine of two) run the launcher's quadratic job through K1 and K2
(``gather`` and the cells axis bitwise the one-process study, ``psum``
and ``fused`` within ``rtol=1e-5, atol=1e-6``), and the last client
shard, every row masked, gives exact zeros.

Two ranks sharing the card over gloo (a card each over NCCL on a
machine of two) serve a reduced phi3.5-moe in bf16 with its experts
split over them (``tests/torch_moe_worker.py``): each rank's prefill
launches K3 once a layer, routes every token as the one-rank prefill
does, bit for bit, and its logits are within K3's bf16 tolerance of the
one-rank prefill's.

K4 (the gated-linear-recurrence scan) against its plain sequential
version on the same inputs: ``max|K4 − plain| ≤ 1e-4·max|plain|``, as in
``chip_smoke.py``; strided views bitwise equal to contiguous copies.
The recurrent slice on the card: reduced zamba2 (its shared attention
also at Dh = 80) and xlstm prefills through K4 and K3, and greedy
decode, against the same calls on the CPU to ``rtol=atol=1e-4``.

The LM zoo on the card: K3 at the GQA ratios of deepseek-coder-33b
(56/8) and llama4-scout (40/8); each of the five decoder-only configs at
``reduced()`` width, flash prefill (K3 once a layer) and greedy decode
against the CPU to ``rtol=atol=1e-4``, the same assignments dropped; the
MoE layer in f32 against the CPU (the chosen experts and the drop mask
bitwise, the output ``1e-5·max``), and two calls of the bf16 MoE layer
giving the same bits.
"""

import ctypes
import dataclasses
import json
import os
import sys
from pathlib import Path

# cuBLAS takes its workspace setting when CUDA starts: the deterministic
# remat test needs a fixed one.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro_torch import random as trandom
from repro_torch.core import (ClientSimulator, DeterministicArrivals,
                              make_quadratic, make_scheduler, ravel_pytree)
from repro_torch.experiments import (Scenario, execute_cells,
                                     execute_cells_resumable, get_study)
from repro_torch.data import ClientBatcher
from repro_torch.configs import get_config
from repro_torch.kernels.aggregate import ops, ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import moe, ssm, transformer
from repro_torch.models.cnn import client_grads_fn, init_cnn
from repro_torch.models.ssm import chunked_gla
from repro_torch.optim import momentum, sgd

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


F32, BF16 = torch.float32, torch.bfloat16
AGG_EDGES = [  # n, p, g dtype
    # P of 1, 3, 5 and 17: one block, and the tensor's partial 16-byte
    # units are plain loads (test_aggregate_blocks_past_p_own_nothing
    # launches one block a SM there).
    (5, 1, F32), (5, 3, F32), (5, 5, F32), (5, 17, F32),
    # Every residue of P mod 4: every row shift of an f32 row.
    (7, 1_000, F32), (7, 1_001, F32), (7, 1_002, F32), (7, 1_003, F32),
    # bf16 rows of odd P: shifts of 1..7 elements.
    (9, 2_049, BF16), (6, 999, BF16), (3, 7, BF16),
    (1, 5_000, F32),      # one row
    (1_100, 513, F32),    # more rows than a 1,024-row stage of w and mask
    (3, 600_001, F32),    # spans of several chunks
]


def _check_forms(g, w, m, params, eta):
    """K1, K2 and the delta against their plain versions (bf16 g into
    f32 at 1e-5); K2 equal to K1 → update bitwise."""
    tol = 1e-6 if g.dtype == torch.float32 else 1e-5
    k1 = ops.masked_scaled_aggregate(g, w, out_dtype=torch.float32, mask=m)
    torch.testing.assert_close(
        k1, ref.masked_scaled_aggregate_ref(g, w, m, torch.float32),
        rtol=tol, atol=tol)
    k2 = ops.masked_scaled_aggregate_update(g, w, eta, params, m)
    torch.testing.assert_close(
        k2, ref.masked_scaled_aggregate_update_ref(g, w, eta, params, m),
        rtol=tol, atol=tol)
    delta = ops.masked_scaled_aggregate_update(g, w, eta, None, m)
    torch.testing.assert_close(
        delta, ref.masked_scaled_aggregate_update_ref(g, w, eta, None, m),
        rtol=tol, atol=tol)
    assert torch.equal(k2, params + (-eta * k1))
    return k1, k2, delta


@pytest.mark.parametrize("n,p,dtype", AGG_EDGES)
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_aggregate_design_edges(card, n, p, dtype, masked):
    g, w, mask, params = _operands(n, p, 7 * n + p)
    _check_forms(g.to(dtype), w, mask if masked else None, params,
                 torch.tensor(0.05, device=card))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("p", [1, 17, 2_049])
def test_aggregate_blocks_past_p_own_nothing(card, p, dtype):
    """One block a SM at a P of fewer 16-byte units than SMs (the
    wrappers' geometry launches fewer blocks there), through the C entry
    points: the blocks past P own nothing and return, and K1 and K2 give
    the wrappers' bits."""
    n = 40
    g, w, mask, params = _operands(n, p, 11)
    g = g.to(dtype)
    eta = torch.tensor(0.05, device=card)
    geo = dataclasses.replace(
        ops.geometry(p, g.element_size(), 132, g.data_ptr(), min_units=1), blocks=132)
    assert geo.spans(p)[-1][1] == p and len(geo.spans(p)) < geo.blocks
    c_geo = ctypes.byref(ops.c_geometry(geo))
    lib, stream = ops.load(), torch.cuda.current_stream()
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    for m in (None, mask):
        m_ptr = None if m is None else m.data_ptr()
        k1, k2 = torch.empty(p, device=card), torch.empty(p, device=card)
        assert lib.masked_scaled_aggregate(
            g.data_ptr(), code, w.data_ptr(), m_ptr, k1.data_ptr(), 0, n, p, c_geo,
            stream.cuda_stream) == 0
        assert lib.masked_scaled_aggregate_update(
            g.data_ptr(), code, w.data_ptr(), m_ptr, eta.data_ptr(), params.data_ptr(), 0,
            k2.data_ptr(), 0, n, p, c_geo, stream.cuda_stream) == 0
        assert torch.equal(k1, ops.masked_scaled_aggregate(g, w, torch.float32, m))
        assert torch.equal(k2, ops.masked_scaled_aggregate_update(g, w, eta, params, m))


def test_aggregate_every_row_masked(card):
    g, w, _, params = _operands(40, 2_049, 5)
    mask = torch.zeros(40, device=card)
    k1, k2, delta = _check_forms(g, w, mask, params, torch.tensor(0.05, device=card))
    assert not k1.any() and not delta.any() and torch.equal(k2, params)


def test_aggregate_masked_row_with_inf_weight_gives_nan(card):
    """A masked row still adds w[n]·0 in its place, so an inf weight
    there gives NaN in every column, as the plain version (and the JAX
    kernel's select-then-dot) does."""
    g, w, mask, params = _operands(40, 2_049, 6)
    w[mask == 0] = float("inf")
    want = ref.masked_scaled_aggregate_ref(g, w, mask)
    got = ops.masked_scaled_aggregate(g, w, mask=mask)
    assert want.isnan().all() and got.isnan().all()
    got2 = ops.masked_scaled_aggregate_update(g, w, 0.05, params, mask)
    assert got2.isnan().all()


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("p", [316_554, 2_049])
def test_aggregate_view_at_odd_storage_offset(card, dtype, p):
    """g one element into its storage, so g's first 16-byte unit is
    partial: the kernel reads no byte outside g and gives the bits of a
    copy at offset 0."""
    n = 40
    gen = torch.Generator(device="cuda").manual_seed(p)
    g = torch.randn(n * p + 1, device=card, generator=gen).to(dtype)[1:].view(n, p)
    assert g.data_ptr() % 16 != 0
    _, w, mask, params = _operands(n, p, 8)
    for m in (None, mask):
        _check_forms(g, w, m, params, torch.tensor(0.05, device=card))
        assert torch.equal(ops.masked_scaled_aggregate(g, w, mask=m),
                           ops.masked_scaled_aggregate(g.clone(), w, mask=m))


def test_aggregate_two_launches_bitwise_equal(card):
    g, w, mask, params = _operands(40, 316_554, 9)
    for gg in (g, g.to(torch.bfloat16)):
        for m in (None, mask):
            assert torch.equal(ops.masked_scaled_aggregate(gg, w, mask=m),
                               ops.masked_scaled_aggregate(gg, w, mask=m))
            assert torch.equal(
                ops.masked_scaled_aggregate_update(gg, w, 0.05, params, m),
                ops.masked_scaled_aggregate_update(gg, w, 0.05, params, m))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k1_once_a_leaf_at_the_cnn_leaf_shapes(card, dtype):
    """The legacy carry's route (``aggregate_client_grads_kernel_per_leaf``)
    at the Fig-1 CNN's 8 leaves, 40 rows, masked rows holding NaN: one
    K1 launch a leaf, each within 1e-6 of its plain version (bf16 leaves
    in the f32-out form within 1e-5, the repo's bf16-into-f32 tolerance;
    the leaf-dtype result is that sum rounded once), the masked rows
    exact zeros, and the leaves bitwise K1 on the raveled (40, 316,554)
    buffer, column by column: each column is summed over n in order in
    one register, whatever its block's span. The weights are bf16 values,
    so the route's rounding of ω to the leaf's dtype leaves them as the
    raveled launch takes them."""
    from repro_torch.core.aggregation import (
        aggregate_client_grads_kernel_per_leaf, ravel_spec, unravel_pytree)

    n = 40
    params = init_cnn(trandom.PRNGKey(0, device="cuda"), image_hw=32)
    spec = ravel_spec(params)
    assert spec.total == 316_554 and len(spec.sizes) == 8
    gen = torch.Generator(device="cuda").manual_seed(31)
    g = torch.randn(n, spec.total, device="cuda", generator=gen).to(dtype)
    w = (torch.rand(n, device="cuda", generator=gen) * (2.0 / n)).to(
        torch.bfloat16).float()
    mask = (torch.arange(n, device="cuda") % 7 != 3).float()
    poisoned = torch.where(mask[:, None] > 0, g, float("nan")).to(dtype)
    raveled = ops.masked_scaled_aggregate(poisoned, w, mask=mask)
    # Each leaf its own (40, ...) buffer, as a grads_fn returns them.
    tree = {k: {kk: v.contiguous() for kk, v in d.items()}
            for k, d in unravel_pytree(poisoned, spec).items()}
    before = ops.launch_counts["masked_scaled_aggregate"]
    out = aggregate_client_grads_kernel_per_leaf(tree, w, mask)
    assert ops.launch_counts["masked_scaled_aggregate"] == before + 8
    leaves = [out[k][kk] for k in sorted(out) for kk in sorted(out[k])]
    assert all(x.dtype == dtype for x in leaves)
    assert torch.equal(torch.cat([x.reshape(-1) for x in leaves]), raveled)
    for (o, size), got in zip(zip(spec.offsets, spec.sizes), leaves):
        leaf = poisoned[:, o:o + size].contiguous()
        clean = g[:, o:o + size].contiguous()
        assert torch.equal(got.reshape(-1), ops.masked_scaled_aggregate(
            torch.where(mask[:, None] > 0, clean, 0).to(dtype), w, mask=mask))
        sum32 = ops.masked_scaled_aggregate(leaf, w, out_dtype=torch.float32, mask=mask)
        assert torch.equal(got.reshape(-1), sum32.to(dtype))
        tol = 1e-6 if dtype == torch.float32 else 1e-5
        torch.testing.assert_close(
            sum32, ref.masked_scaled_aggregate_ref(clean, w, mask, torch.float32),
            rtol=tol, atol=tol)


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


@pytest.mark.parametrize("form", ["legacy", "mixed"])
def test_legacy_carry_on_card_matches_cpu(card, form):
    """The small Fig-1 loop on the legacy tree carry (alg1, momentum):
    ``flat=False`` all f32, or the biases in bf16 under ``flat=None``, on
    the card and on the CPU from one seed: same participation, f32 leaves
    to the CNN tolerance, bf16 leaves to ``rtol=atol=2e-2``
    (``tests/test_torch_legacy_carry.py``), K1 once a leaf a step and no
    K2."""
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
            grads_fn=client_grads_fn(batcher), p=batcher.p,
            optimizer=momentum(0.02), scheduler=make_scheduler("alg1", n),
            energy=DeterministicArrivals.periodic([1, 2, 4, 8] * 2, steps),
            use_kernel=True, flat=False if form == "legacy" else None,
            device=dev)
        params = init_cnn(trandom.PRNGKey(1, device=dev), image_hw=8)
        if form == "mixed":
            params = {k: {kk: v.to(torch.bfloat16) if kk == "b" else v
                          for kk, v in d.items()} for k, d in params.items()}
        assert sim.flat_spec(params) is None
        before = dict(ops.launch_counts)
        final, hist = sim.run(trandom.PRNGKey(7, device=dev), params, steps)
        launched = {k: ops.launch_counts[k] - before[k] for k in before}
        out[dev] = (final, hist, launched)
    assert out["cpu"][2] == {"masked_scaled_aggregate": 0,
                             "masked_scaled_aggregate_update": 0}
    assert out["cuda"][2] == {"masked_scaled_aggregate": 8 * steps,
                              "masked_scaled_aggregate_update": 0}
    assert torch.equal(out["cuda"][1].participation.cpu(),
                       out["cpu"][1].participation)
    for k in out["cpu"][0]:
        for kk, want in out["cpu"][0][k].items():
            got = out["cuda"][0][k][kk].cpu()
            assert got.dtype == want.dtype
            tol = (dict(rtol=2e-2, atol=2e-2) if want.dtype == torch.bfloat16
                   else dict(rtol=1e-4, atol=1e-5))
            torch.testing.assert_close(got.float(), want.float(), **tol)


def test_fig1_study_on_card_through_k2(card):
    """The quadratic ``fig1`` study on the card through the engine: one
    K2 launch a step of every cell and seed, none of K1, and each cell's
    seed bit for bit a standalone ``ClientSimulator.run`` of that cell;
    participation equal to the same study on the CPU."""
    n, steps, seeds = 8, 12, [1, 4]
    problem = make_quadratic(trandom.PRNGKey(0, device=card), n, dim=8)
    study = get_study("fig1", n_clients=n, num_steps=steps, seeds=seeds)
    grads = lambda w, k, t: problem.all_grads(w, key=k, noise=0.05)
    w0 = torch.full((8,), 5.0, device=card)
    kw = dict(grads_fn=grads, p=problem.p, optimizer=sgd(0.01),
              loss_fn=problem.suboptimality, use_kernel=True)
    ops.reset_launch_counts()
    result = study.run(params0=w0, device=card, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts == {
        "masked_scaled_aggregate": 0,
        "masked_scaled_aggregate_update": len(result) * len(seeds) * steps}
    sim = study.simulator(device=card, **kw)
    for sc in study.resolve():
        cell = result[sc.name]
        assert cell.params.device.type == "cuda"
        assert cell.diverged.tolist() == [-1, -1]
        scheduler, energy = sc.build()
        for r, s in enumerate(seeds):
            params, hist = sim.run(trandom.PRNGKey(s, device=card), w0, steps,
                                   scheduler=scheduler, energy=energy)
            assert torch.equal(cell.params[r], params)
            for x, y in zip(cell.history, hist):
                assert torch.equal(x[r], y)
    cpu = problem._replace(**{f: getattr(problem, f).cpu()
                              for f in ("a", "b", "p", "w_star")})
    on_cpu = study.run(
        params0=w0.cpu(), device="cpu", optimizer=sgd(0.01), p=cpu.p,
        grads_fn=lambda w, k, t: cpu.all_grads(w, key=k, noise=0.05),
        loss_fn=cpu.suboptimality, use_kernel=True)
    for name in result:
        assert torch.equal(result[name].history.participation.cpu(),
                           on_cpu[name].history.participation)


def _quadratic_on(card, n=8, dim=8):
    problem = make_quadratic(trandom.PRNGKey(0, device=card), n, dim=dim)
    return problem, dict(
        grads_fn=lambda w, k, t: problem.all_grads(w, key=k, noise=0.05),
        p=problem.p, loss_fn=problem.suboptimality, use_kernel=True)


def _fault_cell(name, n, faults=None, **kw):
    return Scenario(name=name, scheduler="alg1", arrivals="periodic",
                    n_clients=n, horizon=13, faults=faults, fault_kwargs=kw)


@pytest.mark.parametrize("opt,kernel", [
    (lambda: sgd(0.01), "masked_scaled_aggregate_update"),
    (lambda: momentum(0.001, beta=0.9), "masked_scaled_aggregate")],
    ids=["sgd-K2", "momentum-K1"])
def test_dropped_nan_rows_on_card(card, opt, kernel):
    """drop_corrupt with every row NaN-poisoned and dropped, through the
    masked K2 (sgd) and K1 (momentum) on the card: one launch a step,
    params unmoved and finite, no delivered weight."""
    n, steps = 8, 12
    _, kw = _quadratic_on(card, n)
    sim = ClientSimulator(optimizer=opt(), device=card, **kw)
    leak = _fault_cell("leak", n, "drop_corrupt", drop_rate=1.0,
                       corrupt_rate=1.0, scale=float("nan"))
    w0 = torch.full((8,), 5.0, device=card)
    ops.reset_launch_counts()
    cell = execute_cells([leak], sim=sim, params0=w0, num_steps=steps,
                         seeds=[0, 1])["leak"]
    torch.cuda.synchronize()
    assert ops.launch_counts[kernel] == 2 * steps
    assert torch.equal(cell.params, w0.expand(2, 8))
    assert bool(cell.history.finite.all())
    assert bool((cell.history.weight_sum == 0).all())
    assert cell.diverged.tolist() == [-1, -1]


def test_rate0_fault_is_the_identity_through_k2(card):
    """A drop fault at rate 0 runs K2's masked body under an all-ones
    mask: bit for bit the clean cell's unmasked run."""
    n, steps = 8, 12
    _, kw = _quadratic_on(card, n)
    sim = ClientSimulator(optimizer=sgd(0.01), device=card, **kw)
    cells = [_fault_cell("clean", n), _fault_cell("rate0", n, "drop", rate=0.0),
             _fault_cell("stale0", n, "stale", rate=0.0, delay=2)]
    out = execute_cells(cells, sim=sim, params0=torch.full((8,), 5.0,
                                                           device=card),
                        num_steps=steps, seeds=[3])
    for name in ("rate0", "stale0"):
        for x, y in zip(out[name].history, out["clean"].history):
            assert torch.equal(x, y), name
        assert torch.equal(out[name].params, out["clean"].params)


def test_resumed_k2_study_on_card_is_bitwise(card, tmp_path):
    """A checkpointed study on the card (K2, faults, a ragged cell)
    equals execute_cells, and resuming its directory from a middle
    checkpoint equals the uninterrupted run, bit for bit."""
    n, steps = 8, 12
    _, kw = _quadratic_on(card, n)
    sim = ClientSimulator(optimizer=sgd(0.01), device=card, **kw)
    cells = [_fault_cell("clean", n), _fault_cell("drop", n, "drop", rate=0.3),
             _fault_cell("stale_n6", 6, "stale", rate=0.5, delay=3)]
    run = dict(sim=sim, params0=torch.full((8,), 5.0, device=card),
               num_steps=steps, seeds=[0, 1])
    plain = execute_cells(cells, **run)
    ck = str(tmp_path / "ck")
    whole = execute_cells_resumable(cells, checkpoint_dir=ck,
                                    checkpoint_every=5, keep=0, **run)
    for gid in sorted(os.listdir(ck)):
        if gid.startswith("g"):  # keep only step 5 of every group
            for f in os.listdir(os.path.join(ck, gid)):
                if f != "step_5.npz":
                    os.remove(os.path.join(ck, gid, f))
    resumed = execute_cells_resumable(cells, checkpoint_dir=ck,
                                      checkpoint_every=5, keep=0, **run)
    for other in (whole, resumed):
        for name in plain:
            a = [x for x in (plain[name].params, *plain[name].history,
                             plain[name].diverged)]
            b = [x for x in (other[name].params, *other[name].history,
                             other[name].diverged)]
            for x, y in zip(a, b):
                assert x.device.type == "cuda" and torch.equal(x, y), name


def test_service_dispatch_through_k2_on_card(card, tmp_path):
    """The Study service on the card: a mixed-population batch of one
    structure is one dispatch and one compile, K2 launches once a step
    of every cell and seed, each response equals its solo Study.run bit
    for bit, repeat traffic compiles nothing, and a checkpointed
    dispatch equals the plain one."""
    from repro_torch.experiments import ExecutionConfig, Study
    from repro_torch.serve import StudyService

    n, steps, pops = 8, 12, (3, 5, 8)
    _, kw = _quadratic_on(card, n)
    w0 = torch.full((8,), 5.0, device=card)
    svc = StudyService(optimizer=sgd(0.01), params0=w0, device=card,
                       checkpoint_root=str(tmp_path), **kw)
    studies = [Study(f"s{i}", num_steps=steps).axis("scheduler", "alg1")
               .axis("arrivals", "periodic").axis("n_clients", m)
               .axis("seeds", [0, 1]) for i, m in enumerate(pops)]
    ops.reset_launch_counts()
    rids = [svc.submit(s.to_json()) for s in studies]
    responses = svc.flush()
    assert all(r.error is None for r in responses)
    assert ops.launch_counts == {
        "masked_scaled_aggregate": 0,
        "masked_scaled_aggregate_update": len(pops) * 2 * steps}
    assert svc.stats()["compiles"] == 1
    ck = [svc.submit(s.to_json(), ExecutionConfig(checkpoint_every=5))
          for s in studies]
    svc.flush()
    for rid, ck_rid, study in zip(rids, ck, studies):
        alone = study.run(optimizer=sgd(0.01), params0=w0, device=card, **kw)
        for got in (svc.result(rid).result, svc.result(ck_rid).result):
            for name in alone.cells:
                a, b = alone.cells[name], got.cells[name]
                for x, y in zip((a.params, *a.history, a.diverged),
                                (b.params, *b.history, b.diverged)):
                    assert x.device.type == "cuda" and torch.equal(x, y)
    for s in studies:
        svc.submit(s.to_json())
    assert svc.flush()[0].batch["new_compiles"] == 0


K3_CASES = [  # (B, H, Hkv, S, T, Dh), causal, window, dtype
    ((2, 8, 8, 512, 512, 64), True, 0, torch.bfloat16),
    ((2, 8, 2, 256, 256, 128), True, 0, torch.bfloat16),
    ((1, 4, 4, 1000, 1000, 64), True, 128, torch.bfloat16),
    ((2, 4, 2, 100, 40, 64), False, 16, torch.bfloat16),
    ((2, 4, 4, 200, 200, 64), False, 0, torch.float32),
    ((1, 4, 1, 130, 70, 128), True, 0, torch.float32),
    ((1, 2, 2, 1, 1, 64), True, 0, torch.bfloat16),
    # S and T not multiples of the 128-row query or key tile.
    ((1, 4, 4, 300, 300, 128), True, 0, torch.bfloat16),
    # Dh = 128 with GQA and a window, the shape of the GQA models.
    ((2, 12, 2, 1000, 1000, 128), True, 256, torch.bfloat16),
    # One query row against a ragged T.
    ((2, 8, 2, 1, 300, 128), False, 0, torch.bfloat16),
    # Query tiles 1 and 2 (rows 128..299) see no key at all.
    ((1, 4, 2, 300, 40, 128), False, 16, torch.bfloat16),
    # Dh = 80, zamba2-2.7b's shared attention (32 heads, MHA) in the
    # Dh = 128 tile: ragged S, GQA with a window, and the f32 path.
    ((2, 32, 32, 256, 256, 80), True, 0, torch.bfloat16),
    ((1, 8, 2, 300, 300, 80), True, 64, torch.bfloat16),
    ((2, 4, 2, 100, 40, 80), False, 16, torch.bfloat16),
    ((1, 4, 4, 130, 130, 80), True, 0, torch.float32),
    # The GQA ratios of deepseek-coder-33b (56/8), llama4-scout (40/8),
    # command-r-35b (64/8) and phi3.5-moe (32/8), heads of 128.
    ((1, 56, 8, 300, 300, 128), True, 0, torch.bfloat16),
    ((2, 40, 8, 256, 256, 128), True, 0, torch.bfloat16),
    ((1, 64, 8, 300, 300, 128), True, 0, torch.bfloat16),
    ((2, 32, 8, 256, 256, 128), True, 0, torch.bfloat16),
    # qwen2-vl-2b's prefill (12 heads over 2 kv heads of 128) and
    # whisper-tiny's decoder self-attention (6 heads of 64 over its
    # 448-token text context, no multiple of the 128-row tile), each at
    # the model's B = 8.
    ((8, 12, 2, 2048, 2048, 128), True, 0, torch.bfloat16),
    ((8, 6, 6, 448, 448, 64), True, 0, torch.bfloat16),
]


@pytest.mark.parametrize("shape,causal,window,dtype", K3_CASES)
def test_k3_matches_plain_version(card, shape, causal, window, dtype):
    b, h, hkv, s, t, dh = shape
    gen = torch.Generator(device="cuda").manual_seed(s + t + dh)
    q = torch.randn(b, s, h, dh, device=card, generator=gen).to(dtype)
    k = torch.randn(b, t, hkv, dh, device=card, generator=gen).to(dtype)
    v = torch.randn(b, t, hkv, dh, device=card, generator=gen).to(dtype)
    before = fa_ops.launch_counts["flash_attention"]
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_ops.launch_counts["flash_attention"] == before + 1
    want = fa_ref.flash_attention_ref(
        q.float().transpose(1, 2), k.float().transpose(1, 2),
        v.float().transpose(1, 2), causal=causal, window=window).transpose(1, 2)
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    else:
        err = (out.float() - want).abs().max().item()
        assert err <= 2 ** -7 * want.abs().max().item()
    dead = ~fa_ref.visible_mask(s, t, causal=causal, window=window,
                                device=card).any(dim=1)
    assert torch.all(out[:, dead] == 0)


@pytest.mark.parametrize("shape,causal,window", [
    ((2, 8, 8, 512, 512, 64), True, 0),
    ((2, 12, 4, 700, 700, 128), True, 256),
    ((2, 8, 8, 300, 300, 80), True, 0),
])
def test_k3_is_deterministic(card, shape, causal, window):
    """Two launches on the same inputs give the same bits: no atomics,
    a fixed order of every sum."""
    b, h, hkv, s, t, dh = shape
    gen = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn(b, s, h, dh, device=card, generator=gen).bfloat16()
    k = torch.randn(b, t, hkv, dh, device=card, generator=gen).bfloat16()
    v = torch.randn(b, t, hkv, dh, device=card, generator=gen).bfloat16()
    first = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    second = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(first, second)


def test_k3_wrapper_refuses_what_the_kernel_does_not_take(card):
    q = torch.zeros(1, 8, 4, 64, device=card, dtype=torch.bfloat16)
    kv = torch.zeros(1, 8, 2, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        fa_ops.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fa_ops.flash_attention(q, kv[:, :, :1].expand(1, 8, 3, 64).contiguous(),
                               kv[:, :, :1].expand(1, 8, 3, 64).contiguous())
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q[..., :32].contiguous(), kv[..., :32].contiguous(),
                               kv[..., :32].contiguous())
    with pytest.raises(ValueError, match="several devices"):
        fa_ops.flash_attention(q, kv.cpu(), kv)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               kv, kv)


def test_lm_slice_on_card_matches_cpu(card):
    """The reduced 2-layer stablelm (f32): flash prefill through K3 (one
    launch a layer) and 8 greedy decode steps on the card agree with the
    same calls on the CPU."""
    cfg = get_config("stablelm-1.6b").reduced().replace(
        superblock=(("attn_mlp", 2, False),), use_flash=True)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 48))
    out = {}
    for dev in ("cpu", "cuda"):
        params = transformer.init_lm(trandom.PRNGKey(0, device=dev), cfg)
        tokens = torch.from_numpy(toks).to(dev)
        before = fa_ops.launch_counts["flash_attention"]
        logits = make_prefill_step(cfg)(params, {"tokens": tokens})
        launched = fa_ops.launch_counts["flash_attention"] - before
        serve = make_serve_step(cfg)
        states = transformer.init_decode_state(cfg, 2, 8, device=dev)
        tok, steps = tokens[:, :1], []
        for pos in range(8):
            nxt, step_logits, states = serve(params, tok, states, pos)
            tok = nxt[:, None]
            steps.append((nxt.cpu(), step_logits.cpu()))
        out[dev] = (logits.cpu(), launched, steps)
    assert out["cpu"][1] == 0 and out["cuda"][1] == cfg.total_layers
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    for (tc, lc), (tg, lg) in zip(out["cpu"][2], out["cuda"][2]):
        assert torch.equal(tg, tc)
        torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)


ZOO = ("minitron-4b", "deepseek-coder-33b", "command-r-35b",
       "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")


@pytest.mark.parametrize("name", ZOO)
def test_zoo_slice_on_card_matches_cpu(card, name):
    """Each decoder-only config of the zoo at ``reduced()`` width with
    two layers and 2 kv heads for its 4 query heads, f32: the flash
    prefill on the card (K3 once a layer) and 8 greedy decode steps agree with the same calls on the
    CPU, ``rtol=atol=1e-4``; the MoE layers route alike."""
    cfg = get_config(name).reduced().replace(
        n_kv_heads=2, superblock=((get_config(name).resolved_superblock[0][0],
                                   2, False),), use_flash=True)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 40))
    out = {}
    for dev in ("cpu", "cuda"):
        params = transformer.init_lm(trandom.PRNGKey(0, device=dev), cfg)
        tokens = torch.from_numpy(toks).to(dev)
        before = fa_ops.launch_counts["flash_attention"]
        moe.reset_dispatch_counts()
        logits = make_prefill_step(cfg)(params, {"tokens": tokens})
        launched = fa_ops.launch_counts["flash_attention"] - before
        dropped = int(moe.dispatch_counts["dropped"])
        serve = make_serve_step(cfg)
        states = transformer.init_decode_state(cfg, 2, 8, device=dev)
        tok, steps = tokens[:, :1], []
        for pos in range(8):
            nxt, step_logits, states = serve(params, tok, states, pos)
            tok = nxt[:, None]
            steps.append((nxt.cpu(), step_logits.cpu()))
        out[dev] = (logits.cpu(), launched, dropped, steps)
    assert out["cpu"][1] == 0 and out["cuda"][1] == 2
    assert out["cuda"][2] == out["cpu"][2]
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    for (tc, lc), (tg, lg) in zip(out["cpu"][3], out["cuda"][3]):
        assert torch.equal(tg, tc)
        torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)


def _moe_layer(dtype, shared):
    """A reduced MoE layer (d 256, d_ff 512, 4 experts) drawn on the CPU,
    and 8 x 64 tokens."""
    params = moe.init_moe(trandom.PRNGKey(7, device="cpu"), 256, 512, 4,
                          dtype, shared_expert=shared)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (8, 64, 256)).astype(np.float32)).to(dtype)
    x[0, :3] = 0.0  # ties: every expert's logit equal
    return params, x


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("top_k,shared,cf", [(2, False, 1.25), (1, True, 0.5)],
                         ids=["phi3.5-like", "llama4-like-dropping"])
def test_moe_layer_on_card_matches_cpu(card, top_k, shared, cf):
    """The MoE layer in f32 on the card against the CPU: the chosen
    experts and the drop mask bitwise, the output ``1e-5·max``, the aux
    loss ``1e-5``."""
    params, x = _moe_layer(torch.float32, shared)
    kw = dict(n_experts=4, top_k=top_k, capacity_factor=cf,
              shared_expert=shared)
    got = {}
    for dev in ("cpu", "cuda"):
        p, xd = _to(params, dev), x.to(dev)
        _, _, top_e, pos, cap = moe.route(p["router"], xd.reshape(-1, 256),
                                          n_experts=4, top_k=top_k,
                                          capacity_factor=cf)
        y, aux = moe.apply_moe(p, xd, **kw)
        got[dev] = (top_e.cpu(), (pos < cap).cpu(), y.cpu(), aux.cpu())
    assert torch.equal(got["cuda"][0], got["cpu"][0])
    assert torch.equal(got["cuda"][1], got["cpu"][1])
    assert (~got["cpu"][1]).any() == (cf < 1)
    ymax = got["cpu"][2].abs().max().item()
    torch.testing.assert_close(got["cuda"][2], got["cpu"][2], rtol=0,
                               atol=1e-5 * ymax)
    torch.testing.assert_close(got["cuda"][3], got["cpu"][3], rtol=1e-5,
                               atol=0)


def test_bf16_moe_layer_on_card_is_deterministic(card):
    """Two calls of the bf16 MoE layer on the same inputs give the same
    bits: every slot of the expert buffer written once, the k terms
    summed in order, no atomics."""
    params, x = _moe_layer(torch.bfloat16, True)
    p, xd = _to(params, card), x.to(card)
    kw = dict(n_experts=4, top_k=2, capacity_factor=0.75, shared_expert=True)
    (y1, a1), (y2, a2) = (moe.apply_moe(p, xd, **kw) for _ in range(2))
    assert y1.dtype == torch.bfloat16
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


@pytest.mark.parametrize("name,kw", [
    ("zamba2-2.7b", {}), ("zamba2-2.7b", {"head_dim": 80}), ("xlstm-1.3b", {})],
    ids=["zamba2", "zamba2-dh80", "xlstm"])
def test_recurrent_slice_on_card_matches_cpu(card, name, kw):
    """A reduced zamba2 (Mamba2 and the shared attention block, two
    super-blocks) and a reduced xlstm (mLSTM and sLSTM), f32, chunk 16:
    the kernel prefill on the card (K4 once a Mamba2 or mLSTM layer, K3
    once a shared-block call) and 8 greedy decode steps agree with the
    same calls on the CPU (the plain versions), ``rtol=atol=1e-4``."""
    cfg = get_config(name).reduced().replace(use_flash=True, gla_chunk=16, **kw)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40))
    n_scan = cfg.n_super * sum(c for k, c, _ in cfg.resolved_superblock
                               if k in ("mamba2", "mlstm"))
    n_attn = cfg.n_super * sum(c for k, c, _ in cfg.resolved_superblock
                               if k == "attn_mlp")
    out = {}
    for dev in ("cpu", "cuda"):
        params = transformer.init_lm(trandom.PRNGKey(0, device=dev), cfg)
        tokens = torch.from_numpy(toks).to(dev)
        before = (ssm_ops.launch_counts["gla_scan"],
                  fa_ops.launch_counts["flash_attention"])
        logits = make_prefill_step(cfg)(params, {"tokens": tokens})
        launched = (ssm_ops.launch_counts["gla_scan"] - before[0],
                    fa_ops.launch_counts["flash_attention"] - before[1])
        serve = make_serve_step(cfg)
        states = transformer.init_decode_state(cfg, 2, 8, device=dev)
        tok, steps = tokens[:, :1], []
        for pos in range(8):
            nxt, step_logits, states = serve(params, tok, states, pos)
            tok = nxt[:, None]
            steps.append((nxt.cpu(), step_logits.cpu()))
        out[dev] = (logits.cpu(), launched, steps)
    assert out["cpu"][1] == (0, 0) and out["cuda"][1] == (n_scan, n_attn)
    assert n_scan == 2 and n_attn == (2 if name == "zamba2-2.7b" else 0)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    for (tc, lc), (tg, lg) in zip(out["cpu"][2], out["cuda"][2]):
        assert torch.equal(tg, tc)
        torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)


def _slstm_eager(pre, r):
    """The sLSTM loop through ``slstm_cell`` launch by launch, autograd
    recording every step: the route the CUDA graphs replace."""
    b, s, n_heads, _ = pre.shape
    state = ssm.init_slstm_state(b, n_heads * r.shape[1], n_heads,
                                 device=pre.device)
    hs = []
    for t in range(s):
        state = ssm.slstm_cell(pre[:, t], r, state)
        hs.append(state["h"])
    return torch.stack(hs, 1)


@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["default", "deterministic"])
def test_slstm_graphs_match_the_eager_loop(card, deterministic):
    """The sLSTM's loops as CUDA graphs (the forward keeping what the
    backward reads, the forward alone, and the hand-written backward):
    three calls with other inputs each (the first captures, the others
    replay after copying their inputs in), with deterministic algorithms
    off or on (one graph serves both), against the loop launched step
    by step with autograd on the card: h bitwise, the gradients of the
    bf16 input projection and of r within 1e-5 of the largest, the bf16
    one also within one bf16 ulp (2**-7 relative) of each element: its
    f32 sums run in another order, and an element at a rounding boundary
    lands on the neighbouring bf16 value."""
    ssm.release_slstm_graphs()
    torch.use_deterministic_algorithms(deterministic)
    try:
        for seed in range(3):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            pre = (torch.randn(4, 40, 2, 128, device="cuda", generator=gen)
                   * 2).bfloat16()
            r = torch.randn(2, 32, 128, device="cuda", generator=gen) / 32 ** 0.5
            w = torch.randn(4, 40, 2, 32, device="cuda", generator=gen)
            outs = []
            for fn in (ssm._SLSTMScan.apply, _slstm_eager):
                p, q = pre.clone().requires_grad_(), r.clone().requires_grad_()
                y = fn(p, q)
                outs.append((y,) + torch.autograd.grad((y * w).sum(), (p, q)))
            (y, d_pre, d_r), (y_ref, d_pre_ref, d_r_ref) = outs
            with torch.no_grad():
                y_alone, = ssm._graphed(ssm._scan_forward, pre, r, keep=False)
            assert torch.equal(y, y_ref) and torch.equal(y_alone, y_ref)
            for got, ref_ in ((d_pre, d_pre_ref), (d_r, d_r_ref)):
                torch.testing.assert_close(
                    got.float(), ref_.float(),
                    rtol=2 ** -7 if got.dtype == torch.bfloat16 else 0,
                    atol=1e-5 * ref_.abs().max().item())
        assert len(ssm._GRAPHS) == 3
    finally:
        torch.use_deterministic_algorithms(False)
        ssm.release_slstm_graphs()


def test_xlstm_gradients_on_card_match_cpu(card):
    """A reduced xlstm (mLSTM and sLSTM, f32, remat full) differentiated
    on the card (the sLSTM's loops as CUDA graphs, the mLSTM through
    ``chunked_gla``) against the CPU (the loops launched step by step):
    the loss ``rtol=1e-5``, every gradient within 1e-4 of its leaf's
    largest."""
    from repro_torch._tree import tree_leaves, tree_map
    cfg = get_config("xlstm-1.3b").reduced().replace(gla_chunk=16, remat=True)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 41))
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda x: x.requires_grad_(), transformer.init_lm(
            trandom.PRNGKey(0, device=dev), cfg))
        raw = torch.from_numpy(toks).to(dev)
        losses, _ = transformer.per_example_loss(
            params, cfg, {"tokens": raw[:, :-1], "labels": raw[:, 1:]})
        loss = losses.sum()
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out[dev] = (loss.item(), [g.cpu() for g in grads])
    ssm.release_slstm_graphs()
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for g, c in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(g, c, rtol=0,
                                   atol=1e-4 * c.abs().max().item() + 1e-12)


def test_decode_attention_reads_the_bf16_cache_in_place(card):
    """One decode query against a bf16 head-major cache: the same numbers
    as on the CPU, and no copy of the cache on the way, to f32 or to
    another layout: the call's peak memory stays below the size of one
    cache tensor. Both sides round p to bf16 from f32 logits summed in
    different orders, so a p may round the other way: each output is
    held to 2**-8·(Σ p|v| + |out|), one bf16 step of p on each side
    and one of the output."""
    from repro_torch.models.attention import _sdpa_heads
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(2, 1, 8, 64, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(2, 4, 4096, 64, device="cuda", generator=gen).bfloat16()
            for _ in range(2))
    mask = torch.zeros(1, 4096, device="cuda")
    mask[:, 3000:] = -1e30
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = _sdpa_heads(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < k.numel() * k.element_size()
    want = _sdpa_heads(q.cpu(), k.cpu(), v.cpu(), mask.cpu()).float()
    pv_abs = _sdpa_heads(q.cpu().float(), k.cpu().float(), v.cpu().float().abs(),
                         mask.cpu())
    err = (got.float().cpu() - want).abs()
    assert (err <= 2 ** -8 * (pv_abs + want.abs())).all(), err.max()


F32, KQ_BF16 = ("float32",) * 4, ("float32", "bfloat16", "float32", "bfloat16")
K4_CASES = [  # (B, S, H, dk, dv), chunk, dtypes of a, k, v, q
    ((2, 100, 3, 40, 33), 16, F32),
    ((2, 100, 3, 40, 33), 32, F32),
    ((1, 77, 2, 16, 17), 32, KQ_BF16),
    ((2, 130, 2, 64, 64), 64, ("bfloat16",) * 4),
    ((1, 70, 2, 1024, 1025), 64, F32),      # xlstm width, ragged S and dv
    ((1, 70, 1, 608, 40), 64, F32),         # two blocks an SM up to here,
    ((1, 70, 1, 640, 40), 64, KQ_BF16),     # one from here on
    ((1, 65, 1, 1536, 40), 64, KQ_BF16),    # the largest dk
    ((1, 1, 1, 8, 1), 16, F32),
]


def _k4_inputs(shape, dtypes, seed, small_decay=False, shared=False):
    """With ``shared`` k and q hold one row a position, expanded over the
    heads with stride 0, as the Mamba2 block makes them."""
    b, s, h, dk, dv = shape
    kq_heads = 1 if shared else h
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand(b, s, h, device="cuda", generator=gen)
    if small_decay:  # log-uniform down to 1e-6, and exact zeros for the clamp
        a = torch.exp(u * torch.log(torch.tensor(1e-6)))
        a[:, ::13] = 0.0
    else:
        a = 0.6 + 0.4 * u
    k = torch.randn(b, s, kq_heads, dk, device="cuda", generator=gen) * dk ** -0.5
    q = torch.randn(b, s, kq_heads, dk, device="cuda", generator=gen) * dk ** -0.5
    v = torch.randn(b, s, h, dv, device="cuda", generator=gen)
    a, k, v, q = (x.to(getattr(torch, d)) for x, d in zip((a, k, v, q), dtypes))
    return a, k.expand(b, s, h, dk), v, q.expand(b, s, h, dk)


def _k4_plain(a, k, v, q):
    b, s, h = a.shape
    fold = lambda x: x.transpose(1, 2).reshape((b * h, s) + x.shape[3:])
    y = ssm_ref.gla_scan_ref(fold(a), fold(k), fold(v), fold(q))
    return y.reshape(b, h, s, v.shape[-1]).transpose(1, 2)


def _k4_agrees(y, want):
    assert y.dtype == torch.float32 and y.shape == want.shape
    assert torch.isfinite(y).all()
    err = (y - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.parametrize("shape,chunk,dtypes", K4_CASES)
def test_k4_matches_plain_version(card, shape, chunk, dtypes):
    x = _k4_inputs(shape, dtypes, seed=sum(shape) + chunk)
    before = ssm_ops.launch_counts["gla_scan"]
    y = ssm_ops.gla_scan(*x, chunk=chunk)
    assert ssm_ops.launch_counts["gla_scan"] == before + 1
    _k4_agrees(y, _k4_plain(*x))
    assert torch.equal(y, ssm_ops.gla_scan(*x, chunk=chunk))  # deterministic


def test_k4_small_decays_and_chunk_invariance(card):
    """Decays down to 1e-6 (exp(la_t − la_s) overflows above the
    diagonal) and exact zeros (the 1e-12 clamp): finite and within the
    tolerance at every chunk, each chunk against chunk 64 too."""
    x = _k4_inputs((2, 300, 3, 64, 48), KQ_BF16, seed=11, small_decay=True)
    want = _k4_plain(*x)
    y64 = ssm_ops.gla_scan(*x, chunk=64)
    for chunk in ssm_ops.CHUNKS:
        y = ssm_ops.gla_scan(*x, chunk=chunk)
        _k4_agrees(y, want)
        _k4_agrees(y, y64)


def test_k4_reads_strided_views_in_place(card):
    """k and q broadcast over heads (stride 0, as the Mamba2 block makes
    them), v and a slices of wider tensors: the same bits as contiguous
    copies of the same values."""
    b, s, h, dk, dv = 2, 90, 4, 32, 20
    gen = torch.Generator(device="cuda").manual_seed(12)
    a = (0.6 + 0.4 * torch.rand(b, h, s, device="cuda", generator=gen)).transpose(1, 2)
    kb = torch.randn(b, s, 1, dk, device="cuda", generator=gen).bfloat16()
    qb = torch.randn(b, s, 1, dk, device="cuda", generator=gen).bfloat16()
    k, q = kb.expand(b, s, h, dk), qb.expand(b, s, h, dk)
    v = torch.randn(b, s, h, 3 * dv, device="cuda", generator=gen)[..., dv:2 * dv]
    assert not any(t.is_contiguous() for t in (a, k, v, q))
    y = ssm_ops.gla_scan(a, k, v, q, chunk=32)
    dense = ssm_ops.gla_scan(*(t.contiguous() for t in (a, k, v, q)), chunk=32)
    assert torch.equal(y, dense)
    _k4_agrees(y, _k4_plain(a, k, v, q))


def test_k4_makes_no_f32_copy_of_bf16_operands(card):
    """bf16 k and q are upcast in registers: the call's peak memory
    stays below the output plus one f32 copy of k."""
    x = _k4_inputs((1, 4096, 4, 512, 16), KQ_BF16, seed=13)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = ssm_ops.gla_scan(*x)
    torch.cuda.synchronize()
    k_f32 = x[1].numel() * 4
    assert torch.cuda.max_memory_allocated() - base < y.numel() * 4 + k_f32
    _k4_agrees(y, _k4_plain(*x))


K4_EDGES = [  # (B, S, H, dk, dv), chunk, dtypes of a, k, v, q, shared k/q, small decays
    # k and q shared by the heads (stride 0): the scores are formed once a
    # batch row, at head counts that fill no block evenly
    ((2, 200, 3, 64, 64), 64, KQ_BF16, True, False),
    ((1, 200, 80, 64, 64), 64, KQ_BF16, True, False),
    ((1, 200, 3, 128, 40), 32, F32, True, False),
    # dv ragged against the 64-column slice: in a block of its own (dk 64)
    # and in a cluster taking 64 dk rows a step (dk 128, 256); the largest
    # dk below takes the cluster with 32 rows a step
    ((1, 100, 2, 64, 65), 64, F32, False, False),
    ((1, 100, 2, 128, 65), 64, KQ_BF16, False, False),
    ((1, 100, 1, 256, 1025), 64, F32, False, False),
    # dk not a multiple of the k tile
    ((2, 100, 2, 40, 48), 64, F32, False, False),
    ((1, 90, 2, 1000, 40), 64, F32, False, False),
    # S shorter than one chunk, at every chunk
    ((2, 5, 3, 32, 20), 16, F32, False, False),
    ((2, 30, 3, 32, 20), 32, KQ_BF16, True, False),
    ((2, 63, 3, 96, 20), 64, F32, False, False),
    # small decays with exact zeros, on the shared path
    ((2, 300, 5, 64, 64), 64, KQ_BF16, True, True),
    ((1, 300, 3, 256, 48), 32, KQ_BF16, True, True),
    # the largest dk, ragged dv
    ((1, 100, 2, 1536, 33), 64, F32, False, False),
    # strides that TMA cannot take (not multiples of 16 bytes): q and k by
    # cp.async; bf16 rows aligned to 2 bytes only, by plain loads, in one
    # block and spread over a cluster
    ((1, 100, 2, 33, 20), 32, F32, False, False),
    ((1, 100, 2, 13, 20), 16, KQ_BF16, False, False),
    ((1, 60, 2, 64, 33), 64, ("float32", "float32", "bfloat16", "float32"), False, False),
    ((1, 60, 2, 128, 33), 32, ("float32", "float32", "bfloat16", "float32"), False, False),
]


@pytest.mark.parametrize("shape,chunk,dtypes,shared,small_decay", K4_EDGES)
def test_k4_design_edges(card, shape, chunk, dtypes, shared, small_decay):
    """The edges of the kernel's tiling: within the tolerance of the
    plain version, deterministic, and a stride-0 k and q give the bits of
    dense copies."""
    x = _k4_inputs(shape, dtypes, seed=sum(shape) + chunk, small_decay=small_decay,
                   shared=shared)
    y = ssm_ops.gla_scan(*x, chunk=chunk)
    _k4_agrees(y, _k4_plain(*x))
    assert torch.equal(y, ssm_ops.gla_scan(*x, chunk=chunk))
    if shared:
        dense = ssm_ops.gla_scan(*(t.contiguous() for t in x), chunk=chunk)
        assert torch.equal(y, dense)


def test_k4_wrapper_refuses_what_the_kernel_does_not_take(card):
    a = torch.ones(1, 8, 2, device=card)
    k = torch.zeros(1, 8, 2, 16, device=card)
    v = torch.zeros(1, 8, 2, 4, device=card)
    before = ssm_ops.launch_counts["gla_scan"]
    for chunk in (8, 128):
        with pytest.raises(ValueError, match="chunk"):
            ssm_ops.gla_scan(a, k, v, k, chunk=chunk)
    with pytest.raises(TypeError, match="q must be"):
        ssm_ops.gla_scan(a, k, v, k.half())
    big = torch.zeros(1, 8, 2, ssm_ops.MAX_DK + 1, device=card)
    with pytest.raises(ValueError, match="dk"):
        ssm_ops.gla_scan(a, big, v, big)
    with pytest.raises(ValueError, match="several devices"):
        ssm_ops.gla_scan(a, k, v.cpu(), k)
    assert ssm_ops.launch_counts["gla_scan"] == before


def test_chunked_gla_on_card_matches_kernel(card):
    """The port's GLA engine on the card (cuBLAS einsums, TF32 off)
    against K4 and the plain version."""
    x = _k4_inputs((2, 200, 3, 64, 65), KQ_BF16, seed=14)
    want = _k4_plain(*x)
    y, hf = chunked_gla(*x, chunk=64)
    _k4_agrees(y, want)
    _k4_agrees(ssm_ops.gla_scan(*x, chunk=64), y)
    assert hf.shape == (2, 3, 64, 65) and torch.isfinite(hf).all()


def test_f32_product_gradient_on_card_matches_upcast_product(card):
    """The bf16 attention product with an f32 output (tensor cores,
    ``out_dtype``) and its gradient against the same product on operands
    upcast to f32: the forward to f32 sum order, the gradients (JAX's
    transpose rule: f32 cotangent times the other operand upcast, cast
    to the operand's dtype) bit for bit."""
    from repro_torch.models.attention import _mm_f32
    gen = torch.Generator(device="cuda").manual_seed(21)
    a = torch.randn(6, 40, 64, device=card, generator=gen).to(torch.bfloat16)
    b = torch.randn(6, 64, 48, device=card, generator=gen).to(torch.bfloat16)
    ct = torch.randn(6, 40, 48, device=card, generator=gen)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = _mm_f32(a1, b1)
    want = torch.bmm(a2.float(), b2.float())
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(out, (a1, b1), ct)
    ref_grads = torch.autograd.grad(want, (a2, b2), ct)
    for g, r in zip(got, ref_grads):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, r)


def test_train_step_on_card_matches_cpu(card):
    """One energy-weighted train step of the reduced 2-layer stablelm
    (f32, remat on) on the card against the CPU: adamw through
    ``make_train_step`` (loss ``rtol=1e-5``, params within 2·lr, Adam's
    first step being about ``lr·sign(g)``), and the flat sgd route
    through K2 (one launch) against the CPU's plain version
    (``rtol=1e-4, atol=1e-6``)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core.trainer import build_energy_train_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    cfg = get_config("stablelm-1.6b").reduced().replace(
        superblock=(("attn_mlp", 2, False),), remat=True)
    rng = np.random.default_rng(3)
    raw = rng.integers(0, cfg.vocab, (8, 33)).astype(np.int32)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    scale = torch.tensor([2.0, 1.0, 4.0, 1.0])
    out = {}
    for dev in ("cpu", "cuda"):
        params = transformer.init_lm(trandom.PRNGKey(0, device=dev), cfg)
        batch = {"tokens": torch.from_numpy(raw[:, :-1]).to(dev),
                 "labels": torch.from_numpy(raw[:, 1:]).to(dev),
                 "client_ids": torch.arange(4, dtype=torch.int32,
                                            device=dev).repeat_interleave(2)}
        init, step = make_train_step(cfg, 4, optimizer=adamw(3e-4))
        state, metrics = step(init(params), batch, mask.to(dev), scale.to(dev))
        finit, fstep = build_energy_train_step(
            per_example_loss_fn=lambda p, b: transformer.per_example_loss(p, cfg, b),
            optimizer=sgd(0.05), n_clients=4, flat=True, use_kernel=True)
        before = ops.launch_counts["masked_scaled_aggregate_update"]
        fstate, _ = fstep(finit(params), batch, mask.to(dev), scale.to(dev))
        launched = ops.launch_counts["masked_scaled_aggregate_update"] - before
        out[dev] = (float(metrics["loss"]), [x.cpu() for x in tree_leaves(state.params)],
                    [x.cpu() for x in tree_leaves(fstate.params)], launched)
    assert out["cpu"][3] == 0 and out["cuda"][3] == 1
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for g, c in zip(out["cuda"][1], out["cpu"][1]):
        assert (g - c).abs().max().item() <= 2 * 3e-4
    for g, c in zip(out["cuda"][2], out["cpu"][2]):
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-6)


def test_remat_on_card_gives_the_same_bits(card):
    """bf16 reduced stablelm on the card, deterministic algorithms: the
    loss and gradients with each layer recomputed (policies "full" and
    "dots") equal those without remat, bit for bit."""
    from repro_torch._tree import tree_leaves, tree_map
    base = get_config("stablelm-1.6b").reduced().replace(
        superblock=(("attn_mlp", 2, False),), dtype_name="bfloat16")
    params = transformer.init_lm(trandom.PRNGKey(1, device="cuda"), base)
    raw = torch.from_numpy(np.random.default_rng(4).integers(
        0, base.vocab, (4, 65)).astype(np.int32)).cuda()
    batch = {"tokens": raw[:, :-1], "labels": raw[:, 1:]}

    def loss_and_grads(cfg):
        wrt = tree_map(lambda x: x.detach().requires_grad_(), params)
        losses, _ = transformer.per_example_loss(wrt, cfg, batch)
        loss = torch.sum(losses)
        return loss, torch.autograd.grad(loss, tree_leaves(wrt))

    torch.use_deterministic_algorithms(True)
    try:
        ref_loss, ref_grads = loss_and_grads(base)
        for policy in ("full", "dots"):
            loss, grads = loss_and_grads(base.replace(remat=True,
                                                      remat_policy=policy))
            assert torch.equal(loss, ref_loss)
            assert all(torch.equal(g, r) for g, r in zip(grads, ref_grads))
    finally:
        torch.use_deterministic_algorithms(False)


def test_two_ranks_on_the_card(card, tmp_path):
    """Two ranks (``repro_torch.launch.distributed.launch_simulated`` of
    ``tests/torch_dist_worker.py``), sharing one card over gloo, or a
    card each over NCCL where the machine has two, run the launcher's
    quadratic job through K1 and K2: ``gather`` and the cells axis bit
    for bit the same study in this process, ``psum`` and ``fused``
    within ``rtol=1e-5, atol=1e-6``; each rank's shard of a ragged
    buffer held against the plain versions, the last shard (every row
    masked, NaN) exact zeros; one compile per structure group per rank
    and a K1 or K2 launch a step of every cell, in the first run and
    the warm repeat of each combination."""
    from repro_torch.launch import distributed as dist

    worker = str(Path(__file__).resolve().parent / "torch_dist_worker.py")
    ops.load()  # the ranks load the library built here
    dist.launch_simulated(2, command=[sys.executable, worker], argv=[
        "--mesh", "clients,cells", "--reduction", "gather,psum,fused",
        "--steps", "12", "--check-masked-shard", "--no-extra",
        "--out", str(tmp_path)], timeout=300)
    got = dict(np.load(tmp_path / "results.npz"))
    want = dist.flatten_results("ref", dist.reference_results(
        12, 2, device="cuda"))
    for key, value in got.items():
        tag, cell, field = key.split("|")
        ref_value = want[f"ref|{cell}|{field}"]
        if tag in ("cells", "clients-gather") or field in (
                "participation", "finite", "diverged"):
            np.testing.assert_array_equal(value, ref_value, err_msg=key)
        else:
            np.testing.assert_allclose(value, ref_value, rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    reports = [json.loads((tmp_path / f"report_p{r}.json").read_text())
               for r in range(2)]
    extras = [json.loads((tmp_path / f"extra_p{r}.json").read_text())
              for r in range(2)]
    shared = torch.cuda.device_count() < 2
    backend = "gloo" if shared else "nccl"
    assert [r["backend"] for r in reports] == [backend, backend]
    assert all(r["shared_card"] == shared for r in reports)
    last = extras[1]["masked_shard"]
    assert last["active_rows"] == 0 and last["local_zero"]
    # (gather + psum) on 8 cells, and fused on 8 plus the cells mesh's
    # 4, each run twice for 12 steps.
    want_launches = {"masked_scaled_aggregate": 2 * 12 * (8 + 8),
                     "masked_scaled_aggregate_update": 2 * 12 * (8 + 4)}
    for rep, extra in zip(reports, extras):
        assert extra["masked_shard"]["k1_err"] <= 1e-6
        assert extra["masked_shard"]["k2_err"] <= 1e-6
        assert extra["launches"] == want_launches
        for tag, combo in rep["combos"].items():
            assert combo["compiles"] == 2 and combo["warm_new_compiles"] == 0
        assert rep["combos"]["cells"]["params_sha256"] == \
            reports[0]["combos"]["cells"]["params_sha256"]


def test_expert_parallel_prefill_on_the_card(card, tmp_path):
    """A reduced phi3.5-moe (2 MoE layers, 4 experts top-2, bf16, K3) on 2
    ranks at ``(data 1, model 2)``, each drawing its 2 experts a layer
    (``init_lm(..., mesh=)``), prefill and 2 greedy steps on all 4 rows:
    K3 once a layer a rank, the routing of every token the one-rank
    prefill's in this process bit for bit, the logits within
    ``2**-7·max|one rank|`` (K3's bf16 tolerance) of it, both ranks
    alike."""
    from repro_torch.launch import distributed as dist

    worker = str(Path(__file__).resolve().parent / "torch_moe_worker.py")
    fa_ops.load()  # the ranks load the library built here
    arch = "phi3.5-moe-42b-a6.6b"
    kw = {"superblock": [["attn_moe", 2, False]], "use_flash": True,
          "dtype_name": "bfloat16"}
    cfg = get_config(arch).reduced().replace(
        **dict(kw, superblock=(("attn_moe", 2, False),)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 64)).astype(
        np.int32)
    (tmp_path / "in").mkdir()
    (tmp_path / "out").mkdir()
    np.savez(tmp_path / "in" / "inputs.npz", **{"model/phi35/tokens": toks})
    (tmp_path / "in" / "cases.json").write_text(json.dumps({
        "layer": [], "refuse": [], "model": [{
            "name": "phi35", "arch": arch, "cfg": kw, "mesh": [1, 2],
            "steps": 2, "init": 0}]}))
    dist.launch_simulated(2, command=[sys.executable, worker], argv=[
        str(tmp_path / "in"), str(tmp_path / "out"), "cuda"], timeout=300)
    ranks = [dict(np.load(tmp_path / "out" / f"ep_p{r}.npz"))
             for r in range(2)]
    params = transformer.init_lm(trandom.PRNGKey(0, device="cuda"), cfg)
    moe.routing_log = []
    try:
        with torch.no_grad():
            want = make_prefill_step(cfg)(
                params, {"tokens": torch.from_numpy(toks).cuda()})
        log = moe.routing_log
    finally:
        moe.routing_log = None
    want = want.float().cpu().numpy()
    assert len(log) == 2
    for res in ranks:
        assert int(res["phi35|launches"]) == 2
        for i, (top_e, keep) in enumerate(log):
            np.testing.assert_array_equal(res[f"phi35|prefill_top_e{i}"],
                                          top_e.cpu().numpy())
            np.testing.assert_array_equal(res[f"phi35|prefill_keep{i}"],
                                          keep.cpu().numpy())
        assert np.abs(res["phi35|prefill"] - want).max() <= \
            2 ** -7 * np.abs(want).max()
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
