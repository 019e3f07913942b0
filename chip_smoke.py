#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero
without printing its result line:

1. Card check: a CUDA device is required; prints ``nvidia-smi``'s name
   and power limit.
2. Build: compiles the aggregate kernels (``csrc/aggregate.cu``), the
   flash-attention kernel (``csrc/flash_attention.cu``) and the scan
   kernel (``csrc/gla_scan.cu``) with nvcc, one process for each source,
   all at once, and prints the seconds. For K3 it prints ptxas's
   registers and spills of the bf16 kernels and fails on a spill or a
   setmaxnreg or wgmma-serialisation warning (C7508, C7520), and counts
   their HGMMA and UTMALDG instructions in the SASS (cuobjdump), which
   must not be 0. For K4 it prints, for each kernel the K4 main path
   instantiates (the scores and walk kernels at both shapes, chunk 64),
   ptxas's registers and spills, the walk's tiling and dynamic shared
   memory, and the HMMA (tensor-core) instructions in its SASS; it fails
   on a spill or a kernel without HMMA.
3. Kernel phase, at the Fig-1 shape (N = 40 clients, P = 316,554 CNN
   parameters) and at a ragged P = 2,049: K1 (dense; masked with inf/NaN
   rows; bf16 gradients into f32) and K2 (update f32; update of bf16
   params; delta) against their plain PyTorch versions on the card,
   K2 against K1 → update bitwise, masked rows exact zeros. Prints the
   kernels' geometry at the Fig-1 shape: blocks (one a SM), the span of
   P a block owns, rows a stage, stages, and the bytes in flight a SM.
   Times K1 and K2 at the Fig-1 shape with CUDA events over 60 launches,
   the L2 cache flushed before each by a pass that reads a 256 MB
   buffer through (it leaves the L2 holding clean lines of that buffer
   and none of the inputs), and back to back, beside the plain versions,
   the one PyTorch call that computes the same function, and the bound.
   K3 and K4 are timed the same way.
4. Fig-1 phase: the paper's Fig-1 training loop at full width through
   ``ClientSimulator`` with ``use_kernel=True``: alg1, benchmark1,
   benchmark2 and oracle with sgd(0.05) (kernel K2), alg1 with momentum
   (kernel K1), and both again with 4 of the 40 clients masked out (the
   masked bodies). 40 steps each, evaluated every 20. The launch counts
   are set to 0 before these runs and must equal the steps that used
   each kernel. Then alg1/sgd runs once more through the plain torch
   matvec (``use_kernel=False``) as the reference the kernel run must
   agree with, and a last run under ``torch.profiler`` prints where a
   step's device time goes and the device's busy share.
5. Engine phase: the experiments engine (``repro_torch.experiments``)
   at the Fig-1 width, with the Fig-1 phase's data and batcher, through
   the kernels (``use_kernel=True``) under deterministic cuDNN. The
   ``fig1`` study (4 cells x seeds 1 and 2 x 40 steps, evaluated every
   20): K2 must launch once a step of every cell and seed, every cell
   must stay finite, and the alg1 cell's seed 1 must equal a standalone
   ``ClientSimulator.run`` of that cell bit for bit (participation,
   parameters, evaluations). The ``population_scaling`` study at
   n = 10, 20, 40 in a capacity of 40 (one ragged structure group, one
   seed): K2 launches counted, participation cropped to (steps, n), and
   the n = 10 cell rerun uncropped, where clients 10..39 must never take
   part and clients 0..9 must equal the engine's cell. One alg1 cell
   with momentum: K1 once a step. The counts are set to 0 before each
   study. Prints each study's cells, seeds, steps, wall seconds and
   ms/step, beside the standalone run's ms/step.
6. K3 phase: the flash-attention kernel against its plain version
   computed in f32 from the same inputs, at the prefill shape of the LM
   phase (B = 8, H = 32, S = T = 2,048, Dh = 64, causal, bf16),
   minitron-4b's attention at the same B and S (H = 24, Hkv = 8,
   Dh = 128, causal: the GQA shape of the later models), GQA 24/8 with
   Dh = 128, a 512 window, bidirectional f32, ragged S = T = 1,000, and
   S = 100 against T = 40 with a 16 window (rows that see no key must be
   exact zeros). Times K3 at the first two shapes, flushed and warm,
   beside the plain version, ``F.scaled_dot_product_attention`` and the
   bound, with the achieved TFLOP/s, the share of the bound, and the
   time the exponentials take at the MUFU rate (one ex2 per visible
   score, 16 a clock per SM at the card's top SM clock).
7. K4 phase: the gated-linear-recurrence scan through
   ``repro_torch.kernels.ssm_scan.gla_scan`` at the full width of the two
   layers it serves, B = 8 × S = 2,048, chunk 64: zamba2-2.7b's Mamba2
   layer (H = 80, dk = dv = 64; a and v f32, k and q bf16, one row a
   position broadcast over the heads with stride 0, as the block makes
   them) and
   xlstm-1.3b's mLSTM layer (H = 4, dk = 1,024, dv = 1,025; f32). The
   K4 count is set to 0 before these two calls and must be 2 after. Both
   outputs, a ragged S = 2,000, small decays (a log-uniform down to 1e-6,
   with exact zeros for the 1e-12 clamp) and chunk 32 against chunk 64
   are held against the plain sequential version on the card. Times K4
   at both shapes, flushed and warm, beside the plain version, the port's
   ``chunked_gla`` (the nearest comparator: no single PyTorch call
   computes this function) and the bound of the route the kernel takes:
   the larger of the bytes and 3 x the operations at the TF32 tensor-core
   rate (3xTF32). The line also prints the bound at the f32 rate, the
   count earlier runs report; the ``kernels`` line holds the route's.
8. LM phase: stablelm-1.6b at full width (24 layers, d_model 2048, 32
   heads of 64, d_ff 5632, vocab 100352, bf16; random weights from a
   seed). Three prefills of B = 8 × S = 2,048 through
   ``make_prefill_step`` with ``use_flash=True``: the K3 count is set to
   0 before them and must be 24 × 3 after. Then the same prefill with
   plain attention (bf16) and with the weights upcast to f32 and plain
   attention (the reference): flash's last-position logits must lie
   within 2× the plain bf16 prefill's distance from the reference (the
   floor), and flash's argmax must equal the reference's on every row
   whose top-two gap exceeds 2× the floor. Then decode at B = 8 through
   ``make_serve_step``: a 448-token prompt fed token by token into a
   512-slot cache, its logits at position 447 held against the f32
   reference prefill of those 448 tokens by the same rule, and 64
   greedy steps. ``torch.profiler`` over one prefill and one decode
   step, and the peak device memory.
9. Prints the ``kernels`` JSON line (K1 and K2 also carry the engine
   phase's counts, ``engine_launches``), then the result line.

Tolerances: f32 aggregate kernels against the plain versions
rtol=atol=1e-6 (the client sum runs in another order; weights at the
trainer's scale, Σω≈1); bf16 gradients into f32 1e-5; a bf16 result
within one bf16 rounding step (relative 2**-8). K3 in bf16:
max|K3 − plain_f32| ≤ 2**-7 · max|plain_f32| (two bf16 roundings: p for
the tensor-core product, and the output); K3 in f32 rtol=atol=1e-5.
K4 (f32 arithmetic on any mix of f32 and bf16 inputs, the same inputs
for both sides): max|K4 − plain| ≤ 1e-4 · max|plain|, chunk 32 against
chunk 64 likewise.
TF32 is off for matmuls and convolutions, so every reference is full
f32.
"""

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SOURCE = "src/repro_torch/kernels/aggregate/csrc/aggregate.cu"
K3_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
K4_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/gla_scan.cu"
N_CLIENTS, N_GROUPS, BATCH, LR = 40, 4, 16, 0.05
N_TRAIN, N_TEST = 8000, 800
STEPS, EVAL_EVERY, REF_STEPS, PROFILE_STEPS = 40, 20, 3, 10
# Engine phase: the seeds of the fig1 study, the populations of the
# population_scaling study (at the Fig-1 capacity of 40 clients).
ENGINE_SEEDS, POPULATIONS = (1, 2), (10, 20, 40)
TIMED_LAUNCHES = 60
# LM phase: batch, prefill length, prefills counted, decode prompt,
# cache slots and greedy steps.
LM_BATCH, LM_SEQ, LM_PREFILLS = 8, 2048, 3
LM_PROMPT, LM_CACHE, LM_GREEDY = 448, 512, 64
LM_PARAMS = 1_644_883_968
# Peak rates of the H100 SXM (NVIDIA data sheet): HBM bytes/s, f32
# (non-tensor-core) flop/s, dense bf16 and dense TF32 tensor-core flop/s.
# torch names that card "NVIDIA H100 80GB HBM3".
H100_SXM = "H100 80GB HBM3"
H100_SXM_PEAKS = (3.35e12, 67e12, 989e12, 495e12)


def card_peaks(name):
    if H100_SXM not in name:
        raise RuntimeError(f"no peak rates known for {name!r}: the bound is "
                           f"stated for the H100 SXM ({H100_SXM}) only")
    return H100_SXM_PEAKS


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def flush_buffer(torch):
    """The 256 MB buffer ``time_ms`` reads through, written once."""
    return torch.zeros(64 * 2 ** 20, dtype=torch.float32, device=DEVICE)


def time_ms(torch, fn, flush, n=TIMED_LAUNCHES):
    """Mean ms per call over ``n`` calls: (flushed, warm). The flushed
    figure reads the 256 MB ``flush`` buffer through (its sum into a
    scalar) before each call, so the 50 MB L2 holds none of the inputs,
    only clean lines of the buffer: a pass that wrote it would leave up
    to 50 MB of dirty lines for the timed call to write back. The warm
    figure runs the calls back to back."""
    sink = torch.empty((), dtype=torch.float32, device=DEVICE)
    for _ in range(min(3, n)):
        fn()
    pairs = []
    for _ in range(n):
        torch.sum(flush, dim=0, out=sink)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    flushed = sum(s.elapsed_time(e) for s, e in pairs) / n
    return flushed, start.elapsed_time(end) / n


def profile(torch, label, unit, fn, n_units, keep=None):
    """Print ``torch.profiler``'s view of ``fn`` (``n_units`` steps or
    prefills): wall and device-busy time per unit, the device's busy
    share of the wall time, and the top kernels by device time (plus any
    kernel whose name holds ``keep``)."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernel rows only: an operator's row repeats its kernels' time.
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r[1] for r in rows)
    check(busy_us > 0, f"profile {label}: the profiler saw no device time")
    print(f"profile {label}: wall {wall_us / n_units / 1e3:.2f} ms/{unit}, "
          f"device busy {busy_us / n_units / 1e3:.2f} ms/{unit} "
          f"({100 * busy_us / wall_us:.1f} % of wall), "
          f"{sum(r[2] for r in rows) / n_units:.0f} device ops/{unit}")
    ranked = sorted(rows, key=lambda r: -r[1])
    for name, us, count in ranked[:8] + [r for r in ranked[8:]
                                         if keep and keep in r[0]]:
        print(f"profile {label}:   {100 * us / busy_us:5.1f} %  "
              f"{us / n_units:9.1f} us/{unit}  x{count / n_units:<6.1f} "
              f"{name[:90]}")


def kernel_phase(torch, ops, ref, peaks):
    """Correctness at both shapes; timings at the Fig-1 shape."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    eta = torch.tensor(LR, device=DEVICE)
    errs = {"k1": 0.0, "k2": 0.0}
    timing = {}
    for n, p in ((N_CLIENTS, 316_554), (N_CLIENTS, 2_049)):
        g = torch.randn(n, p, device=DEVICE, generator=gen)
        w = torch.rand(n, device=DEVICE, generator=gen) * (2.0 / n)
        mask = (torch.arange(n, device=DEVICE) % 7 != 3).float()
        params = torch.randn(p, device=DEVICE, generator=gen)
        poisoned = g.clone()
        poisoned[mask == 0] = float("inf")
        poisoned[3] = float("nan")
        clean = torch.where(mask[:, None] > 0, g, 0.0)

        def close(name, got, want, tol):
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            errs[name] = max(errs[name], (got - want).abs().max().item())

        k1 = ops.masked_scaled_aggregate(g, w)
        close("k1", k1, ref.masked_scaled_aggregate_ref(g, w), 1e-6)
        k1m = ops.masked_scaled_aggregate(poisoned, w, mask=mask)
        check(torch.equal(k1m, ops.masked_scaled_aggregate(clean, w, mask=mask)),
              "K1: masked inf/NaN rows must contribute exact zeros")
        close("k1", k1m, ref.masked_scaled_aggregate_ref(clean, w, mask), 1e-6)
        gb = g.to(torch.bfloat16)
        torch.testing.assert_close(
            ops.masked_scaled_aggregate(gb, w, out_dtype=torch.float32),
            ref.masked_scaled_aggregate_ref(gb, w, None, torch.float32),
            rtol=1e-5, atol=1e-5)

        for m, gg, k1_ in ((None, g, k1), (mask, poisoned, k1m)):
            k2 = ops.masked_scaled_aggregate_update(gg, w, eta, params, m)
            cl = g if m is None else clean
            close("k2", k2, ref.masked_scaled_aggregate_update_ref(
                cl, w, eta, params, m), 1e-6)
            check(torch.equal(k2, params + (-eta * k1_)),
                  "K2 must equal K1 followed by params + (-eta * agg), bitwise")
            delta = ops.masked_scaled_aggregate_update(gg, w, eta, None, m)
            close("k2", delta, ref.masked_scaled_aggregate_update_ref(
                cl, w, eta, None, m), 1e-6)
            check(torch.isfinite(k2).all(), "K2 output not finite")
        pb = params.to(torch.bfloat16)
        torch.testing.assert_close(
            ops.masked_scaled_aggregate_update(g, w, eta, pb).float(),
            ref.masked_scaled_aggregate_update_ref(g, w, eta, pb).float(),
            rtol=2 ** -8, atol=1e-6)
        torch.cuda.synchronize()
        print(f"kernel phase N={n} P={p}: K1 and K2 agree "
              f"(max abs err K1 {errs['k1']:.3g}, K2 {errs['k2']:.3g})")
        if p != 316_554:
            continue
        geo = ops.geometry(p, g.element_size(), ops.sm_count(g.device.index),
                           g.data_ptr())
        ring = geo.stages * geo.rows * geo.pitch
        print(f"k1/k2 geometry at N={n} P={p} f32: {geo.blocks} blocks (one "
              f"a SM), span {geo.span} columns ({geo.span * 4} B of a row) "
              f"in chunks of {geo.chunk}, {geo.rows} rows a stage x "
              f"{geo.stages} stages of {geo.rows * geo.pitch} B: {ring} B "
              f"({ring / 1024:.1f} KB) in flight a SM")
        flush = flush_buffer(torch)
        # The first timing of the script: half a second of flush passes
        # first, so the card's clocks are up from the build's idle.
        for _ in range(5000):
            torch.sum(flush, dim=0)
        gt = g.t()
        calls = {
            "k1": (lambda: ops.masked_scaled_aggregate(g, w),
                   lambda: ref.masked_scaled_aggregate_ref(g, w),
                   lambda: torch.mv(gt, w)),
            "k2": (lambda: ops.masked_scaled_aggregate_update(g, w, eta, params),
                   lambda: ref.masked_scaled_aggregate_update_ref(g, w, eta, params),
                   lambda: torch.addmv(params, gt, w, alpha=-LR)),
        }
        # Bytes each function must move (inputs read once, output written
        # once) and the flops it does; f32 throughout.
        work = {"k1": (4 * (n * p + n + p), 2 * n * p),
                "k2": (4 * (n * p + n + 1 + 2 * p), 2 * n * p + 2 * p)}
        for name, fns in calls.items():
            t = [time_ms(torch, fn, flush) for fn in fns]
            nbytes, flops = work[name]
            bound_b = nbytes / peaks[0] * 1e3
            bound_f = flops / peaks[1] * 1e3
            timing[name] = {
                "ms": t[0][0], "plain_ms": t[1][0], "library_ms": t[2][0],
                "warm_ms": t[0][1], "plain_warm_ms": t[1][1],
                "library_warm_ms": t[2][1],
                "bound_ms": max(bound_b, bound_f),
                "bound_by": "bytes" if bound_b >= bound_f else "operations"}
            print(f"time {name} (L2 flushed | warm, ms): kernel "
                  f"{t[0][0]:.4f} | {t[0][1]:.4f}, plain {t[1][0]:.4f} | "
                  f"{t[1][1]:.4f}, library {t[2][0]:.4f} | {t[2][1]:.4f}, "
                  f"bound {timing[name]['bound_ms']:.4f} "
                  f"({nbytes / 1e6:.2f} MB; "
                  f"{nbytes / t[0][0] / 1e6:.0f} GB/s achieved flushed)")
    return errs, timing


def fig1_phase(torch, rt):
    """The Fig-1 loop at full width, through the kernels."""
    seed = 0
    ds = rt.data.make_confusable_image_classification(
        seed, N_TRAIN + N_TEST, image_shape=(32, 32, 3), similarity=0.9,
        noise=0.8)
    train_x, train_y = ds.images[:N_TRAIN], ds.labels[:N_TRAIN]
    test_x = torch.from_numpy(ds.images[N_TRAIN:]).to(DEVICE)
    test_y = torch.from_numpy(ds.labels[N_TRAIN:]).to(DEVICE)
    parts = rt.data.group_label_skew_partition(seed, train_y, N_CLIENTS,
                                               N_GROUPS, skew=1.0)
    batcher = rt.data.ClientBatcher(
        [{"x": train_x[ix], "y": train_y[ix]} for ix in parts], BATCH,
        seed=seed, device=DEVICE)
    params0 = rt.models.init_cnn(rt.random.PRNGKey(seed, device=DEVICE),
                                 image_hw=32)
    n_params = rt.core.ravel_spec(params0).total
    check(n_params == 316_554, f"CNN has {n_params} parameters")
    arrivals = rt.core.make_arrivals("periodic", N_CLIENTS, STEPS)

    def evaluate(p):
        return {"accuracy": rt.models.cnn_accuracy(p, test_x, test_y),
                "loss": rt.models.cnn_loss(p, test_x, test_y)}

    def run(method, opt, use_kernel=True, active=None, steps=STEPS):
        sim = rt.core.ClientSimulator(
            grads_fn=rt.models.client_grads_fn(batcher), p=batcher.p,
            optimizer=opt(), scheduler=rt.core.make_scheduler(method, N_CLIENTS),
            energy=arrivals, use_kernel=use_kernel, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, hist, evals = sim.run(
            rt.random.PRNGKey(seed + 1, device=DEVICE), params0, steps,
            active_mask=active, eval_fn=evaluate,
            eval_every=EVAL_EVERY if steps % EVAL_EVERY == 0 else steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        flat = rt.core.ravel_pytree(params)
        check(bool(torch.isfinite(flat).all()) and bool(hist.finite.all()),
              f"{method}: parameters not finite")
        check(hist.participation.shape == (steps, N_CLIENTS), "history shape")
        return flat, hist, evals, ms

    sgd = lambda: rt.optim.sgd(LR)
    # Momentum 0.9 at the same effective step size η/(1−β) as sgd.
    momentum = lambda: rt.optim.momentum(LR * 0.1, beta=0.9)
    run("alg1", sgd, steps=2)        # warm-up: cuDNN and vmap set-up
    run("alg1", momentum, steps=2)
    counts = rt.kernels.aggregate.ops.launch_counts
    rt.kernels.aggregate.ops.reset_launch_counts()
    active = torch.ones(N_CLIENTS, device=DEVICE)
    active[[3, 13, 22, 31]] = 0.0
    expected = {"masked_scaled_aggregate": 0, "masked_scaled_aggregate_update": 0}
    for label, method, opt, act, kernel in (
            ("alg1", "alg1", sgd, None, "masked_scaled_aggregate_update"),
            ("benchmark1", "benchmark1", sgd, None,
             "masked_scaled_aggregate_update"),
            ("benchmark2", "benchmark2", sgd, None,
             "masked_scaled_aggregate_update"),
            ("oracle", "oracle", sgd, None,
             "masked_scaled_aggregate_update"),
            ("alg1+momentum", "alg1", momentum, None,
             "masked_scaled_aggregate"),
            ("alg1 masked", "alg1", sgd, active,
             "masked_scaled_aggregate_update"),
            ("alg1+momentum masked", "alg1", momentum, active,
             "masked_scaled_aggregate")):
        flat, hist, evals, ms = run(method, opt, active=act)
        expected[kernel] += STEPS
        check(counts == expected,
              f"{label}: launch counts {counts}, expected {expected}")
        if act is not None:
            check(not bool(hist.participation[:, act == 0].any()),
                  f"{label}: a masked-out client took part")
        acc = evals["accuracy"].tolist()
        loss = evals["loss"].tolist()
        print(f"fig-1 {label:<22} test acc {acc[0]:.3f} -> {acc[-1]:.3f}  "
              f"test loss {loss[0]:.4f} -> {loss[-1]:.4f}  "
              f"mean participation {hist.participation.mean().item():.3f}  "
              f"{ms:.2f} ms/step")
    launches = dict(counts)

    # Reference: a short alg1/sgd run through the kernels and through the
    # plain torch matvec, with deterministic cuDNN so the two differ only
    # in the order of the client sum (over 40 steps at this step size
    # that difference grows chaotically, so the comparison is short).
    torch.backends.cudnn.deterministic = True
    flat_k, hist_k, _, _ = run("alg1", sgd, steps=REF_STEPS)
    flat_k2, _, _, _ = run("alg1", sgd, steps=REF_STEPS)
    flat_ref, hist_ref, _, _ = run("alg1", sgd, use_kernel=False,
                                   steps=REF_STEPS)
    torch.backends.cudnn.deterministic = False
    check(torch.equal(flat_k, flat_k2),
          "two kernel runs from one seed differ: the step is not deterministic")
    check(torch.equal(hist_k.participation, hist_ref.participation),
          "participation differs between the kernel and the matvec path")
    torch.testing.assert_close(flat_k, flat_ref, rtol=1e-4, atol=1e-5)
    print(f"fig-1 reference: {REF_STEPS} alg1 steps through the kernels and "
          f"through the torch matvec agree, max abs param diff "
          f"{(flat_k - flat_ref).abs().max().item():.3g}")

    # Where a step's time goes: torch.profiler over PROFILE_STEPS alg1/sgd
    # steps (no evaluation), kernels by device time, and the device's
    # busy share of the wall time.
    sim = rt.core.ClientSimulator(
        grads_fn=rt.models.client_grads_fn(batcher), p=batcher.p,
        optimizer=sgd(), scheduler=rt.core.make_scheduler("alg1", N_CLIENTS),
        energy=arrivals, use_kernel=True, device=DEVICE)
    key = rt.random.PRNGKey(seed + 1, device=DEVICE)
    sim.run(key, params0, 2)
    profile(torch, f"fig-1 ({PROFILE_STEPS} alg1/sgd steps)", "step",
            lambda: sim.run(key, params0, PROFILE_STEPS), PROFILE_STEPS,
            "aggregate")
    data = {"batcher": batcher, "params0": params0,
            "accuracy": lambda p: rt.models.cnn_accuracy(p, test_x, test_y)}
    return launches, data


def engine_phase(torch, rt, data):
    """The experiments engine at Fig-1 width, through the kernels: the
    ``fig1`` study against a standalone run, ``population_scaling`` with
    its padding, and one momentum cell. Returns the launch counts of
    each study's run."""
    from repro_torch._tree import tree_map

    rx = rt.experiments
    ops = rt.kernels.aggregate.ops
    batcher, params0, accuracy = data["batcher"], data["params0"], data["accuracy"]
    kw = dict(grads_fn=rt.models.client_grads_fn(batcher), p=batcher.p,
              optimizer=rt.optim.sgd(LR), use_kernel=True, device=DEVICE)
    config = rx.ExecutionConfig(eval_fn=accuracy, eval_every=EVAL_EVERY)
    flat = rt.core.ravel_pytree
    counts = {}

    def timed(label, fn, expect):
        """Run ``fn`` with the counts set to 0 before it; check and keep
        the counts read after it; return its result and wall seconds."""
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts[label] = dict(ops.launch_counts)
        check(counts[label] == expect,
              f"engine {label}: launch counts {counts[label]}, expected {expect}")
        return out, seconds

    def finite(label, result):
        for name, cell in result.items():
            check(bool(torch.isfinite(flat(cell.params)).all())
                  and bool(cell.history.finite.all())
                  and cell.diverged.tolist() == [-1] * len(cell.diverged),
                  f"engine {label}: cell {name} not finite")

    # Deterministic cuDNN, so that a cell of the study and a standalone
    # run of it may be held bit for bit.
    torch.backends.cudnn.deterministic = True
    study = rx.get_study("fig1", n_clients=N_CLIENTS, num_steps=STEPS,
                         taus_profile=[1, 5, 10, 20], seeds=list(ENGINE_SEEDS))
    n_runs = len(study.resolve()) * len(ENGINE_SEEDS)
    result, wall = timed("fig1", lambda: study.run(
        params0=params0, config=config, **kw),
        {"masked_scaled_aggregate": 0,
         "masked_scaled_aggregate_update": n_runs * STEPS})
    finite("fig1", result)
    sim = study.simulator(**kw)
    (alg1,) = [sc for sc in study.resolve() if sc.scheduler == "alg1"]
    scheduler, energy = alg1.build()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, hist, evals = sim.run(
        rt.random.PRNGKey(ENGINE_SEEDS[0], device=DEVICE), params0, STEPS,
        scheduler=scheduler, energy=energy, eval_fn=accuracy,
        eval_every=EVAL_EVERY)
    torch.cuda.synchronize()
    alone_ms = (time.perf_counter() - t0) / STEPS * 1e3
    cell = result[alg1.name]
    check(torch.equal(cell.history.participation[0], hist.participation)
          and torch.equal(flat(tree_map(lambda x: x[0], cell.params)),
                          flat(params))
          and torch.equal(cell.evals[0], evals),
          "engine fig1: the alg1 cell's seed differs from a standalone run")
    accs = " ".join(f"{name} {cell.evals[:, -1].mean().item():.3f}"
                    for name, cell in result.items())
    print(f"engine fig1 study: {len(result)} cells x {len(ENGINE_SEEDS)} "
          f"seeds x {STEPS} steps in {wall:.2f} s, "
          f"{wall / (n_runs * STEPS) * 1e3:.2f} ms/step with evaluation "
          f"(standalone alg1 run {alone_ms:.2f} ms/step); "
          f"{counts['fig1']['masked_scaled_aggregate_update']} K2 launches; "
          f"the alg1 cell's seed {ENGINE_SEEDS[0]} equals the standalone run "
          f"bit for bit (participation, {flat(params).numel():,} params, "
          f"evals); final test acc: {accs}")

    pop = rx.get_study("population_scaling", n_clients=POPULATIONS,
                       num_steps=STEPS, seeds=[ENGINE_SEEDS[0]])
    result, wall = timed("population_scaling", lambda: pop.run(
        params0=params0, **kw),
        {"masked_scaled_aggregate": 0,
         "masked_scaled_aggregate_update": len(POPULATIONS) * STEPS})
    finite("population_scaling", result)
    for n, cell in zip(POPULATIONS, result.values()):
        check(tuple(cell.history.participation.shape) == (1, STEPS, n),
              f"engine population_scaling n={n}: participation shape "
              f"{tuple(cell.history.participation.shape)}")
    # The smallest cell again, uncropped: its absent rows never took part.
    groups = rx.resolve_structure_groups(pop.resolve(), sim=sim)[2]
    grp = groups[0]
    check(len(groups) == 1 and grp.ragged, "population_scaling: one ragged group")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = sim.run(rt.random.PRNGKey(ENGINE_SEEDS[0], device=DEVICE),
                      params0, STEPS, scheduler=grp.scheduler[0],
                      energy=grp.energy[0], p=grp.p[0], active_mask=grp.active[0])
    torch.cuda.synchronize()
    padded_ms = (time.perf_counter() - t0) / STEPS * 1e3
    n0 = POPULATIONS[0]
    first = next(iter(result.values()))
    check(not bool(hist.participation[:, n0:].any()),
          f"population_scaling n={n0}: an absent client took part")
    check(torch.equal(hist.participation[:, :n0], first.history.participation[0]),
          f"population_scaling n={n0}: the engine's cell differs from a "
          f"standalone padded run")
    rates = " ".join(f"n={n} {c.history.participation.mean().item():.3f}"
                     for n, c in zip(POPULATIONS, result.values()))
    print(f"engine population_scaling study: n = {POPULATIONS} at N_cap "
          f"{N_CLIENTS}, 1 seed x {STEPS} steps in {wall:.2f} s, "
          f"{wall / (len(POPULATIONS) * STEPS) * 1e3:.2f} ms/step (standalone "
          f"padded n={n0} run {padded_ms:.2f} ms/step); "
          f"{counts['population_scaling']['masked_scaled_aggregate_update']} "
          f"K2 launches; participation cropped to (steps, n); the n={n0} "
          f"cell uncropped: rows {n0}..{N_CLIENTS - 1} never took part, rows "
          f"0..{n0 - 1} equal the engine's; mean participation {rates}")

    one = rx.Study("alg1_momentum", num_steps=STEPS, axes={
        "scheduler": "alg1", "arrivals": "periodic", "n_clients": N_CLIENTS,
        "taus_profile": [1, 5, 10, 20], "seeds": [ENGINE_SEEDS[0]]})
    result, wall = timed("momentum", lambda: one.run(
        params0=params0, **dict(kw, optimizer=rt.optim.momentum(LR * 0.1, beta=0.9))),
        {"masked_scaled_aggregate": STEPS, "masked_scaled_aggregate_update": 0})
    finite("momentum", result)
    torch.backends.cudnn.deterministic = False
    print(f"engine momentum cell: 1 cell x 1 seed x {STEPS} steps in "
          f"{wall:.2f} s, {wall / STEPS * 1e3:.2f} ms/step; "
          f"{counts['momentum']['masked_scaled_aggregate']} K1 launches")
    return counts


K3_CASES = (  # label, (B, H, Hkv, S, T, Dh), causal, window, dtype name
    ("prefill shape", (LM_BATCH, 32, 32, LM_SEQ, LM_SEQ, 64), True, 0, "bfloat16"),
    # src/repro/configs/minitron_4b.py: 24 query heads over 8 kv heads of 128.
    ("minitron-4b", (LM_BATCH, 24, 8, LM_SEQ, LM_SEQ, 128), True, 0, "bfloat16"),
    ("GQA 24/8 Dh=128", (2, 24, 8, 1024, 1024, 128), True, 0, "bfloat16"),
    ("window 512", (2, 32, 32, 2048, 2048, 64), True, 512, "bfloat16"),
    ("bidirectional f32", (2, 8, 8, 512, 512, 64), False, 0, "float32"),
    ("ragged S=T=1000", (2, 32, 32, 1000, 1000, 64), True, 0, "bfloat16"),
    ("rows with no key", (2, 4, 2, 100, 40, 64), False, 16, "bfloat16"),
)
K3_TIMED = ("prefill shape", "minitron-4b")
# MUFU ex2 results a clock per SM on compute capability 9.0 (CUDA C++
# programming guide, arithmetic instruction throughput).
MUFU_PER_CLOCK = 16


def build_report(build, source):
    """ptxas's report of each kernel in the library of ``source`` as
    {mangled name: [spill line, registers line]}, and its SASS as
    {mangled name: body}."""
    funcs, name = {}, None
    for line in build.build_log(source).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            funcs[name] = [line.strip()]
        elif name and "Used" in line and "registers" in line:
            funcs[name].append(line.split(":", 1)[1].strip())
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    bodies = {b.split("\n", 1)[0].strip(): b for b in sass.split("Function : ")[1:]}
    return funcs, bodies


def k3_build_report(build, fa_ops):
    """ptxas's registers and spills and the SASS's HGMMA and UTMALDG
    counts of the bf16 K3 kernels; fails on a spill, a C7508 (setmaxnreg
    ignored) or C7520 (wgmma serialised) warning, or a kernel without
    wgmma or TMA."""
    log = build.build_log(fa_ops.SOURCE)
    for code in ("C7508", "C7520"):
        check(code not in log, f"K3 build: ptxas warns {code}:\n{log}")
    funcs, bodies = build_report(build, fa_ops.SOURCE)
    for dh in (64, 128):
        tag = f"flash_attention_bf16ILi{dh}E"
        fn = next(f for f in funcs if tag in f)
        body = next(b for n, b in bodies.items() if tag in n)
        spills, regs = funcs[fn]
        counts = {op: body.count(op) for op in ("HGMMA", "UTMALDG", "USETMAXREG")}
        check(spills.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
              f"K3 bf16 Dh={dh} spills: {spills}")
        check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
              f"K3 bf16 Dh={dh}: SASS without wgmma or TMA {counts}")
        print(f"k3 build: bf16 Dh={dh}: ptxas {regs} (entry count; setmaxnreg "
              f"moves consumers to 232), {spills}; SASS {counts}")


def k3_phase(torch, fa_ops, fa_ref, peaks, sm_clock_hz):
    """K3 against its plain version (in f32, same inputs) at every case;
    timings at the shapes of K3_TIMED."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    max_err = 0.0
    timing = {}
    for label, (b, h, hkv, s, t, dh), causal, window, dt in K3_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn(b, s, h, dh, device=DEVICE, generator=gen).to(dtype)
        k = torch.randn(b, t, hkv, dh, device=DEVICE, generator=gen).to(dtype)
        v = torch.randn(b, t, hkv, dh, device=DEVICE, generator=gen).to(dtype)
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        want = fa_ref.flash_attention_ref(
            q.float().transpose(1, 2), k.float().transpose(1, 2),
            v.float().transpose(1, 2), causal=causal,
            window=window).transpose(1, 2)
        torch.cuda.synchronize()
        check(out.dtype == dtype and out.shape == q.shape,
              f"K3 {label}: output {out.dtype} {tuple(out.shape)}")
        err = (out.float() - want).abs().max().item()
        max_err = max(max_err, err)
        if dtype == torch.float32:
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
            how = "rtol=atol=1e-05"
        else:
            bound = 2 ** -7 * want.abs().max().item()
            check(err <= bound, f"K3 {label}: max abs err {err:.4g} above "
                  f"the bf16 bound {bound:.4g}")
            how = f"{err / bound:.3f} of the bf16 bound"
        dead = ~fa_ref.visible_mask(s, t, causal=causal, window=window,
                                    device=DEVICE).any(dim=1)
        if dead.any():
            check(bool((out[:, dead] == 0).all()),
                  f"K3 {label}: rows with no key are not exact zeros")
            how += f", {int(dead.sum())} rows with no key exact zeros"
        print(f"k3 phase {label:<18} B,H,Hkv,S,T,Dh={(b, h, hkv, s, t, dh)} "
              f"causal={causal} window={window} {dt}: agrees "
              f"(max abs err {err:.3g}, {how})")
        if label not in K3_TIMED:
            continue
        del want
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        flush = flush_buffer(torch)
        fns = (lambda: fa_ops.flash_attention(q, k, v, causal=True),
               lambda: fa_ref.flash_attention_ref(qt, kt, vt, causal=True),
               lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=hkv != h))
        with torch.no_grad():
            times = [time_ms(torch, fn, flush) for fn in fns]
        # The work this run's inputs need: the two products and one
        # exponential over the visible (query, key) pairs only, and q, k,
        # v, out moved once.
        pairs = int(fa_ref.visible_mask(s, t, causal=True, window=0,
                                        device=DEVICE).sum())
        flops = 4 * b * h * dh * pairs
        nbytes = 2 * (2 * b * s * h * dh + 2 * b * t * hkv * dh)
        bound_f, bound_b = flops / peaks[2] * 1e3, nbytes / peaks[0] * 1e3
        exp_ms = b * h * pairs / (MUFU_PER_CLOCK * n_sm * sm_clock_hz) * 1e3
        tflops = flops / times[0][0] / 1e9
        timing[label] = {
            "ms": times[0][0], "plain_ms": times[1][0],
            "library_ms": times[2][0], "warm_ms": times[0][1],
            "plain_warm_ms": times[1][1], "library_warm_ms": times[2][1],
            "bound_ms": max(bound_f, bound_b),
            "bound_by": "operations" if bound_f >= bound_b else "bytes",
            "shape": {"B": b, "H": h, "Hkv": hkv, "S": s, "T": t, "Dh": dh,
                      "causal": True}}
        print(f"time k3 {label} (L2 flushed | warm, ms): kernel "
              f"{times[0][0]:.4f} | {times[0][1]:.4f}, plain {times[1][0]:.4f} "
              f"| {times[1][1]:.4f}, library (F.scaled_dot_product_attention) "
              f"{times[2][0]:.4f} | {times[2][1]:.4f}, bound "
              f"{timing[label]['bound_ms']:.4f} ({flops / 1e9:.1f} GFLOP bf16, "
              f"{nbytes / 1e6:.0f} MB); {tflops:.1f} TFLOP/s achieved flushed, "
              f"{100 * timing[label]['bound_ms'] / times[0][0]:.1f} % of the "
              f"bound; {b * h * pairs / 1e6:.0f} M exponentials take "
              f"{exp_ms:.4f} ms at the MUFU rate ({MUFU_PER_CLOCK} a clock x "
              f"{n_sm} SMs x {sm_clock_hz / 1e6:.0f} MHz) beside the "
              f"tensor-core bound {bound_f:.4f} ms")
        del q, k, v, out, flush
    print(f"k3 phase: largest abs error {max_err:.4g}")
    return max_err, timing


K4_CASES = (  # label, (B, S, H, dk, dv), dtypes of a, k, v, q, shared k/q
    # zamba2-2.7b's Mamba2 layer (d_model 2560, expand 2, head_dim 64):
    # 80 heads, dk = d_state = 64, dv = head_dim = 64; a and v f32, k and
    # q bf16, one B/C row a position broadcast over the 80 heads (stride
    # 0), as the JAX block's _mamba2_preact feeds the scan.
    ("zamba2-2.7b mamba2", (LM_BATCH, LM_SEQ, 80, 64, 64),
     ("float32", "bfloat16", "float32", "bfloat16"), True),
    # xlstm-1.3b's mLSTM layer: d_inner 4096 over 4 heads, dk = 1024 and
    # dv = 1025 (v carries the normaliser column); all f32, k and q per head.
    ("xlstm-1.3b mlstm", (LM_BATCH, LM_SEQ, 4, 1024, 1025), ("float32",) * 4,
     False),
)
K4_CHUNK, K4_TOL = 64, 1e-4


def k4_build_report(torch, build, ssm_ops):
    """For each K4 kernel the main path instantiates (the scores kernel
    and the walk at each K4_CASES shape, chunk 64): ptxas's registers and
    spills, the walk's tiling and dynamic shared memory, and the HMMA
    (tensor-core) instructions of its SASS; fails on a spill or a kernel
    without HMMA."""
    funcs, bodies = build_report(build, ssm_ops.SOURCE)
    for label, (_, _, _, dk, _), dtypes, _ in K4_CASES:
        cfg = ssm_ops.kernel_config(dk, [getattr(torch, d) for d in dtypes], K4_CHUNK)
        exact = int(dtypes[1] == dtypes[3] == "bfloat16")
        mt = cfg["columns"] // 16
        nr = cfg["warps"] // mt
        tags = {"scores": f"gla_scoresILi{K4_CHUNK}ELb{exact}E",
                "walk": f"gla_walkILi{K4_CHUNK}ELi{mt}ELi{nr}E"
                        f"Li{cfg['dk_step'] // (8 * nr)}ELi{cfg['cluster']}ELb{exact}E"}
        for kind, tag in tags.items():
            fn = next(f for f in funcs if tag in f)
            body = next(b for n, b in bodies.items() if tag in n)
            spills, regs = funcs[fn]
            hmma = body.count("HMMA")
            check("0 bytes spill stores, 0 bytes spill loads" in spills,
                  f"K4 {kind} at {label} spills: {spills}")
            check(hmma > 0, f"K4 {kind} at {label}: SASS without HMMA")
            tiling = (f"{cfg['columns']} state columns a block, {cfg['warps']} "
                      f"warps, dk in steps of {cfg['dk_step']}, split over "
                      f"{cfg['cluster']} block(s) of a cluster, "
                      f"{cfg['walk_smem']} B dynamic shared memory"
                      if kind == "walk" else
                      f"{cfg['scores_smem']} B dynamic shared memory")
            print(f"k4 build: {kind} kernel for {label}: ptxas {regs}, {spills}; "
                  f"{tiling}; SASS HMMA {hmma}, LDGSTS {body.count('LDGSTS')}")


def k4_inputs(torch, gen, shape, dtypes, shared_kq, small_decay=False):
    """a in [0.6, 1] (or log-uniform in [1e-6, 1] with every 61st position
    exactly 0); k and q N(0, 1/dk); v N(0, 1); each in its dtype. With
    ``shared_kq`` k and q hold one row a position, expanded over the heads
    (stride 0)."""
    b, s, h, dk, dv = shape
    kq_heads = 1 if shared_kq else h
    u = torch.rand(b, s, h, device=DEVICE, generator=gen)
    if small_decay:
        a = torch.exp(u * torch.log(torch.tensor(1e-6)))
        a[:, ::61] = 0.0
    else:
        a = 0.6 + 0.4 * u
    k = torch.randn(b, s, kq_heads, dk, device=DEVICE, generator=gen) * dk ** -0.5
    q = torch.randn(b, s, kq_heads, dk, device=DEVICE, generator=gen) * dk ** -0.5
    v = torch.randn(b, s, h, dv, device=DEVICE, generator=gen)
    a, k, v, q = (x.to(getattr(torch, dt)) for x, dt in zip((a, k, v, q), dtypes))
    return a, k.expand(b, s, h, dk), v, q.expand(b, s, h, dk)


def k4_work(x):
    """Operations and bytes of one scan at chunk 64: the four products,
    the two intra-chunk ones over the causal half of each chunk. Where k
    and q are both shared by the heads (stride 0) their dot products are
    counted once a batch row, since only the decay differs by head. Each
    operand is read once, a broadcast axis as one copy, and y written once
    in f32."""
    a, k, v, q = x
    b, s, h = a.shape
    dk, dv = k.shape[-1], v.shape[-1]
    full, rest = divmod(s, K4_CHUNK)
    pairs = full * K4_CHUNK * (K4_CHUNK + 1) // 2 + rest * (rest + 1) // 2
    qk_heads = 1 if k.stride(2) == 0 and q.stride(2) == 0 else h
    flops = b * (2 * pairs * (qk_heads * dk + h * dv) + 4 * h * s * dk * dv)
    stored = lambda t: t.element_size() * math.prod(
        n for n, st in zip(t.shape, t.stride()) if st)
    nbytes = sum(stored(t) for t in x) + 4 * b * s * h * dv
    return flops, nbytes


def k4_phase(torch, ssm_ops, ssm_ref, chunked_gla, peaks):
    """K4 through ``gla_scan`` at both full-width shapes (the counted main
    path), the extra cases against the plain version, and the timings."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    max_err = 0.0

    def plain(a, k, v, q):
        b, s, h = a.shape
        fold = lambda x: x.transpose(1, 2).reshape((b * h, s) + x.shape[3:])
        y = ssm_ref.gla_scan_ref(fold(a), fold(k), fold(v), fold(q))
        return y.reshape(b, h, s, v.shape[-1]).transpose(1, 2)

    def held(label, x, y, want=None):
        nonlocal max_err
        want = plain(*x) if want is None else want
        torch.cuda.synchronize()
        check(y.dtype == torch.float32 and y.shape == x[2].shape,
              f"K4 {label}: output {y.dtype} {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), f"K4 {label}: output not finite")
        err = (y - want).abs().max().item()
        top = want.abs().max().item()
        check(err <= K4_TOL * top, f"K4 {label}: max abs err {err:.4g} above "
              f"{K4_TOL} x max|plain| {top:.4g}")
        max_err = max(max_err, err)
        b, s, h, dk = x[1].shape
        shared = ", k/q shared by the heads" if x[1].stride(2) == 0 else ""
        print(f"k4 phase {label:<22} B,S,H,dk,dv={(b, s, h, dk, x[2].shape[-1])} "
              f"{'/'.join(str(t.dtype)[6:] for t in x)}{shared}: agrees (max abs err "
              f"{err:.3g}, {err / top:.3g} of max|plain| {top:.3g})")
        return want

    inputs = [k4_inputs(torch, gen, shape, dts, shared)
              for _, shape, dts, shared in K4_CASES]
    torch.cuda.synchronize()
    # The main path: one scan at each shape, counted.
    ssm_ops.reset_launch_counts()
    outs = [ssm_ops.gla_scan(*x, chunk=K4_CHUNK) for x in inputs]
    torch.cuda.synchronize()
    launches = ssm_ops.launch_counts["gla_scan"]
    check(launches == len(K4_CASES),
          f"K4 launches {launches}, expected {len(K4_CASES)}")
    print(f"k4 main path: {launches} K4 launches for the {len(K4_CASES)} "
          f"full-width scans")
    for (label, *_), x, y in zip(K4_CASES, inputs, outs):
        held(label, x, y)
    del outs

    zamba, xlstm = K4_CASES[0][2:], K4_CASES[1][2:]
    x = k4_inputs(torch, gen, (2, 2000, 80, 64, 64), *zamba)
    held("ragged S=2000", x, ssm_ops.gla_scan(*x, chunk=K4_CHUNK))
    x = k4_inputs(torch, gen, (2, 1024, 80, 64, 64), *zamba, small_decay=True)
    held("small decay", x, ssm_ops.gla_scan(*x, chunk=K4_CHUNK))
    x = k4_inputs(torch, gen, (1, 512, 4, 1024, 1025), *xlstm)
    y64 = ssm_ops.gla_scan(*x, chunk=64)
    want = held("chunk 64", x, y64)
    y32 = ssm_ops.gla_scan(*x, chunk=32)
    held("chunk 32", x, y32, want)
    diff = (y32 - y64).abs().max().item()
    check(diff <= K4_TOL * want.abs().max().item(),
          f"K4 chunk 32 against chunk 64: {diff:.4g}")
    print(f"k4 phase chunk invariance: chunk 32 against chunk 64 max abs "
          f"diff {diff:.3g}")
    del x, want, y32, y64

    flush = flush_buffer(torch)
    timing = {}
    for (label, *_), x in zip(K4_CASES, inputs):
        fns = (lambda: ssm_ops.gla_scan(*x, chunk=K4_CHUNK),
               lambda: plain(*x),
               lambda: chunked_gla(*x, chunk=K4_CHUNK))
        with torch.no_grad():
            times = [time_ms(torch, fn, flush, n)
                     for fn, n in zip(fns, (TIMED_LAUNCHES, 2, 10))]
        flops, nbytes = k4_work(x)
        bound_b = nbytes / peaks[0] * 1e3
        # The route taken: every product on the TF32 tensor cores as
        # 3xTF32. The f32 count is printed too, as earlier runs report it.
        bound_f, bound_f32 = 3 * flops / peaks[3] * 1e3, flops / peaks[1] * 1e3
        timing[label] = {
            "ms": times[0][0], "warm_ms": times[0][1],
            "plain_ms": times[1][0], "plain_warm_ms": times[1][1],
            "comparator_ms": times[2][0], "comparator_warm_ms": times[2][1],
            "bound_ms": max(bound_f, bound_b),
            "bound_by": "operations" if bound_f >= bound_b else "bytes"}
        print(f"time k4 {label} (L2 flushed | warm, ms): kernel "
              f"{times[0][0]:.4f} | {times[0][1]:.4f}, plain {times[1][0]:.2f} "
              f"| {times[1][1]:.2f}, nearest comparator (chunked_gla) "
              f"{times[2][0]:.4f} | {times[2][1]:.4f}, library call none, "
              f"bound {timing[label]['bound_ms']:.4f} "
              f"({timing[label]['bound_by']}: 3 x {flops / 1e9:.1f} GFLOP at "
              f"the TF32 rate, {nbytes / 1e6:.0f} MB; "
              f"{100 * timing[label]['bound_ms'] / times[0][0]:.1f} % of it "
              f"reached flushed; {flops / times[0][0] / 1e9:.2f} TFLOP/s "
              f"achieved), bound at the f32 rate {max(bound_f32, bound_b):.4f}")
    del inputs, flush
    torch.cuda.empty_cache()
    print(f"k4 phase: largest abs error {max_err:.4g}")
    return launches, max_err, timing


def lm_phase(torch, rt, fa_ops):
    """stablelm-1.6b at full width: flash prefill through K3, the f32
    reference, decode through the KV cache, the profile."""
    from repro_torch._tree import tree_map
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer

    cfg = rt.configs.get_config("stablelm-1.6b").replace(use_flash=True)
    plain_cfg = cfg.replace(use_flash=False)
    ref_cfg = plain_cfg.replace(dtype_name="float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = transformer.init_lm(rt.random.PRNGKey(0, device=DEVICE), cfg)
    torch.cuda.synchronize()
    n_params = rt.models.count_params(params)
    check(n_params == LM_PARAMS, f"stablelm-1.6b has {n_params} parameters")
    check(params["stack"]["seg0"]["attn"]["wq"]["w"].shape
          == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)
          and params["embed"]["w"].dtype == torch.bfloat16,
          "stablelm-1.6b parameter layout")
    print(f"lm init: {cfg.name} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"{n_params:,} parameters "
          f"({2 * n_params / 1e9:.2f} GB bf16) in "
          f"{time.perf_counter() - t0:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    data = rt.data.make_lm_tokens(0, LM_BATCH, LM_SEQ, cfg.vocab).tokens
    tokens = torch.from_numpy(data[:, :LM_SEQ]).to(DEVICE)
    prompt = tokens[:, :LM_PROMPT]
    prefill = make_prefill_step(cfg)
    plain = make_prefill_step(plain_cfg)
    reference = make_prefill_step(ref_cfg)

    def dist(a, b):
        return (a.float() - b.float()).abs().max().item()

    def argmax_agrees(got, ref, floor):
        top2 = ref.float().topk(2, dim=-1).values
        rows = (top2[:, 0] - top2[:, 1]) > 2 * floor
        same = got.float().argmax(-1) == ref.float().argmax(-1)
        return bool(same[rows].all()), int(rows.sum())

    # The main path: the counted flash prefills.
    fa_ops.reset_launch_counts()
    ms = []
    with torch.no_grad():
        for _ in range(LM_PREFILLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flash = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    launches = fa_ops.launch_counts["flash_attention"]
    check(launches == cfg.n_layers * LM_PREFILLS,
          f"K3 launches {launches}, expected {cfg.n_layers} x {LM_PREFILLS}")
    check(flash.shape == (LM_BATCH, cfg.vocab) and bool(torch.isfinite(flash).all()),
          "flash prefill logits not finite or of the wrong shape")
    print(f"lm prefill (use_flash, K3): B={LM_BATCH} S={LM_SEQ}: "
          + " ".join(f"{m:.2f}" for m in ms) + f" ms per prefill, "
          f"{LM_BATCH * LM_SEQ / min(ms) * 1e3:,.0f} tokens/s (best), "
          f"{launches} K3 launches in {LM_PREFILLS} prefills")

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_logits = plain(params, {"tokens": tokens})
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        params32 = tree_map(lambda x: x.float(), params)
        ref_logits = reference(params32, {"tokens": tokens})
        ref_prompt = reference(params32, {"tokens": prompt})
        plain_prompt = plain(params, {"tokens": prompt})
        del params32
    torch.cuda.empty_cache()
    floor = dist(plain_logits, ref_logits)
    err = dist(flash, ref_logits)
    agree, rows = argmax_agrees(flash, ref_logits, floor)
    check(err <= 2 * floor, f"flash prefill {err:.4g} from the f32 reference, "
          f"above 2x the bf16 floor {floor:.4g}")
    check(agree, "flash prefill argmax differs from the f32 reference on a "
          "row whose top-two gap exceeds 2x the floor")
    print(f"lm reference: plain-attention bf16 prefill {plain_ms:.2f} ms; "
          f"last-position logits (max |logit| {ref_logits.abs().max().item():.3g}) "
          f"from the f32 reference: plain bf16 {floor:.4g} (the floor), "
          f"flash {err:.4g} (<= 2x floor); argmax agrees on all {rows} of "
          f"{LM_BATCH} rows whose top-two gap exceeds 2x the floor")

    serve = make_serve_step(cfg)
    cache_len = transformer.decode_cache_len(cfg, LM_CACHE)
    states = transformer.init_decode_state(cfg, LM_BATCH, cache_len,
                                           device=DEVICE)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(LM_PROMPT):
            nxt, logits, states = serve(params, prompt[:, pos:pos + 1],
                                        states, pos)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) / LM_PROMPT * 1e3
    floor_p = dist(plain_prompt, ref_prompt)
    err_p = dist(logits, ref_prompt)
    agree, rows = argmax_agrees(logits, ref_prompt, floor_p)
    check(err_p <= 2 * floor_p, f"decode at position {LM_PROMPT - 1}: "
          f"{err_p:.4g} from the f32 reference, above 2x the floor {floor_p:.4g}")
    check(agree, "decode argmax differs from the f32 reference on a row "
          "whose top-two gap exceeds 2x the floor")
    print(f"lm decode replay: {LM_PROMPT} prompt tokens one at a time through "
          f"make_serve_step (cache {cache_len}), {replay_ms:.2f} ms/step; "
          f"logits at position {LM_PROMPT - 1} from the f32 reference prefill "
          f"of those tokens {err_p:.4g} (<= 2x the floor {floor_p:.4g}); "
          f"argmax agrees on all {rows} rows above 2x the floor")

    tok = nxt[:, None]
    first = []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(LM_PROMPT, LM_PROMPT + LM_GREEDY):
            nxt, logits, states = serve(params, tok, states, pos)
            tok = nxt[:, None]
            first.append(nxt)
        torch.cuda.synchronize()
        greedy_ms = (time.perf_counter() - t0) / LM_GREEDY * 1e3
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    print(f"lm decode: {LM_GREEDY} greedy steps at positions {LM_PROMPT}.."
          f"{LM_PROMPT + LM_GREEDY - 1}, {greedy_ms:.2f} ms/step "
          f"({LM_BATCH * 1e3 / greedy_ms:.0f} tokens/s); tokens of row 0: "
          f"{[int(t[0]) for t in first[:8]]}")

    with torch.no_grad():
        profile(torch, "prefill", "prefill",
                lambda: prefill(params, {"tokens": tokens}), 1,
                "flash_attention")
        profile(torch, "decode", "step",
                lambda: serve(params, tok, states, LM_PROMPT + LM_GREEDY - 1), 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"lm phase: peak device memory {peak:.2f} GB")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    import repro_torch.configs
    import repro_torch.core
    import repro_torch.data
    import repro_torch.experiments
    import repro_torch.kernels.aggregate
    import repro_torch.models
    import repro_torch.optim
    import repro_torch.random
    from repro_torch.kernels import _build
    from repro_torch.kernels.aggregate import ops, ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref
    from repro_torch.models.ssm import chunked_gla

    # Full f32 everywhere: no TF32 in matmuls or cuDNN convolutions, so
    # the kernel path and the matvec reference differ only in the order
    # of the client sum, and the LM reference prefill is full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    sm_clock_hz = float(clock.stdout.strip().splitlines()[0]) * 1e6
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}; "
          f"peaks used for the bound: {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.0f} TFLOP/s f32, {peaks[2] / 1e12:.0f} TFLOP/s "
          f"bf16, {peaks[3] / 1e12:.0f} TFLOP/s TF32")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        for f in [pool.submit(m.load) for m in (ops, fa_ops, ssm_ops)]:
            f.result()
    print(f"build: aggregate, flash-attention and scan kernels in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc process for each "
          f"source, all at once)")
    k3_build_report(_build, fa_ops)
    k4_build_report(torch, _build, ssm_ops)

    errs, timing = kernel_phase(torch, ops, ref, peaks)
    launches, fig1_data = fig1_phase(torch, rt)
    engine_counts = engine_phase(torch, rt, fig1_data)
    del fig1_data
    k3_err, k3_timing = k3_phase(torch, fa_ops, fa_ref, peaks, sm_clock_hz)
    launches["gla_scan"], k4_err, k4_timing = k4_phase(
        torch, ssm_ops, ssm_ref, chunked_gla, peaks)
    launches["flash_attention"] = lm_phase(torch, rt, fa_ops)

    names = {"k1": ("masked_scaled_aggregate", SOURCE,
                    "src/repro/kernels/aggregate/aggregate.py:77"),
             "k2": ("masked_scaled_aggregate_update", SOURCE,
                    "src/repro/kernels/aggregate/aggregate.py:128"),
             "k3": ("flash_attention", K3_SOURCE,
                    "src/repro/kernels/flash_attention/flash_attention.py:95")}
    # K3's main path is the stablelm prefill, so its line carries the
    # prefill shape's numbers; each timed shape's own follow.
    timing["k3"] = k3_timing["prefill shape"]
    errs["k3"] = k3_err
    kernels = []
    for key, (name, source, replaces) in names.items():
        t = timing[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[key], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "warm_ms": t["warm_ms"],
            "plain_warm_ms": t["plain_warm_ms"],
            "library_warm_ms": t["library_warm_ms"]})
        if key in ("k1", "k2"):
            # The engine phase's runs, each counted from 0.
            kernels[-1]["engine_launches"] = {
                label: c[name] for label, c in engine_counts.items()}
        if key == "k3":
            kernels[-1]["shapes"] = k3_timing
    # K4's main path is one scan at each of two shapes: its times and bound
    # are the sums over both, and each shape's own numbers follow.
    total = lambda key: sum(t[key] for t in k4_timing.values())
    kernels.append({
        "name": "gla_scan", "route": "cuda", "source": K4_SOURCE,
        "replaces": "src/repro/kernels/ssm_scan/ssm_scan.py:65",
        "launches": launches["gla_scan"], "max_abs_err": k4_err,
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"), "bound_by": max(
            k4_timing.values(), key=lambda t: t["bound_ms"])["bound_by"],
        "library_ms": None, "warm_ms": total("warm_ms"),
        "plain_warm_ms": total("plain_warm_ms"),
        "comparator": "repro_torch.models.ssm.chunked_gla",
        "comparator_ms": total("comparator_ms"),
        "comparator_warm_ms": total("comparator_warm_ms"),
        "shapes": k4_timing})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
