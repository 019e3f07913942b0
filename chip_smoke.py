#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero
without printing its result line:

1. Card check: a CUDA device is required; prints ``nvidia-smi``'s name
   and power limit.
2. Build: compiles the aggregate kernels (``csrc/aggregate.cu``) with
   nvcc and prints the seconds it took.
3. Kernel phase, at the Fig-1 shape (N = 40 clients, P = 316,554 CNN
   parameters) and at a ragged P = 2,049: K1 (dense; masked with inf/NaN
   rows; bf16 gradients into f32) and K2 (update f32; update of bf16
   params; delta) against their plain PyTorch versions on the card,
   K2 against K1 → update bitwise, masked rows exact zeros. Times K1 and
   K2 at the Fig-1 shape with CUDA events over 60 launches, the L2 cache
   flushed before each (and back to back), beside the plain versions,
   the one PyTorch call that computes the same function, and the bound.
4. Slice phase: the paper's Fig-1 training loop at full width through
   ``ClientSimulator`` with ``use_kernel=True``: alg1, benchmark1,
   benchmark2 and oracle with sgd(0.05) (kernel K2), alg1 with momentum
   (kernel K1), and both again with 4 of the 40 clients masked out (the
   masked bodies). 40 steps each, evaluated every 20. The launch counts
   are set to 0 before these runs and must equal the steps that used
   each kernel. Then alg1/sgd runs once more through the plain torch
   matvec (``use_kernel=False``) as the reference the kernel run must
   agree with, and a last run under ``torch.profiler`` prints where a
   step's device time goes and the device's busy share.
5. Prints the ``kernels`` JSON line, then the result line.

Tolerances: f32 kernels against the plain versions rtol=atol=1e-6 (the
client sum runs in another order; weights at the trainer's scale, Σω≈1);
bf16 gradients into f32 1e-5; a bf16 result within one bf16 rounding
step (relative 2**-8). TF32 is off for matmuls and convolutions, so the
reference run is full f32.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SOURCE = "src/repro_torch/kernels/aggregate/csrc/aggregate.cu"
N_CLIENTS, N_GROUPS, BATCH, LR = 40, 4, 16, 0.05
N_TRAIN, N_TEST = 8000, 800
STEPS, EVAL_EVERY, REF_STEPS, PROFILE_STEPS = 40, 20, 3, 10
TIMED_LAUNCHES = 60
# Peak rates of the H100 SXM (NVIDIA data sheet): HBM bytes/s and f32
# (non-tensor-core) flop/s. torch names that card "NVIDIA H100 80GB HBM3".
H100_SXM = "H100 80GB HBM3"
H100_SXM_PEAKS = (3.35e12, 67e12)


def card_peaks(name):
    if H100_SXM not in name:
        raise RuntimeError(f"no peak rates known for {name!r}: the bound is "
                           f"stated for the H100 SXM ({H100_SXM}) only")
    return H100_SXM_PEAKS


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, flush):
    """Mean ms per call over TIMED_LAUNCHES calls: (flushed, warm). The
    flushed figure zeroes a 256 MB buffer before each call so no input
    is left in the 50 MB L2; the warm figure runs the calls back to
    back."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_LAUNCHES):
        fn()
    end.record()
    torch.cuda.synchronize()
    flushed = sum(s.elapsed_time(e) for s, e in pairs) / TIMED_LAUNCHES
    return flushed, start.elapsed_time(end) / TIMED_LAUNCHES


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
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=DEVICE)
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


def slice_phase(torch, rt):
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
        print(f"slice {label:<22} test acc {acc[0]:.3f} -> {acc[-1]:.3f}  "
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
    print(f"slice reference: {REF_STEPS} alg1 steps through the kernels and "
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
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(key, params0, PROFILE_STEPS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernel rows only: an operator's row repeats its kernels' time.
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r[1] for r in rows)
    print(f"profile: {PROFILE_STEPS} alg1/sgd steps, wall "
          f"{wall_us / PROFILE_STEPS / 1e3:.2f} ms/step, device busy "
          f"{busy_us / PROFILE_STEPS / 1e3:.2f} ms/step "
          f"({100 * busy_us / wall_us:.1f} % of wall), "
          f"{sum(r[2] for r in rows) / PROFILE_STEPS:.0f} device ops/step")
    ranked = sorted(rows, key=lambda r: -r[1])
    for name, us, count in ranked[:10] + [r for r in ranked[10:]
                                          if "aggregate" in r[0]]:
        print(f"profile:   {100 * us / max(busy_us, 1e-9):5.1f} %  "
              f"{us / PROFILE_STEPS:9.1f} us/step  x{count / PROFILE_STEPS:<6.1f} "
              f"{name[:90]}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    import repro_torch.core
    import repro_torch.data
    import repro_torch.kernels.aggregate
    import repro_torch.models
    import repro_torch.optim
    import repro_torch.random
    from repro_torch.kernels.aggregate import ops, ref

    # Full f32 everywhere: no TF32 in matmuls or cuDNN convolutions, so
    # the kernel path and the matvec reference differ only in the order
    # of the client sum.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}; "
          f"peaks used for the bound: {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.0f} TFLOP/s f32")

    t0 = time.perf_counter()
    ops.load()
    print(f"build: aggregate kernels in {time.perf_counter() - t0:.1f} s")

    errs, timing = kernel_phase(torch, ops, ref, peaks)
    launches = slice_phase(torch, rt)

    names = {"k1": ("masked_scaled_aggregate",
                    "src/repro/kernels/aggregate/aggregate.py:77"),
             "k2": ("masked_scaled_aggregate_update",
                    "src/repro/kernels/aggregate/aggregate.py:128")}
    kernels = []
    for key, (name, replaces) in names.items():
        t = timing[key]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[key], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "warm_ms": t["warm_ms"],
            "plain_warm_ms": t["plain_warm_ms"],
            "library_warm_ms": t["library_warm_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
