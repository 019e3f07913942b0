"""Loss trajectories of the LM train driver at several adamw step sizes.

Runs :func:`repro_torch.launch.train.main` (stablelm-1.6b by default,
full width; alg1 on periodic arrivals over 8 clients) once per
``--lrs`` value from the same seed, and prints each run's per-step loss
and ms a step (host clock after a synchronise; the first step includes
the warm-up). It shows where the driver's default step size stops
lowering the loss over a short run at this width. It runs on the CUDA
card, and raises when there is none, unless ``--device cpu`` is given:

    PYTHONPATH=src python -m benchmarks_torch.train_lr
    PYTHONPATH=src python -m benchmarks_torch.train_lr --device cpu \\
        --reduced --seq-len 32 --global-batch 8
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lrs", default="3e-4,1e-4,3e-5")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--n-clients", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if device.type == "cuda":
        print(f"# train_lr on {torch.cuda.get_device_name(device)}")
    rows = {}
    for lr in (float(x) for x in args.lrs.split(",")):
        stamps = [time.perf_counter()]

        def on_step(step, state, metrics):
            sync()
            stamps.append(time.perf_counter())

        argv_lr = ["--arch", args.arch, "--steps", str(args.steps),
                   "--global-batch", str(args.global_batch),
                   "--seq-len", str(args.seq_len),
                   "--n-clients", str(args.n_clients), "--scheduler", "alg1",
                   "--arrivals", "periodic", "--lr", str(lr),
                   "--log-every", str(args.steps), "--device", str(device)]
        if args.reduced:
            argv_lr.append("--reduced")
        losses = train_mod.main(argv_lr, on_step=on_step)
        ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        rows[lr] = losses
        print(f"train_lr lr={lr:g}: losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; last {'below' if losses[-1] < losses[0] else 'above'} "
              f"first; ms/step " + " ".join(f"{m:.0f}" for m in ms))
    return rows


if __name__ == "__main__":
    main()
