"""Quickstart on the port: energy-harvesting distributed SGD.

The torch counterpart of ``examples/quickstart.py``. Builds the paper's
setting on a closed-form quadratic: 8 clients with heterogeneous
periodic energy (τ cycling through 1/5/10/20), and compares Algorithm 1
against the paper's two benchmarks and the full-participation oracle.
The whole grid is the registered ``fig1`` study of
:mod:`repro_torch.experiments`, run through the aggregate kernels
(``use_kernel=True``: K2 on the card, its plain version on the CPU). It
runs on the CUDA card, and raises when there is none, unless
``--device cpu`` is given:

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch._device import resolve_device
from repro_torch.core import make_quadratic
from repro_torch.experiments import get_study, resolve_taus_profile
from repro_torch.optim import sgd

N_CLIENTS, DIM, ETA = 8, 10, 0.01


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=1000,
                    help="steps a run (t=1000 as in paper Fig. 1)")
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    problem = make_quadratic(trandom.PRNGKey(0, device=device), N_CLIENTS,
                             dim=DIM, hetero=1.0)
    # The paper's 4 methods on periodic (eq. 37) arrivals: the registered
    # "fig1" study (scheduler axis × fixed arrivals × seeds).
    study = get_study("fig1", n_clients=N_CLIENTS, num_steps=args.steps,
                      seeds=args.seeds)
    taus = resolve_taus_profile("paper", N_CLIENTS)
    print(f"{N_CLIENTS} clients, energy periods {[int(t) for t in taus]}, "
          f"{args.seeds} seeds, {args.steps} steps on {device}")

    def grads_fn(params, key, t):
        return problem.all_grads(params, key=key, noise=0.05)

    t0 = time.perf_counter()
    results = study.run(grads_fn=grads_fn, p=problem.p, optimizer=sgd(ETA),
                        loss_fn=problem.suboptimality, use_kernel=True,
                        params0=torch.full((DIM,), 5.0, device=device),
                        device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    # NaN-aware mean±std over the seed axis — one diverged seed would be
    # reported as n_nan, not averaged into the stats.
    tail = min(100, args.steps)
    metric = lambda c: c.history.loss[:, -tail:].mean(dim=-1)
    summary = results.reduce(metric=metric)
    print(f"{'scenario':<22} {'final subopt':>22} {'mean weight Σω':>16}")
    finals = {}
    for name, cell in results.items():
        s = summary[name]
        finals[results.labels(name)["scheduler"]] = s["mean"]
        print(f"{name:<22} {s['mean']:>13.5f} ± {s['std']:<7.5f}"
              f"{float(cell.history.weight_sum.mean()):>16.3f}")
    n_steps = len(results) * args.seeds * args.steps
    print(f"{n_steps} steps in {wall:.2f} s ({wall / n_steps * 1e3:.3f} "
          f"ms/step, synchronised)")

    assert finals["alg1"] < finals["benchmark1"], "Alg1 must beat B1"
    assert finals["alg1"] < finals["benchmark2"], "Alg1 must beat B2"
    print("\nAlgorithm 1 (unbiased energy-aware) beats both benchmarks ✓")

    # Axis selection: the alg1 row only, as plain records.
    for rec in results.sel(scheduler="alg1").to_records(metric=metric):
        print(f"sel(scheduler='alg1') -> {rec['name']}: "
              f"{rec['mean']:.5f} ± {rec['std']:.5f} "
              f"({rec['n_seeds']} seeds, {rec['n_nan']} diverged)")
    return finals


if __name__ == "__main__":
    main()
