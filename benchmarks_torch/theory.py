"""Benchmark: Theorem 1 on the port — empirical suboptimality vs the
analytic bound, at three step sizes (Remark 1's ηLC/(2μ) floor).

The torch counterpart of ``benchmarks/theory.py``, with the same rows
(``empirical``, ``bound``, ``holds``). Each step size's seed batch runs
through the port's scenario engine as a single-cell
:class:`repro_torch.experiments.Study` through the aggregate kernels
(``use_kernel=True``: K2 on the card), and the empirical floor is the
NaN-aware mean±std across seeds (:meth:`GridResult.reduce`). It runs on
the CUDA card, and raises when there is none, unless ``--device cpu``
is given:

    PYTHONPATH=src python -m benchmarks_torch.theory [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import random as trandom
from repro_torch._device import resolve_device
from repro_torch.core import (
    make_quadratic,
    max_step_size,
    theorem1_bound,
    variance_constant,
)
from repro_torch.experiments import Study, clear_cache
from repro_torch.optim import sgd

TAUS = (1, 5, 10, 20)
SEEDS = 8
STEPS = 2000
FRACS = (0.1, 0.25, 0.5)
N_CLIENTS, DIM = 8, 8


def measure(device=None, *, problem=None, steps: int = STEPS,
            seeds=SEEDS) -> list[dict]:
    """One record a step size: ``frac`` (of η_max), ``eta``,
    ``empirical`` / ``empirical_std`` / ``seeds`` / ``n_nan`` (the final
    100 steps' mean suboptimality across seeds), ``bound`` (Theorem 1 at
    ``steps``), ``holds`` and ``seconds`` (wall clock since the start,
    synchronised). ``problem`` defaults to the bench's quadratic,
    ``make_quadratic(PRNGKey(3), 8, dim=8, hetero=0.5)`` on ``device``."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    if problem is None:
        problem = make_quadratic(trandom.PRNGKey(3, device=device),
                                 N_CLIENTS, dim=DIM, hetero=0.5)
    n, dim = problem.n_clients, problem.dim
    taus = [TAUS[i % 4] for i in range(n)]
    study = Study("theorem1", num_steps=steps, axes={
        "scheduler": "alg1", "arrivals": "periodic", "n_clients": n,
        "taus_profile": taus, "seeds": seeds})

    eta_max = max_step_size(problem.mu, problem.lsmooth)
    radius = float(torch.linalg.norm(problem.w_star)) + 10.0
    g2 = problem.grad_second_moment_bound(radius)
    c = float(variance_constant(problem.p.cpu(), torch.tensor(taus), g2))
    w0 = torch.full((dim,), 5.0, device=device)
    f0 = float(problem.suboptimality(w0))
    grads_fn = lambda p, k, t: problem.all_grads(p)

    records = []
    for frac in FRACS:
        eta = frac * eta_max
        results = study.run(
            grads_fn=grads_fn, p=problem.p, optimizer=sgd(eta),
            loss_fn=problem.suboptimality, params0=w0, use_kernel=True,
            device=device)
        stats = results.reduce(
            metric=lambda cell: cell.history.loss[:, -100:].mean(dim=-1))
        s = stats["alg1_periodic"]
        bound = float(theorem1_bound(steps, f0, problem.mu, problem.lsmooth,
                                     eta, c))
        if device.type == "cuda":
            torch.cuda.synchronize()
        records.append({
            "frac": frac, "eta": eta, "empirical": s["mean"],
            "empirical_std": s["std"], "seeds": s["n_seeds"],
            "n_nan": s["n_nan"], "bound": bound,
            "holds": s["mean"] <= bound,
            "seconds": time.perf_counter() - t0})
    clear_cache()
    return records


def rows(records) -> list[str]:
    """The JAX bench's CSV rows: ``name,us,derived``."""
    return [f"theorem1_eta{r['frac']},{r['seconds'] * 1e6:.0f},"
            f"empirical={r['empirical']:.4g};"
            f"empirical_std={r['empirical_std']:.2g};seeds={r['seeds']};"
            f"n_nan={r['n_nan']};bound={r['bound']:.4g};holds={r['holds']}"
            for r in records]


def run(device=None) -> list[str]:
    return rows(measure(device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seeds", type=int, default=SEEDS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"# theorem 1 on {name}, {args.steps} steps, {args.seeds} seeds")
    for row in rows(measure(device, steps=args.steps, seeds=args.seeds)):
        print(row)


if __name__ == "__main__":
    main()
