"""Scenario-serving launcher: Study manifests in, batched results out.

Port of ``repro.launch.serve``, the front end of
:class:`repro_torch.serve.StudyService` (DESIGN.md §11). The launcher owns
the model context — a synthetic heterogeneous quadratic population at
``--capacity`` — and serves JSON Study manifests against it, batching
every submitted request through the structure-grouped engine, so
same-structure studies (any mix of population sizes) share one runner
and one signature of the executable cache. The steps go through the
aggregate kernels (``use_kernel=True``: K2 for its ``sgd``).
It runs on the CUDA card, and raises when there is none, unless
``--device cpu`` is given:

    # serve manifest files
    PYTHONPATH=src python -m repro_torch.launch.serve m1.json m2.json

    # self-contained demo batch: 8 mixed-population requests,
    # one structure, one compile
    PYTHONPATH=src python -m repro_torch.launch.serve --demo

    # preemption-safe serving (DESIGN.md §12): checkpoint every 20
    # steps under --checkpoint-root; a killed run is picked up with
    # --recover, which resumes partial dispatches bitwise
    PYTHONPATH=src python -m repro_torch.launch.serve --demo \\
        --checkpoint-root ck --checkpoint-every 20
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --checkpoint-root ck --recover

Prints one summary line per request (cells, quarantined cells, latency)
plus the batch/cache counters that show the single-signature collapse.
``examples_torch/serve_batch.py`` is the scripted client-side
walkthrough.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import random as trandom
from repro_torch._device import resolve_device
from repro_torch.core.convergence import make_quadratic
from repro_torch.experiments import ExecutionConfig, Study
from repro_torch.optim import sgd
from repro_torch.serve import StudyService


def demo_manifests(n_requests: int = 8, num_steps: int = 60,
                   capacity: int = 8, seeds=(0, 1)) -> list[str]:
    """Mixed-population, single-structure request burst: every study is
    the same scheduler × arrival structure at a different population
    size N ≤ capacity — the shape the service collapses onto one
    structure group."""
    sizes = [3 + (i % (capacity - 2)) for i in range(n_requests)]
    out = []
    for i, n in enumerate(sizes):
        study = (Study(f"demo{i}", num_steps=num_steps)
                 .axis("scheduler", "alg1")
                 .axis("arrivals", "periodic")
                 .axis("n_clients", int(n))
                 .axis("seeds", list(seeds)))
        out.append(study.to_json())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve Study manifests against a shared model context")
    ap.add_argument("manifests", nargs="*",
                    help="paths to study/v1 or study-request/v1 JSON files")
    ap.add_argument("--demo", action="store_true",
                    help="serve a built-in mixed-population demo batch")
    ap.add_argument("--demo-requests", type=int, default=8)
    ap.add_argument("--demo-steps", type=int, default=60)
    ap.add_argument("--capacity", type=int, default=8,
                    help="model-context population capacity N_cap")
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--cache-size", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--checkpoint-root", default=None,
                    help="directory for resumable dispatch checkpoints "
                         "(enables --checkpoint-every and --recover)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint cadence in steps; > 0 routes "
                         "dispatches through the preemption-safe "
                         "chunked path (requires --checkpoint-root)")
    ap.add_argument("--recover", action="store_true",
                    help="resume every partial dispatch recorded under "
                         "--checkpoint-root before serving new requests")
    args = ap.parse_args(argv)

    if not args.manifests and not args.demo and not args.recover:
        ap.error("give manifest files, --demo, or --recover")
    if args.checkpoint_every and not args.checkpoint_root:
        ap.error("--checkpoint-every requires --checkpoint-root")
    if args.recover and not args.checkpoint_root:
        ap.error("--recover requires --checkpoint-root")
    device = resolve_device(args.device)

    payloads = []
    for path in args.manifests:
        with open(path) as f:
            payloads.append((path, f.read()))
    if args.demo:
        payloads += [(f"demo[{i}]", m) for i, m in enumerate(demo_manifests(
            args.demo_requests, args.demo_steps, args.capacity))]

    prob = make_quadratic(trandom.PRNGKey(args.seed, device=device),
                          args.capacity, dim=args.dim)
    service = StudyService(
        grads_fn=lambda w, k, t: prob.all_grads(w), p=prob.p,
        optimizer=sgd(args.lr), use_kernel=True,
        params0=torch.zeros(args.dim, device=device),
        cache_size=args.cache_size, checkpoint_root=args.checkpoint_root,
        device=device)

    responses = []
    rids = {}
    if args.recover:
        recovered = service.recover()
        responses += [service.result(r) for r in recovered]
        rids.update({r: "recovered" for r in recovered})
        print(f"recovered {len(recovered)} request(s) from "
              f"{args.checkpoint_root}")

    config = None
    if args.checkpoint_every:
        config = ExecutionConfig(checkpoint_every=args.checkpoint_every)
    for origin, text in payloads:
        rids[service.submit(text, config)] = origin
    responses += service.flush()

    for resp in responses:
        origin = rids.get(resp.request_id, "?")
        if resp.error is not None:
            print(f"{resp.request_id} {resp.study!r} ({origin}): "
                  f"ERROR {resp.error}")
            continue
        quarantined = (f" quarantined={resp.quarantined}"
                       if resp.quarantined else "")
        resumed = (f" checkpointed(resumed_steps="
                   f"{resp.batch['resumed_steps']})"
                   if resp.batch.get("resumable") else "")
        print(f"{resp.request_id} {resp.study!r} ({origin}): "
              f"{len(resp.records)} cell(s), "
              f"latency {resp.timings['latency_us'] / 1e3:.1f} ms"
              f"{quarantined}{resumed}")
    stats = service.stats()
    print(f"service on {device}:", json.dumps(stats, sort_keys=True))
    return responses


if __name__ == "__main__":
    main()
