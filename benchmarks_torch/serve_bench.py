"""Benchmark: the Study service on the port under mixed-population
request traffic.

The torch counterpart of ``benchmarks/serve_bench.py``, with the same
rows. It measures the serve path end to end (DESIGN.md §11): a burst of
mixed-population, single-structure manifests batched through
StudyService, then repeat traffic against the warm executable cache.
The steps go through the aggregate kernels (``use_kernel=True``: K2 on
the card). Every time is a host clock around work that ends in a CUDA
synchronize (the service synchronizes after each dispatch). It runs on
the CUDA card, and raises when there is none, unless ``--device cpu``
is given; the header line names the device:

    PYTHONPATH=src python -m benchmarks_torch.serve_bench [--fast] [--device cpu]

Series:

  serve_throughput  warm-cache wall time per batched flush;
                    scenarios/sec in derived
  serve_latency     p50/p99 per-request latency (submit -> response)
                    over the warm rounds
  serve_cache       repeat-traffic executable-cache behavior (hit rate,
                    compiles — which must not grow after warmup)
  serve_collapse    the single-signature collapse: distinct population
                    sizes served per compile (us=0, derived-only)

Resumable serving (DESIGN.md §12) — kill-and-resume vs uninterrupted:

  serve_resume_uninterrupted  checkpointed dispatch served end to end
                              (fresh checkpoint dir each round)
  serve_resume_latency        the resume leg after a simulated
                              preemption at half the chunks; the warm
                              resume must add ZERO new compiles, and
                              overhead_pct is (partial + resume) vs the
                              uninterrupted wall
  serve_resume_bitwise        resumed responses bitwise equal to the
                              uninterrupted dispatch (us=0)
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.convergence import make_quadratic
from repro_torch.experiments import ExecutionConfig, Study
from repro_torch.optim import sgd
from repro_torch.serve import StudyService

CAPACITY, DIM = 8, 8
POPULATIONS = [3, 4, 5, 6, 7, 8, 3, 5]


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def _serve(service, manifests, config=None):
    """Submit the manifest set, flush, and fail on any response error."""
    for m in manifests:
        service.submit(m, config)
    responses = service.flush()
    bad = [r.error for r in responses if r.error is not None]
    if bad:
        raise RuntimeError(f"serve dispatch failed: {bad[0]}")
    return responses


def run(fast: bool = False, device=None) -> list[str]:
    device = resolve_device(device)
    num_steps = 40 if fast else 200
    rounds = 3 if fast else 8

    prob = make_quadratic(trandom.PRNGKey(0, device=device), CAPACITY,
                          dim=DIM)
    service = StudyService(
        grads_fn=lambda w, k, t: prob.all_grads(w), p=prob.p,
        optimizer=sgd(0.05), loss_fn=prob.suboptimality, use_kernel=True,
        params0=torch.zeros(DIM, device=device), cache_size=16,
        device=device)

    manifests = []
    for i, n in enumerate(POPULATIONS):
        study = (Study(f"b{i}", num_steps=num_steps)
                 .axis("scheduler", "alg2").axis("arrivals", "binary")
                 .axis("n_clients", n).axis("seeds", [0, 1]))
        manifests.append(study.to_json())

    # cold round: the first run of the batch's signature
    t0 = time.perf_counter()
    _serve(service, manifests)
    cold_us = (time.perf_counter() - t0) * 1e6
    cold = service.stats()

    # warm rounds: repeat traffic, identical manifest set
    walls, latencies = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        responses = _serve(service, manifests)
        walls.append((time.perf_counter() - t0) * 1e6)
        latencies += [r.timings["latency_us"] for r in responses]
    warm = service.stats()

    n_req = len(manifests)
    warm_us = float(np.mean(walls))
    scen_per_s = n_req / (warm_us / 1e6)
    hits = warm["hits"] - cold["hits"]
    misses = warm["misses"] - cold["misses"]
    hit_rate = hits / max(1, hits + misses)
    p50 = _percentile(latencies, 50)
    p99 = _percentile(latencies, 99)

    rows = [
        f"serve_throughput,{warm_us:.0f},scenarios_per_s={scen_per_s:.2f};"
        f"requests={n_req};cells={n_req};rounds={rounds};"
        f"cold_us={cold_us:.0f}",
        f"serve_latency,{p50:.0f},p50_us={p50:.0f};p99_us={p99:.0f};"
        f"n={len(latencies)}",
        f"serve_cache,0,hit_rate={hit_rate:.3f};hits={hits};misses={misses};"
        f"evictions={warm['evictions']};compiles={warm['compiles']};"
        f"warm_compiles={warm['compiles'] - cold['compiles']}",
        f"serve_collapse,0,populations={len(set(POPULATIONS))};"
        f"compiles={cold['compiles']};"
        f"single_trace={cold['compiles'] == 1};"
        f"executable_entries={cold['executable_entries']}",
    ]
    rows += _resume_rows(service, manifests, num_steps, fast)
    return rows


def _resume_rows(service, manifests, num_steps, fast):
    """Kill-and-resume overhead of the checkpointed serve path.

    Uninterrupted: the manifest set served with checkpointing against a
    fresh fingerprint dir each round (re-serving an intact dir would
    measure a pure restore, not checkpointed execution). Interrupted:
    CheckpointManager.save raises after half the chunks (the same
    injection the kill tests use — the service sees a dead dispatch and
    keeps the partial dir), then the resubmitted set resumes the tail.
    """
    n_chunks = 4
    every = max(1, num_steps // n_chunks)
    rounds = 2 if fast else 4

    with tempfile.TemporaryDirectory() as root:
        cfg = ExecutionConfig(checkpoint_dir=root, checkpoint_every=every)

        def clear():
            for d in os.listdir(root):
                shutil.rmtree(os.path.join(root, d))

        _serve(service, manifests, cfg)  # warmup: the chunk runner's signature
        un_walls = []
        for _ in range(rounds):
            clear()
            t0 = time.perf_counter()
            reference = _serve(service, manifests, cfg)
            un_walls.append((time.perf_counter() - t0) * 1e6)
        uninterrupted_us = float(np.mean(un_walls))

        # preempt at half the chunks: save raises, the dispatch dies,
        # the partial checkpoint dir survives
        clear()
        real_save, saves = CheckpointManager.save, [0]

        def dying_save(self, step, state):
            if saves[0] >= n_chunks // 2:
                raise RuntimeError("bench-injected preemption")
            saves[0] += 1
            return real_save(self, step, state)

        CheckpointManager.save = dying_save
        try:
            t0 = time.perf_counter()
            for m in manifests:  # dies mid-dispatch
                service.submit(m, cfg)
            died = service.flush()
            partial_us = (time.perf_counter() - t0) * 1e6
        finally:
            CheckpointManager.save = real_save
        if not all(r.error is not None and "bench-injected" in r.error
                   for r in died):
            raise RuntimeError("the injected preemption did not fire")

        before = service.stats()["compiles"]
        t0 = time.perf_counter()
        resumed = _serve(service, manifests, cfg)  # the tail from the dir
        resume_us = (time.perf_counter() - t0) * 1e6
        new_compiles = service.stats()["compiles"] - before

        overhead_pct = 100.0 * (partial_us + resume_us - uninterrupted_us) \
            / uninterrupted_us
        resumed_steps = resumed[0].batch["resumed_steps"]

        by_name = {r.study: r for r in reference}
        bitwise = all(
            torch.equal(la, lb)
            for r in resumed
            for cell in r.result.cells
            for la, lb in zip(
                tree_leaves(tuple(by_name[r.study].result.cells[cell])),
                tree_leaves(tuple(r.result.cells[cell]))))

    return [
        f"serve_resume_uninterrupted,{uninterrupted_us:.0f},"
        f"chunks={n_chunks};checkpoint_every={every};rounds={rounds}",
        f"serve_resume_latency,{resume_us:.0f},resume_us={resume_us:.0f};"
        f"partial_us={partial_us:.0f};"
        f"uninterrupted_us={uninterrupted_us:.0f};"
        f"overhead_pct={overhead_pct:.1f};resumed_steps={resumed_steps};"
        f"new_compiles={new_compiles}",
        f"serve_resume_bitwise,0,bitwise={bitwise};"
        f"requests={len(manifests)}",
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--fast", action="store_true",
                    help="40 steps, 3 warm rounds (default 200, 8)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"# serve bench on {name}, {'fast' if args.fast else 'full'}")
    for row in run(args.fast, device):
        print(row)


if __name__ == "__main__":
    main()
