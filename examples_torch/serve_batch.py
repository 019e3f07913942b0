"""Study-as-a-service walkthrough on the port: one structure group
serves a mixed batch.

The torch counterpart of ``examples/serve_batch.py``. Eight clients
submit serialized Study manifests concurrently — all the same scheduler
× arrival structure but *different population sizes* — to a background
StudyService. The service batches them into a single structure-grouped
dispatch, so the whole burst counts exactly one compile (one runner
signature of the executable cache), and a repeat submission afterwards
is a pure cache hit: zero new compiles. The steps go through the
aggregate kernels (``use_kernel=True``: K2 on the card).

The final act is preemption-safe serving (DESIGN.md §12): the same
burst is served with checkpointing, "killed" mid-dispatch, and then
recovered by a brand-new service pointed at the checkpoint root — the
resumed responses are bitwise identical to the uninterrupted ones.

It runs on the CUDA card, and raises when there is none, unless
``--device cpu`` is given:

    PYTHONPATH=src python examples_torch/serve_batch.py [--device cpu]
"""

import argparse
import tempfile

import torch

from repro_torch import random as trandom
from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.convergence import make_quadratic
from repro_torch.experiments import ExecutionConfig, Study
from repro_torch.optim import sgd
from repro_torch.serve import BackgroundServer, StudyService

CAPACITY = 8
DIM = 8
POPULATIONS = [3, 4, 5, 6, 7, 8, 3, 5]  # 8 requests, 6 distinct sizes


def make_manifest(i: int, n_clients: int, num_steps: int = 80) -> str:
    """One client's request: same structure every time, its own N."""
    study = (Study(f"client{i}", num_steps=num_steps)
             .axis("scheduler", "alg2")
             .axis("arrivals", "binary")
             .axis("n_clients", n_clients)
             .axis("seeds", [0, 1, 2, 3]))
    return study.to_json()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    prob = make_quadratic(trandom.PRNGKey(0, device=device), CAPACITY,
                          dim=DIM)

    def make_service(root=None):
        return StudyService(
            grads_fn=lambda w, k, t: prob.all_grads(w), p=prob.p,
            optimizer=sgd(0.05), loss_fn=prob.suboptimality,
            use_kernel=True, params0=torch.zeros(DIM, device=device),
            cache_size=16, checkpoint_root=root, device=device)

    service = make_service()
    manifests = [make_manifest(i, n, args.steps)
                 for i, n in enumerate(POPULATIONS)]
    print(f"submitting {len(manifests)} manifests, populations "
          f"{POPULATIONS}, capacity N_cap={CAPACITY}, on {device}\n")

    with BackgroundServer(service):
        rids = [service.submit(m) for m in manifests]
        responses = [service.wait(rid, timeout=300) for rid in rids]

    for resp in responses:
        if resp.error is not None:
            raise RuntimeError(f"{resp.request_id} failed: {resp.error}")
        rec = resp.records[0]
        print(f"  {resp.request_id} {resp.study:>8}  N={rec['n_clients']}  "
              f"metric={rec['mean']:.4e}  "
              f"latency={resp.timings['latency_us'] / 1e3:8.1f} ms  "
              f"quarantined={resp.quarantined}")

    stats = service.stats()
    batch = responses[0].batch
    print(f"\nbatched {batch['requests']} requests / {batch['cells']} cells "
          f"into {batch['dispatches']} structure dispatch(es)")
    print(f"compiles={stats['compiles']} "
          f"(one signature for all {len(set(POPULATIONS))} population "
          f"sizes), executable entries={stats['executable_entries']}")
    if stats["compiles"] != 1:
        raise RuntimeError("the mixed batch should count one compile")

    # Repeat traffic: the identical manifest set again -> the executable
    # cache serves the stored runner, zero new compiles.
    for m in manifests:
        service.submit(m)
    service.flush()
    again = service.stats()
    print(f"repeat submission: compiles={again['compiles']} (unchanged), "
          f"cache hits={again['hits']}")
    if again["compiles"] != stats["compiles"]:
        raise RuntimeError("repeat traffic compiled again")

    preemption_demo(make_service, manifests, args.steps)
    return responses


def preemption_demo(make_service, manifests, num_steps):
    """Serve the burst checkpointed, kill it mid-dispatch, recover it
    bitwise from the checkpoint root with a brand-new service."""
    cfg = ExecutionConfig(checkpoint_every=num_steps // 4)  # 4 chunks
    with tempfile.TemporaryDirectory(prefix="serve-ck-") as root, \
            tempfile.TemporaryDirectory(prefix="serve-ck-ref-") as ref_root:
        # the uninterrupted reference dispatch, same composition
        ref_service = make_service(ref_root)
        for m in manifests:
            ref_service.submit(m, cfg)
        reference = {r.study: r for r in ref_service.flush()}

        # "preempt" a dispatch: the third checkpoint save raises, killing
        # the flush mid-run and leaving a partial checkpoint directory
        doomed = make_service(root)
        real_save, saves = CheckpointManager.save, [0]

        def dying_save(self, step, state):
            if saves[0] >= 2:
                raise RuntimeError("simulated preemption")
            saves[0] += 1
            return real_save(self, step, state)

        CheckpointManager.save = dying_save
        try:
            for m in manifests:
                doomed.submit(m, cfg)
            (failed, *_) = doomed.flush()
        finally:
            CheckpointManager.save = real_save
        print(f"\npreempted dispatch: {failed.error}")

        # a brand-new service discovers the partial dispatch and resumes it
        fresh = make_service(root)
        rids = fresh.recover()
        resumed = [fresh.result(r) for r in rids]
        batch = resumed[0].batch
        print(f"recovered {len(rids)} request(s): resumed from step "
              f"{batch['resumed_steps']}, {batch['chunks']} chunk(s) "
              f"replayed, new compiles={batch['new_compiles']}")
        for resp in resumed:
            if resp.error is not None:
                raise RuntimeError(f"recovery failed: {resp.error}")
            ref = reference[resp.study].result
            for cell in ref.cells:
                for a, b in zip(tree_leaves(tuple(ref.cells[cell])),
                                tree_leaves(tuple(resp.result.cells[cell]))):
                    if not torch.equal(a, b):
                        raise RuntimeError(
                            f"{resp.study}/{cell}: the resumed response "
                            f"differs from the uninterrupted dispatch")
    print("resumed responses bitwise equal to the uninterrupted dispatch")


if __name__ == "__main__":
    main()
