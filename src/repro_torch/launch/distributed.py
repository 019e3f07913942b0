"""Multi-rank study execution: ``torch.distributed`` start-up and worker CLI.

Port of ``repro.launch.distributed`` (DESIGN.md §13). Three layers, top
to bottom:

1. :func:`initialize` / :func:`init_from_env` — start the default
   process group from CLI flags or the ``REPRO_DIST_*`` environment
   (:func:`repro_torch._env.distributed_env`) and give this rank its
   device: NCCL when each rank of the host has a card of its own, gloo
   on the CPU or when ranks share a card (NCCL refuses two ranks on one
   device).
2. The worker CLI (``python -m repro_torch.launch.distributed``) — runs
   the canonical differential job (the JAX package's: a capacity-8,
   dim-5 quadratic, alg1 and benchmark1 at the ragged populations 5
   and 8) through the unchanged ``Study.run`` / ``execute_cells``
   dispatch on rank meshes, asserts the one-compile-per-structure-group
   count, optionally times warm dispatches, and writes results and a
   per-rank report.
3. :func:`launch_simulated` — N copies of the worker CLI (or of any
   script that calls :func:`init_from_env`) on this machine, coordinated
   over a fresh localhost port; ``--simulate N`` does the same from the
   command line.

Entry points run on the card unless ``--device cpu`` is passed. A
worker takes its share of the host's cores for torch's threads (the
cores over the ranks, and over the pytest-xdist workers when a test
session started it).

A two-host run (see README)::

    # host A (rank 0, the coordinator)     # host B
    python -m repro_torch.launch.distributed \\
        --coordinator hostA:9876 \\
        --num-processes 2 --process-id 0  # ... --process-id 1

This module imports torch only inside its functions, so a launcher can
set the environment before torch starts.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

from repro_torch._env import (
    DIST_COORDINATOR,
    DIST_LOCAL_DEVICES,
    DIST_NUM_PROCESSES,
    DIST_PROCESS_ID,
    distributed_env,
)

#: src/ directory holding ``repro_torch`` — what workers need on
#: PYTHONPATH.
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def share_threads(num_processes: int) -> int:
    """Give torch this process's share of the cores: the cores over the
    ranks, and over the pytest-xdist workers when a test session started
    the launch (``tests/torch_threads.py``'s rule). Returns the count."""
    import torch

    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, len(os.sched_getaffinity(0)) // (workers * num_processes))
    torch.set_num_threads(n)
    return n


def initialize(coordinator: str, num_processes: int, process_id: int,
               device=None, local_devices: int | None = None):
    """Start the default process group for this rank; return its device.

    ``device`` ``"cpu"`` gives every rank the CPU and gloo. Otherwise the
    rank takes card ``local_rank % cards`` of its host, where
    ``local_rank = process_id % local_devices`` (``local_devices``: the
    ranks on this host, default all of them), with NCCL when the host
    has a card for each of its ranks and gloo when ranks share cards.
    A ``num_processes == 1`` call starts no process group, so one-rank
    drivers share the code path.
    """
    import torch
    import torch.distributed as dist

    local = num_processes if local_devices is None else int(local_devices)
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError(
                "repro_torch.launch.distributed runs on CUDA cards by "
                "default and none is available; pass device='cpu' "
                "(--device cpu) to run the ranks on the CPU")
        dev = torch.device("cuda", (process_id % local) % cards)
        backend = "gloo" if local > cards else "nccl"
        torch.cuda.set_device(dev)
    if num_processes > 1:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id)
        from repro_torch.experiments import placement

        placement.rank_hosts()  # the collective first call, on every rank
    return dev


def init_from_env(device=None):
    """Initialize from the ``REPRO_DIST_*`` environment if present.

    Returns this rank's device, or None when the environment carries no
    distributed configuration (one process, nothing started). Partial
    configuration raises (:func:`repro_torch._env.distributed_env`).
    """
    cfg = distributed_env()
    if cfg is None:
        return None
    return initialize(cfg["coordinator"], cfg["num_processes"],
                      cfg["process_id"], device=device,
                      local_devices=cfg["local_devices"])


# ------------------------------------------------------ canonical job

#: Fixed shape of the differential job, the JAX package's: capacity-8
#: quadratic population, dim 5, two scheduler structures, ragged cells
#: (DESIGN.md §13).
JOB_N_CAP, JOB_DIM = 8, 5
JOB_SCHEDULERS = ("alg1", "benchmark1")
JOB_POPULATIONS = (5, 8)  # ragged: one below-capacity cell per structure


def _quadratic(device):
    """The job's problem, drawn on the CPU from PRNGKey(2) and moved to
    ``device``, so every device holds the same numbers."""
    import torch

    from repro_torch import random as trandom
    from repro_torch.core import make_quadratic

    master = make_quadratic(trandom.PRNGKey(2, device="cpu"),
                            n_clients=JOB_N_CAP, dim=JOB_DIM, hetero=1.0)
    return master._replace(**{f: getattr(master, f).to(device)
                              for f in ("a", "b", "p", "w_star")
                              if isinstance(getattr(master, f),
                                            torch.Tensor)})


def make_job_sim(device="cpu", *, optimizer=None):
    """The job's ClientSimulator on ``device``, through K1/K2 — its
    gradients are deterministic and its loss elementwise plus one sum,
    so gather-mode multi-rank runs can be held bitwise to the one-rank
    engine."""
    import torch

    from repro_torch.core import ClientSimulator
    from repro_torch.optim import sgd

    master = _quadratic(device)
    w_star = master.w_star
    return ClientSimulator(
        grads_fn=lambda w, k, t: master.all_grads(w), p=master.p,
        optimizer=sgd(0.02) if optimizer is None else optimizer,
        loss_fn=lambda w: torch.sum((w - w_star) ** 2), use_kernel=True,
        device=device)


def make_job_study(num_steps: int = 25, seeds: int = 2):
    """Ragged Fig-1 sub-grid: 2 scheduler structures × ragged
    populations × seeds — 2 structure groups, every group ragged."""
    from repro_torch.experiments import Study

    return (Study("multihost_quadratic", num_steps=num_steps)
            .axis("scheduler", list(JOB_SCHEDULERS))
            .axis("arrivals", "periodic")
            .axis("n_clients", list(JOB_POPULATIONS))
            .axis("seeds", seeds))


def job_params0(device="cpu"):
    import torch

    return torch.full((JOB_DIM,), 4.0, device=device)


def flatten_results(tag: str, results) -> dict:
    """``{tag|cell|field: np.ndarray}`` — the npz layout the workers and
    the comparing test or script build, so equality checks are plain
    key-wise array comparisons. A parameter tree is raveled in the flat
    layout (:func:`repro_torch.core.ravel_pytree`)."""
    from repro_torch.core import ravel_pytree
    from repro_torch.experiments.results import host

    flat = {}
    for cell, res in results.items():
        fields = {"params": ravel_pytree(res.params)
                  if not hasattr(res.params, "shape") else res.params,
                  "loss": res.history.loss,
                  "participation": res.history.participation,
                  "weight_sum": res.history.weight_sum,
                  "finite": res.history.finite, "diverged": res.diverged}
        for field, leaf in fields.items():
            if leaf is not None:
                flat[f"{tag}|{cell}|{field}"] = host(leaf)
    return flat


def reference_results(num_steps: int = 25, seeds: int = 2, *, device="cpu"):
    """The one-rank engine's results for the canonical job: the oracle."""
    study = make_job_study(num_steps, seeds)
    return study.run(sim=make_job_sim(device),
                     params0=job_params0(device)).cells


# ------------------------------------------------------- worker body

def _build_mesh(kind: str):
    from repro_torch.experiments import placement

    if kind == "clients":
        return placement.make_client_mesh()
    if kind == "multihost":
        return placement.make_multihost_mesh()
    if kind == "cells":
        return placement.make_cell_mesh()
    if kind == "grid":
        size = placement._world()[0]
        return placement.make_grid_mesh(2, size // 2)
    raise ValueError(f"unknown mesh kind {kind!r} "
                     "(have clients, multihost, cells, grid)")


def params_digest(results) -> str:
    """sha256 of every cell's final parameters, in cell order: replicated
    parameters must be bit-equal on every rank."""
    from repro_torch.core import ravel_pytree
    from repro_torch.experiments.results import host

    h = hashlib.sha256()
    for name, res in results.items():
        h.update(name.encode())
        h.update(host(ravel_pytree(res.params)
                      if not hasattr(res.params, "shape")
                      else res.params).tobytes())
    return h.hexdigest()


def run_worker(args, device) -> dict:
    """Execute the canonical job on this rank.

    One pass per (mesh, reduction) combination (a mesh without a clients
    axis runs once): dispatch through the unchanged ``Study.run``,
    assert the compile count (one ``_run_group_sharded`` signature per
    structure group on this rank, none on the warm repeat), optionally
    time ``--timing-iters`` warm dispatches, and hash the final
    parameters. Rank 0 saves the flattened results npz; every rank
    writes its report.
    """
    import torch.distributed as dist

    from repro_torch.experiments import ExecutionConfig, engine, placement

    size, rank = placement._world()
    backend = dist.get_backend() if dist.is_initialized() else None
    threads = share_threads(size)
    sim = make_job_sim(device)
    study = make_job_study(args.steps, args.seeds)
    params0 = job_params0(device)
    _, _, groups = engine.resolve_structure_groups(study.resolve(), sim=sim)
    report = {
        "process_id": rank, "process_count": size,
        "device": str(device), "backend": backend,
        # NCCL refuses two ranks on one card; gloo on the card means
        # the ranks share it.
        "shared_card": device.type == "cuda" and backend == "gloo",
        "threads": threads, "combos": {},
    }
    flat_all = {}
    for kind in args.mesh.split(","):
        mesh = _build_mesh(kind)
        _, client_ax = placement._mesh_axes(mesh)
        # A one-rank mesh runs the unsharded path: no signature.
        n_groups = len(groups) if mesh.size > 1 else 0
        for reduction in args.reduction.split(",") if client_ax else [None]:
            tag = kind if reduction is None else f"{kind}-{reduction}"
            cfg = ExecutionConfig(mesh=mesh,
                                  client_reduction=reduction or "psum")
            before = placement._run_group_sharded._cache_size()
            result = study.run(sim=sim, params0=params0, config=cfg)
            compiles = placement._run_group_sharded._cache_size() - before
            if compiles != n_groups:
                raise AssertionError(
                    f"{tag}: expected one compile per structure group "
                    f"({n_groups}), counted {compiles}")
            study.run(sim=sim, params0=params0, config=cfg)
            warm = placement._run_group_sharded._cache_size() - before
            if warm != n_groups:
                raise AssertionError(
                    f"{tag}: warm repeat compiled again ({warm - n_groups} "
                    "new signatures)")
            timing_us = None
            if args.timing_iters > 0:
                t0 = time.perf_counter()
                for _ in range(args.timing_iters):
                    study.run(sim=sim, params0=params0, config=cfg)
                timing_us = (time.perf_counter() - t0) / args.timing_iters \
                    * 1e6
            report["combos"][tag] = {
                "mesh_shape": dict(mesh.shape),
                "mesh_process_span": placement.mesh_process_count(mesh),
                "compiles": compiles,
                "warm_new_compiles": warm - n_groups,
                "dispatch_us": timing_us,
                "us_per_step": (timing_us / args.steps
                                if timing_us is not None else None),
                "params_sha256": params_digest(result.cells),
                "downgrades": [d.to_json() for d in result.downgrades],
            }
            flat_all.update(flatten_results(tag, result.cells))
    if args.out:
        import numpy as np

        os.makedirs(args.out, exist_ok=True)
        if rank == 0:
            np.savez(os.path.join(args.out, "results.npz"), **flat_all)
        with open(os.path.join(args.out, f"report_p{rank}.json"), "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    return report


# ------------------------------------------------- simulated harness

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _PortTaken(RuntimeError):
    """Rank 0 could not bind the coordinator port: something took it
    between :func:`_free_port` and rank 0's bind."""


def _spawn(num_processes, local_devices, command, timeout):
    """One attempt of :func:`launch_simulated` on a fresh port."""
    port = _free_port()
    procs, files = [], []
    for pid in range(num_processes):
        env = dict(os.environ)
        env[DIST_COORDINATOR] = f"127.0.0.1:{port}"
        env[DIST_NUM_PROCESSES] = str(num_processes)
        env[DIST_PROCESS_ID] = str(pid)
        env[DIST_LOCAL_DEVICES] = str(local_devices or num_processes)
        env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        files.append((out, err))
        procs.append(subprocess.Popen(command, env=env, stdout=out,
                                      stderr=err, text=True))
    deadline = time.monotonic() + timeout
    failed, late = None, False
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = next((i for i, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if failed is not None or None not in codes:
                break
            if time.monotonic() > deadline:
                late = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    done = []
    for proc, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        done.append(subprocess.CompletedProcess(proc.args, proc.returncode,
                                                out.read(), err.read()))
        out.close()
        err.close()
    if failed is not None or late:
        i = 0 if failed is None else failed
        what = (f"outlived {timeout:.0f} s" if late
                else f"exited {done[i].returncode}")
        kind = _PortTaken if (i == 0 and not late and "EADDRINUSE"
                              in done[i].stderr) else RuntimeError
        raise kind(f"simulated worker {i}/{num_processes} {what}:\n"
                   f"{done[i].stderr[-4000:]}")
    return done


def launch_simulated(num_processes: int = 2, local_devices=None, *,
                     argv=(), timeout: float = 600.0, command=None,
                     ) -> list[subprocess.CompletedProcess]:
    """Run ``num_processes`` copies of the worker CLI on this machine.

    Each worker is a fresh interpreter given its rank through the
    ``REPRO_DIST_*`` environment and coordinated over a fresh localhost
    port; ``local_devices`` (default ``num_processes``) is how many of
    them the host holds. ``command`` replaces ``python -m
    repro_torch.launch.distributed`` (a script that calls
    :func:`init_from_env` itself). Returns the completed processes in
    rank order. A worker that exits non-zero stops the others at once,
    and its stderr is raised; so does one that outlives ``timeout``. The
    port is free when it is picked but not held: if rank 0 then finds it
    taken (EADDRINUSE), the launch runs once more on another port.
    """
    command = [sys.executable, "-m", "repro_torch.launch.distributed"] \
        if command is None else list(command)
    try:
        return _spawn(num_processes, local_devices, [*command, *argv],
                      timeout)
    except _PortTaken:
        return _spawn(num_processes, local_devices, [*command, *argv],
                      timeout)


def parse_args(argv=None):
    """The worker CLI's arguments (:func:`main`)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.distributed",
        description="multi-rank study worker / simulated multi-rank driver")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (or REPRO_DIST_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--local-devices", type=int, default=None,
                    help="ranks on this host (default: all)")
    ap.add_argument("--device", default=None,
                    help="cpu for CPU ranks; default: the host's cards")
    ap.add_argument("--simulate", type=int, default=0, metavar="N",
                    help="spawn N local workers instead of being one")
    ap.add_argument("--mesh", default="clients",
                    help="comma list of clients|multihost|cells|grid")
    ap.add_argument("--reduction", default="gather",
                    help="comma list of gather|psum|fused|... reductions")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--timing-iters", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="directory for results.npz + report_p*.json")
    return ap.parse_args(argv)


def start_rank(args):
    """Start this rank as ``args`` ask: from ``--coordinator`` and its
    flags, else from the ``REPRO_DIST_*`` environment, else as the only
    rank. Returns its device."""
    if args.coordinator is not None:
        return initialize(args.coordinator, args.num_processes or 1,
                          args.process_id or 0, device=args.device,
                          local_devices=args.local_devices)
    return init_from_env(device=args.device) or initialize(
        "", 1, 0, device=args.device)


def stop_rank():
    """End this rank's process group, if it started one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.simulate:
        passthrough = ["--mesh", args.mesh, "--reduction", args.reduction,
                       "--steps", str(args.steps), "--seeds", str(args.seeds),
                       "--timing-iters", str(args.timing_iters)]
        if args.device:
            passthrough += ["--device", args.device]
        if args.out:
            passthrough += ["--out", args.out]
        if args.device != "cpu":
            # The ranks load the aggregate kernels built here, once.
            from repro_torch.kernels.aggregate import ops

            ops.load()
        results = launch_simulated(args.simulate, args.local_devices,
                                   argv=passthrough)
        for proc in results:
            sys.stdout.write(proc.stdout)
        print(f"simulated {args.simulate}-process run complete")
        return 0

    report = run_worker(args, start_rank(args))
    print(json.dumps(report, indent=1, sort_keys=True))
    stop_rank()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
