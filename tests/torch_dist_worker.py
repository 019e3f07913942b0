"""A rank of ``tests/test_torch_client_sharding.py``'s simulated runs.

Started by ``repro_torch.launch.distributed.launch_simulated(N,
command=[python, this file], argv=...)``: it takes the launcher's
arguments, starts its rank from the ``REPRO_DIST_*`` environment, runs
the launcher's canonical job (``run_worker``: results npz, per-rank
report) and counts K1's and K2's launches in it, then the checks that
need ranks beyond the job, and writes their outcome to
``extra_p<rank>.json`` in ``--out``:

- with ``--check-masked-shard``, first: K1 and K2's delta form over
  this rank's shard of a ragged ``(8, 5)`` buffer whose last shard has
  every row masked (NaN), against the plain versions within 1e-6 (the
  last shard exact zeros), and the all-reduced sums against the plain
  reduction of the whole buffer;
- ``fused`` with a momentum optimizer: refused with ``degrade=False``,
  stepped down to ``psum`` with a ``DowngradeRecord`` with
  ``degrade=True``, and then bitwise the ``psum`` run;
- a faults axis under a clients mesh: refused before any step;
- ``run_client_sharded`` of one cell: ``gather`` (with an eval hook)
  bitwise ``ClientSimulator.run``, ``psum`` within f32 tolerance;
- a client-aware grads_fn (``clients=``): only its rows computed, within
  f32 tolerance of the full-compute run, participation bitwise.

``--no-extra`` leaves out the checks after the job.

Imports neither JAX nor the JAX package.
"""

import json
import os
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _max_diff(a, b):
    return float((a.double() - b.double()).abs().max())


def check_masked_shard(device) -> dict:
    """K1 and K2's delta form, sharded, with the last client shard's rows
    all masked (a population that ends one row before the last shard
    starts: 5 of 8 over 4 ranks leaves rank 3 rows 6-7). Masked rows
    hold NaN. This rank's local results are held against the plain
    versions on the same rows within 1e-6 (on the last rank, exact
    zeros), and the all-reduced sums against the plain reduction of the
    whole buffer within 1e-6."""
    import torch

    from repro_torch.core.energy import ClientShard, shard_all_reduce
    from repro_torch.experiments import placement
    from repro_torch.kernels.aggregate import ops, ref
    from repro_torch.launch import distributed as D

    mesh = placement.make_client_mesh()
    shards, index = mesh.size, mesh.coords[0]
    shard = ClientShard(placement.CLIENT_AXIS, shards, "psum", index,
                        mesh.groups[0])
    n_cap, p = D.JOB_N_CAP, D.JOB_DIM
    n_local = n_cap // shards
    n_active = max(1, (shards - 1) * n_local - 1) if shards > 1 else n_cap
    gen = torch.Generator(device="cpu").manual_seed(7)
    g = torch.randn(n_cap, p, generator=gen).to(device)
    w = (torch.rand(n_cap, generator=gen) * (2.0 / n_cap)).to(device)
    mask = (torch.arange(n_cap) < n_active).float().to(device)
    clean = torch.where(mask[:, None] > 0, g, 0.0)
    poisoned = torch.where(mask[:, None] > 0, g, float("nan"))
    rows = slice(index * n_local, (index + 1) * n_local)
    g_l, w_l, m_l = poisoned[rows].contiguous(), w[rows], mask[rows]
    eta = torch.tensor(0.05, device=device)
    k1_local = ops.masked_scaled_aggregate(g_l, w_l, out_dtype=torch.float32,
                                           mask=m_l)
    k2_local = ops.masked_scaled_aggregate_update(g_l, w_l, eta, None, m_l)
    k1 = ops.masked_scaled_aggregate_sharded(g_l, w_l, shard=shard,
                                             mask=m_l)
    k2 = shard_all_reduce(k2_local, shard)
    local1 = ref.masked_scaled_aggregate_ref(clean[rows], w_l, m_l,
                                             torch.float32)
    local2 = ref.masked_scaled_aggregate_update_ref(clean[rows], w_l, eta,
                                                    None, m_l)
    want1 = ref.masked_scaled_aggregate_ref(clean, w, mask, torch.float32)
    want2 = ref.masked_scaled_aggregate_update_ref(clean, w, eta, None, mask)
    return {"rank": index, "rows": [rows.start, rows.stop],
            "active_rows": int(m_l.sum().item()),
            "local_k1_err": _max_diff(k1_local, local1),
            "local_k2_err": _max_diff(k2_local, local2),
            "k1_err": _max_diff(k1, want1), "k2_err": _max_diff(k2, want2),
            "local_zero": bool(
                torch.equal(k1_local, torch.zeros_like(k1_local))
                and torch.equal(k2_local, torch.zeros_like(k2_local)))}


def extra_checks(device) -> dict:
    import torch

    from repro_torch import random as trandom
    from repro_torch._tree import tree_leaves
    from repro_torch.core import ClientSimulator, make_arrivals, make_scheduler
    from repro_torch.experiments import ExecutionConfig, Study, placement
    from repro_torch.launch import distributed as D
    from repro_torch.optim import momentum

    out = {}
    mesh = placement.make_client_mesh()
    w0 = D.job_params0(device)
    study = (Study("extra", num_steps=10).axis("scheduler", "alg2")
             .axis("arrivals", "binary").axis("n_clients", [5, 8])
             .axis("seeds", 2))
    heavy = D.make_job_sim(device, optimizer=momentum(0.01, beta=0.9))
    try:
        study.run(sim=heavy, params0=w0, config=ExecutionConfig(
            mesh=mesh, client_reduction="fused"))
        out["fused_momentum_error"] = None
    except ValueError as e:
        out["fused_momentum_error"] = str(e)
    down = study.run(sim=heavy, params0=w0, config=ExecutionConfig(
        mesh=mesh, client_reduction="fused", degrade=True))
    psum = study.run(sim=heavy, params0=w0, config=ExecutionConfig(
        mesh=mesh, client_reduction="psum"))
    out["downgrades"] = [d.to_json() for d in down.downgrades]
    out["downgraded_equals_psum"] = all(
        torch.equal(x, y) for name in psum
        for x, y in zip(tree_leaves(tuple(down[name])),
                        tree_leaves(tuple(psum[name]))))

    faulty = (Study("faulty", num_steps=4).axis("scheduler", "alg1")
              .axis("arrivals", "periodic")
              .axis("faults", [None, ("drop", {"rate": 0.3})])
              .axis("seeds", 1))
    try:
        faulty.run(sim=D.make_job_sim(device), params0=w0,
                   config=ExecutionConfig(mesh=mesh))
        out["faults_error"] = None
    except ValueError as e:
        out["faults_error"] = str(e)

    sim = D.make_job_sim(device)
    n = D.JOB_N_CAP
    sched = make_scheduler("alg2", n)
    energy = make_arrivals("binary", n, 21)
    key = trandom.PRNGKey(3, device=device)
    eval_fn = lambda w: torch.sum(w * w)  # noqa: E731
    pu, hu, eu = sim.run(key, w0, 20, scheduler=sched, energy=energy,
                         eval_fn=eval_fn, eval_every=10)
    ps, hs, es = placement.run_client_sharded(
        sim, key, w0, 20, scheduler=sched, energy=energy, mesh=mesh,
        eval_fn=eval_fn, eval_every=10, reduction="gather")
    out["cell_gather_bitwise"] = bool(
        torch.equal(pu, ps) and torch.equal(eu, es)
        and all(torch.equal(a, b) for a, b in zip(hu, hs)))
    pp, hp = placement.run_client_sharded(
        sim, key, w0, 20, scheduler=sched, energy=energy, mesh=mesh)
    out["cell_psum_params_diff"] = _max_diff(pu, pp)
    out["cell_psum_participation_equal"] = bool(
        torch.equal(hu.participation, hp.participation))

    master = D._quadratic(device)
    seen = []

    def aware(w, k, t, clients=None):
        if clients is None:
            return master.all_grads(w)
        seen.append(clients.tolist())
        return torch.einsum("nij,j->ni", master.a[clients], w) \
            - master.b[clients]

    sim_aware = ClientSimulator(grads_fn=aware, p=master.p,
                                optimizer=sim.optimizer, loss_fn=sim.loss_fn,
                                device=device)
    pa, ha = placement.run_client_sharded(
        sim_aware, key, w0, 15, scheduler=sched, energy=energy, mesh=mesh)
    pf, hf = sim.run(key, w0, 15, scheduler=sched, energy=energy)
    out["aware_rows"] = seen[0]
    out["aware_params_diff"] = _max_diff(pa, pf)
    out["aware_participation_equal"] = bool(
        torch.equal(ha.participation, hf.participation))
    return out


def main(argv) -> int:
    sys.path.insert(0, SRC)
    from repro_torch.experiments import placement
    from repro_torch.launch import distributed as D

    from repro_torch.kernels.aggregate import ops

    own = {"--check-masked-shard", "--no-extra"}
    args = D.parse_args([a for a in argv if a not in own])
    device = D.start_rank(args)
    extra = {}
    if "--check-masked-shard" in argv:
        extra["masked_shard"] = check_masked_shard(device)
    ops.reset_launch_counts()
    D.run_worker(args, device)
    extra["launches"] = dict(ops.launch_counts)
    if "--no-extra" not in argv:
        extra.update(extra_checks(device))
    rank = placement._world()[1]
    with open(os.path.join(args.out, f"extra_p{rank}.json"), "w") as f:
        json.dump(extra, f, indent=1, sort_keys=True)
    D.stop_rank()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
