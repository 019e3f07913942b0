"""Port parity for studies sharded across ranks (DESIGN.md §5, §8, §13).

Two module-scoped simulated launches on the CPU, each rank a process
with gloo collectives over localhost
(``repro_torch.launch.distributed.launch_simulated``, every rank running
``tests/torch_dist_worker.py``): 2 ranks (clients mesh at every
reduction, cells mesh; 25 steps) and 4 ranks (clients, cells and a 2×2
grid; 12 steps), both on the launcher's canonical job — the JAX
package's capacity-8, dim-5 quadratic, alg1 and benchmark1 at
populations 5 and 8, 2 seeds, through K1/K2's wrappers (their plain
versions on the CPU). Held:

- ``gather`` and the cells axis bit for bit the port's one-process run
  of the same study; ``psum`` and ``fused`` within ``rtol=1e-5,
  atol=1e-6``, the bf16 wire within ``rtol=2e-2, atol=1e-2`` (JAX's
  tolerances, ``tests/test_client_sharding.py``); participation and
  ``diverged`` bit for bit in every combination; on 2 ranks, ``psum``
  and ``fused`` bit for bit the one-process run with its client sum
  split in two as the ranks split it (the weight sum within 1e-6);
- participation bit for bit against the JAX package's own client-sharded
  ``Study.run(mesh=make_client_mesh(W))`` on the conftest's CPU devices,
  through its ``eval_fn`` route (ROADMAP caveat R1), with losses and
  params within ``rtol=1e-5, atol=1e-6``; JAX's multi-process worker
  fails through R1, so the ranks are held against its in-process mesh;
- shard-local ``client_keys`` equal to JAX's global rows;
- the last shard of a ragged population with every row masked (rank 1
  of 2 at population 3, rank 3 of 4 at population 5 of 8): K1 and K2's
  delta exact zeros, NaN in the masked rows;
- the legacy per-leaf carry (``flat=False``) on a cells mesh bit for
  bit the one-process study, its participation JAX's cells mesh's; on
  a clients mesh refused with JAX's error;
- faults under a clients axis refused with JAX's error; ``fused`` with
  a momentum optimizer refused, and with ``degrade=True`` stepped down
  to ``psum`` with the same ``DowngradeRecord`` the JAX package records;
- one compile per structure group per rank and none on the warm repeat;
  the replicated params bit-equal on every rank (their sha256);
- ``run_client_sharded`` of one cell and a client-aware grads_fn.
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro import experiments as JE
from repro.core import ClientSimulator as JSim
from repro.core.energy import client_keys as j_client_keys
from repro.optim import momentum as j_momentum
from repro.optim import sgd as j_sgd
from repro_torch import random as trandom
from repro_torch.core.energy import ClientShard, client_keys, client_sharding
from repro_torch.core.aggregation import make_flat_grads_fn, ravel_spec
from repro_torch.kernels.aggregate import ops
from repro_torch.launch import distributed as D
from repro_torch.optim import sgd

pytestmark = pytest.mark.clientshard

WORKER = str(Path(__file__).resolve().parent / "torch_dist_worker.py")
RUNS = {2: dict(steps=25, meshes="clients,cells",
                reductions="gather,psum,fused,psum_bf16,fused_bf16"),
        4: dict(steps=12, meshes="clients,cells,grid",
                reductions="gather,psum,fused")}
SEEDS = 2
TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=1e-2)


def _launch(world, tmp_path_factory):
    spec = RUNS[world]
    out = str(tmp_path_factory.mktemp(f"ranks{world}"))
    D.launch_simulated(world, command=[sys.executable, WORKER], argv=[
        "--device", "cpu", "--mesh", spec["meshes"],
        "--reduction", spec["reductions"], "--steps", str(spec["steps"]),
        "--seeds", str(SEEDS), "--check-masked-shard", "--out", out],
        timeout=240)
    results = dict(np.load(os.path.join(out, "results.npz")))
    reports, extras = [], []
    for rank in range(world):
        with open(os.path.join(out, f"report_p{rank}.json")) as f:
            reports.append(json.load(f))
        with open(os.path.join(out, f"extra_p{rank}.json")) as f:
            extras.append(json.load(f))
    reference = D.flatten_results(
        "ref", D.reference_results(spec["steps"], SEEDS, device="cpu"))
    return {"results": results, "reports": reports, "extras": extras,
            "reference": reference, "steps": spec["steps"]}


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    return _launch(2, tmp_path_factory)


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    return _launch(4, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def run(request):
    return request.getfixturevalue(f"run{request.param}")


def _tags(results):
    return sorted({k.split("|")[0] for k in results})


def _cells(results, tag):
    cells = {k.split("|")[1] for k in results if k.startswith(tag + "|")}
    assert cells, f"no {tag} results in the npz"
    return sorted(cells)


# ------------------------------------------------- against one process

def test_gather_and_cells_bitwise_vs_one_process(run):
    results, ref = run["results"], run["reference"]
    tags = [t for t in _tags(results)
            if t.endswith("-gather") or t in ("cells", "grid-gather")]
    assert "clients-gather" in tags and "cells" in tags
    for tag in tags:
        for cell in _cells(results, tag):
            for field in ("params", "loss", "participation", "weight_sum",
                          "finite", "diverged"):
                np.testing.assert_array_equal(
                    results[f"{tag}|{cell}|{field}"],
                    ref[f"ref|{cell}|{field}"],
                    err_msg=f"{tag} drifted from one process: {cell}/{field}")


def test_psum_fused_and_wire_within_tolerance(run):
    results, ref = run["results"], run["reference"]
    tags = [t for t in _tags(results)
            if any(t.endswith(r) for r in ("psum", "fused", "psum_bf16",
                                           "fused_bf16"))]
    assert {"clients-psum", "clients-fused"} <= set(tags)
    for tag in tags:
        tol = BF16_TOL if tag.endswith("bf16") else TOL
        for cell in _cells(results, tag):
            for field in ("loss", "params", "weight_sum"):
                np.testing.assert_allclose(
                    results[f"{tag}|{cell}|{field}"],
                    ref[f"ref|{cell}|{field}"], **tol,
                    err_msg=f"{tag}: {cell}/{field}")
            for field in ("participation", "finite", "diverged"):
                np.testing.assert_array_equal(
                    results[f"{tag}|{cell}|{field}"],
                    ref[f"ref|{cell}|{field}"])


def _split_in_two(monkeypatch):
    """Make the one-process engine reduce the client axis as two client
    shards do: K1, and K2 with parameters, over each half of the rows
    alone, the halves' sums added once in f32 (two ranks' all-reduce),
    then K1's cast, or K2's add to the parameters in f32."""
    k1, k2 = ops.masked_scaled_aggregate, ops.masked_scaled_aggregate_update

    def halves(g, w, mask):
        n = g.shape[0] // 2
        return [(g[s], w[s], None if mask is None else mask[s])
                for s in (slice(0, n), slice(n, 2 * n))]

    def aggregate(g, w, out_dtype=None, mask=None):
        a, b = [k1(gi, wi, out_dtype=torch.float32, mask=mi)
                for gi, wi, mi in halves(g, w, mask)]
        return (a + b).to(g.dtype if out_dtype is None else out_dtype)

    def update(g, w, eta, params=None, mask=None, *, out_dtype=None):
        a, b = [k2(gi, wi, eta, None, mi) for gi, wi, mi in halves(g, w, mask)]
        if params is None:
            return a + b
        return (params.to(torch.float32) + (a + b)).to(params.dtype)

    monkeypatch.setattr(ops, "masked_scaled_aggregate", aggregate)
    monkeypatch.setattr(ops, "masked_scaled_aggregate_update", update)


def test_psum_and_fused_on_two_ranks_bitwise_the_split_sum(run2,
                                                            monkeypatch):
    """Two ranks' psum and fused are one f32 add of the two shards'
    partial sums: the one-process study with its client sum split the
    same way gives every field bit for bit but the weight sum, which is
    summed over 8 rows there and over 2 x 4 here (1e-6)."""
    study = D.make_job_study(run2["steps"], SEEDS)
    _split_in_two(monkeypatch)
    want = {
        "clients-psum": D.flatten_results("ref", study.run(
            sim=D.make_job_sim("cpu", optimizer=sgd(0.02)._replace(kind="")),
            params0=D.job_params0()).cells),
        "clients-fused": D.flatten_results("ref", study.run(
            sim=D.make_job_sim("cpu"), params0=D.job_params0()).cells)}
    results = run2["results"]
    for tag, ref in want.items():
        for cell in _cells(results, tag):
            for field in ("params", "loss", "participation", "finite",
                          "diverged"):
                np.testing.assert_array_equal(
                    results[f"{tag}|{cell}|{field}"],
                    ref[f"ref|{cell}|{field}"], err_msg=f"{tag}: {cell}/{field}")
            np.testing.assert_allclose(results[f"{tag}|{cell}|weight_sum"],
                                       ref[f"ref|{cell}|weight_sum"],
                                       rtol=1e-6, atol=0)


def test_compile_counts_and_replicated_params(run):
    reports = run["reports"]
    world = len(reports)
    assert [r["process_id"] for r in reports] == list(range(world))
    for rep in reports:
        assert rep["process_count"] == world and rep["backend"] == "gloo"
        assert rep["device"] == "cpu" and rep["threads"] >= 1
        for tag, combo in rep["combos"].items():
            assert combo["compiles"] == 2, (tag, combo)
            assert combo["warm_new_compiles"] == 0, (tag, combo)
            assert combo["mesh_process_span"] == world, (tag, combo)
            assert combo["downgrades"] == []
    for tag in reports[0]["combos"]:
        digests = {rep["combos"][tag]["params_sha256"] for rep in reports}
        assert len(digests) == 1, f"{tag}: params differ across ranks"
    shapes = {t: c["mesh_shape"] for t, c in reports[0]["combos"].items()}
    assert shapes["clients-gather"] == {"clients": world}
    assert shapes["cells"] == {"cells": world}
    if world == 4:
        assert shapes["grid-gather"] == {"cells": 2, "clients": 2}


# ------------------------------------------------------ against JAX

def _jax_job():
    master = D._quadratic("cpu")
    a, b = jnp.asarray(master.a.numpy()), jnp.asarray(master.b.numpy())
    w_star = jnp.asarray(master.w_star.numpy())
    kw = dict(grads_fn=lambda w, k, t: jnp.einsum("nij,j->ni", a, w) - b,
              p=jnp.asarray(master.p.numpy()),
              loss_fn=lambda w: jnp.sum((w - w_star) ** 2))
    return kw, jnp.full((D.JOB_DIM,), 4.0)


def _jax_study(steps):
    return (JE.Study("multihost_quadratic", num_steps=steps)
            .axis("scheduler", list(D.JOB_SCHEDULERS))
            .axis("arrivals", "periodic")
            .axis("n_clients", list(D.JOB_POPULATIONS))
            .axis("seeds", SEEDS))


@pytest.mark.parametrize("reduction", ["gather", "psum"])
def test_participation_bitwise_vs_jax_client_mesh(run, reduction):
    world = len(run["reports"])
    if jax.device_count() < world:
        pytest.skip(f"needs {world} jax devices (tests/conftest.py)")
    kw, w0 = _jax_job()
    steps = run["steps"]
    jres = _jax_study(steps).run(
        sim=JSim(optimizer=j_sgd(0.02), **kw), params0=w0,
        config=JE.ExecutionConfig(
            mesh=JE.make_client_mesh(world), client_reduction=reduction,
            eval_fn=jnp.sum, eval_every=steps))
    results = run["results"]
    for cell, jcell in jres.items():
        tag = f"clients-{reduction}|{cell}"
        np.testing.assert_array_equal(results[f"{tag}|participation"],
                                      np.asarray(jcell.history.participation))
        np.testing.assert_array_equal(results[f"{tag}|diverged"],
                                      np.asarray(jcell.diverged))
        for field, want in (("loss", jcell.history.loss),
                            ("params", jcell.params),
                            ("weight_sum", jcell.history.weight_sum)):
            np.testing.assert_allclose(results[f"{tag}|{field}"],
                                       np.asarray(want), **TOL)


def test_refusals_and_downgrade_match_jax(run2):
    """Faults under a clients axis and ``fused`` with momentum raise the
    JAX package's errors, and ``degrade=True`` records JAX's step down."""
    if jax.device_count() < 2:
        pytest.skip("needs 2 jax devices (tests/conftest.py)")
    kw, w0 = _jax_job()
    extra = [{k: v for k, v in e.items()
              if k not in ("aware_rows", "masked_shard")}
             for e in run2["extras"]]
    assert extra[0] == extra[1]
    mesh = JE.make_client_mesh(2)
    faulty = (JE.Study("faulty", num_steps=4).axis("scheduler", "alg1")
              .axis("arrivals", "periodic")
              .axis("faults", [None, ("drop", {"rate": 0.3})])
              .axis("seeds", 1))
    with pytest.raises(ValueError) as err:
        faulty.run(sim=JSim(optimizer=j_sgd(0.02), **kw), params0=w0,
                   config=JE.ExecutionConfig(mesh=mesh, eval_fn=jnp.sum))
    assert extra[0]["faults_error"] == str(err.value)
    study = (JE.Study("extra", num_steps=10).axis("scheduler", "alg2")
             .axis("arrivals", "binary").axis("n_clients", [5, 8])
             .axis("seeds", 2))
    heavy = JSim(optimizer=j_momentum(0.01, beta=0.9), **kw)
    down = study.run(sim=heavy, params0=w0, config=JE.ExecutionConfig(
        mesh=mesh, client_reduction="fused", degrade=True, eval_fn=jnp.sum))
    assert extra[0]["downgrades"] == [d.to_json() for d in down.downgrades]
    assert len(down.downgrades) == 1
    assert json.loads(extra[0]["downgrades"][0])["to_value"] == "psum"
    assert extra[0]["fused_momentum_error"] == \
        json.loads(extra[0]["downgrades"][0])["error"]
    assert extra[0]["downgraded_equals_psum"]


def test_legacy_carry_on_cells_and_clients_meshes_matches_jax(run):
    """The legacy per-leaf carry (``flat=False``): a cells mesh takes it,
    bit for bit the one-process study, its participation JAX's on the
    conftest's CPU devices; a clients mesh refuses it with the error
    the JAX package's step raises."""
    world = len(run["reports"])
    for extra in run["extras"]:
        assert extra["legacy_cells_bitwise"]
        assert extra["legacy_clients_error"] is not None
    if jax.device_count() < world:
        pytest.skip(f"needs {world} jax devices (tests/conftest.py)")
    kw, w0 = _jax_job()
    study = (JE.Study("extra", num_steps=10).axis("scheduler", "alg2")
             .axis("arrivals", "binary").axis("n_clients", [5, 8])
             .axis("seeds", 2))
    legacy = JSim(optimizer=j_sgd(0.02), flat=False, **kw)
    jres = study.run(sim=legacy, params0=w0, config=JE.ExecutionConfig(
        mesh=JE.make_cell_mesh(world)))
    for extra in run["extras"]:
        for name, cell in jres.items():
            np.testing.assert_array_equal(
                np.asarray(extra["legacy_participation"][name]),
                np.asarray(cell.history.participation))
    with pytest.raises(ValueError) as err:
        study.run(sim=legacy, params0=w0, config=JE.ExecutionConfig(
            mesh=JE.make_client_mesh(world)))
    assert run["extras"][0]["legacy_clients_error"] == str(err.value)


def test_client_keys_shard_local_equal_jax_global_rows():
    for seed in (0, 5):
        want = np.asarray(j_client_keys(jax.random.PRNGKey(seed), 8))
        for shards in (2, 4):
            n_local = 8 // shards
            for index in range(shards):
                with client_sharding("clients", shards, index=index):
                    got = client_keys(trandom.PRNGKey(seed, device="cpu"),
                                      n_local)
                np.testing.assert_array_equal(
                    got.numpy().astype(np.uint32),
                    want[index * n_local:(index + 1) * n_local])
    with pytest.raises(ValueError, match="shard index"):
        with client_sharding("clients", 2, index=2):
            pass


# --------------------------------------------------- kernels and rows

def test_all_masked_shard_gives_exact_zeros(run):
    world = len(run["reports"])
    shards = [e["masked_shard"] for e in run["extras"]]
    last = shards[-1]
    assert last["active_rows"] == 0 and last["local_zero"]
    assert last["rows"] == [8 - 8 // world, 8]
    assert sum(s["active_rows"] for s in shards) == (world - 1) * (8 // world) - 1
    for s in shards:
        assert s["k1_err"] <= 1e-6 and s["k2_err"] <= 1e-6
    # In one process too, on the plain versions the wrappers take on the
    # CPU: every row masked (and NaN) gives exact zeros, sharded or not.
    g = torch.full((4, 9), float("nan"))
    w = torch.rand(4)
    mask = torch.zeros(4)
    zero = torch.zeros(9)
    assert torch.equal(ops.masked_scaled_aggregate(g, w, mask=mask), zero)
    assert torch.equal(ops.masked_scaled_aggregate_update(g, w, 0.05, None,
                                                          mask), zero)
    assert torch.equal(ops.masked_scaled_aggregate_sharded(
        g, w, shard=ClientShard("clients", 1, "psum"), mask=mask), zero)


def test_flat_grads_rows_under_a_shard():
    """A plain grads_fn: whole under gather, this shard's rows under
    psum / fused; a client-aware one: called with the global rows."""
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    seen = []

    def plain(w, k, t):
        return full

    def aware(w, k, t, clients=None):
        seen.append(clients)
        return full[clients]

    spec = ravel_spec(torch.zeros(3))
    key = trandom.PRNGKey(0, device="cpu")
    for reduction, want in (("gather", full), ("psum", full[4:]),
                            ("fused_bf16", full[4:])):
        with client_sharding("clients", 2, reduction, index=1):
            got = make_flat_grads_fn(plain, spec, 8)(torch.zeros(3), key, 0)
        assert torch.equal(got, want)
    with client_sharding("clients", 4, "gather", index=2):
        got = make_flat_grads_fn(aware, spec, 8)(torch.zeros(3), key, 0)
    assert seen[0].tolist() == [4, 5] and torch.equal(got, full[4:6])


def test_single_cell_and_client_aware_runs(run):
    world = len(run["reports"])
    for extra in run["extras"]:
        assert extra["cell_gather_bitwise"]
        assert extra["cell_psum_params_diff"] <= 1e-6
        assert extra["cell_psum_participation_equal"]
        assert extra["aware_params_diff"] <= 1e-6
        assert extra["aware_participation_equal"]
    n_local = 8 // world
    assert [e["aware_rows"] for e in run["extras"]] == [
        list(range(r * n_local, (r + 1) * n_local)) for r in range(world)]


def test_launch_runs_again_when_the_port_is_taken(monkeypatch):
    """The coordinator port is free when picked but not held: when rank
    0 then finds it taken (EADDRINUSE), the launch runs once more on
    another port."""
    import socket

    held = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    held.bind(("127.0.0.1", 0))
    held.listen()
    picks = []
    free = D._free_port

    def pick():
        picks.append(held.getsockname()[1] if not picks else free())
        return picks[-1]

    monkeypatch.setattr(D, "_free_port", pick)
    rank = ("from repro_torch.launch import distributed as D; "
            "D.init_from_env(device='cpu'); D.stop_rank(); print('up')")
    try:
        done = D.launch_simulated(2, command=[sys.executable, "-c", rank],
                                  timeout=120)
    finally:
        held.close()
    assert len(picks) == 2 and picks[0] != picks[1]
    assert [p.stdout.strip() for p in done] == ["up", "up"]

