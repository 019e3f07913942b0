"""Port parity for the Study API, its registered studies and the two
milestones that run through it.

Against the JAX package, on the same inputs:

- Names: for all five registered studies, at their defaults and with one
  non-default argument set, ``resolve()`` gives the same cells (name,
  scheduler, arrivals, n_clients, horizon, taus, kwargs) and the cells
  build the same component tables; the registries (axes, studies,
  grids) list the same names; unknown names raise the same
  ``ValueError``.
- Numerics: ``fig1``, ``capacity_sweep``, ``day_night`` and
  ``population_scaling`` (N_cap 16, n ∈ {4, 8, 16}) on a quadratic with
  16 clients, dim 8, 40 steps, 2 seeds, through the kernels' plain
  versions (``use_kernel=True``) on the CPU. The JAX reference is its
  own ``Study.run`` on the ``eval_fn`` route (its plain ``run`` trips
  ROADMAP caveat R1). Participation and ``diverged`` bit for bit;
  ``loss``, ``weight_sum``, final params and evals within
  ``rtol=1e-5, atol=1e-6`` (XLA and torch sum the gradients' products in
  different orders).
- Milestone 1: ``examples_torch/quickstart.py --device cpu`` at reduced
  steps ends with Algorithm 1 below both benchmarks;
  ``benchmarks_torch/theory.py``'s rows match the JAX package's
  per-seed reference on the same problem (bound ``rtol=1e-5``; the
  empirical suboptimality ``rtol=1e-5`` plus ``1e-5·|F(w*)|``, since
  F(w) − F(w*) is resolved only to the scale of F(w*)), and the
  ``holds`` flags are equal.
- Milestone 2: ``examples_torch/paper_cifar.py --device cpu`` runs a
  short grid through the port's ``get_study("fig1")`` and writes its CSV.

And inside the port: ``Study.simulator`` memoizes and is bounded at
``SIM_CACHE_SIZE``; a mesh that is not the port's rank mesh raises
``TypeError`` before any step, manifests round-trip,
``checkpoint_dir`` runs and equals the unchunked study bit for bit, and
with a mesh it raises JAX's ``ValueError``; with no card and no
``device=``, the study, the examples, the benches and the serve launcher
raise.
"""

import csv
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro import experiments as JE
from repro.core import convergence as jconv
from repro.optim import sgd as j_sgd
from repro_torch import experiments as TE
from repro_torch._tree import tree_leaves
from repro_torch.core import convergence as tconv
from repro_torch.optim import sgd as t_sgd

ROOT = Path(__file__).resolve().parents[1]
N_CAP, DIM, T, SEEDS, EVAL_EVERY = 16, 8, 40, 2, 20
W0 = np.full((DIM,), 5.0, np.float32)


def _torch_problem(jprob):
    return tconv.QuadraticProblem(
        a=torch.tensor(np.asarray(jprob.a)), b=torch.tensor(np.asarray(jprob.b)),
        p=torch.tensor(np.asarray(jprob.p)),
        w_star=torch.tensor(np.asarray(jprob.w_star)),
        mu=jprob.mu, lsmooth=jprob.lsmooth)


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        rel.replace("/", "_").removesuffix(".py"), ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------- names

NAME_CASES = [
    ("fig1", {}), ("fig1", {"n_clients": 12, "taus_profile": [1, 2, 4],
                            "seeds": 3}),
    ("fig1_grid", {}), ("fig1_grid", {"num_steps": 50,
                                      "taus_profile": (2, 3)}),
    ("capacity_sweep", {}), ("capacity_sweep", {"capacities": (0.5, 1.5),
                                                "n_clients": 6}),
    ("day_night", {}), ("day_night", {"period": 20, "contrast": 2.0,
                                      "num_steps": 30}),
    ("population_scaling", {}), ("population_scaling",
                                 {"n_clients": (3, 9), "seeds": [4, 5]}),
]


@pytest.mark.parametrize("name,kw", NAME_CASES,
                         ids=[f"{n}-{'custom' if kw else 'default'}"
                              for n, kw in NAME_CASES])
def test_study_resolves_like_jax(name, kw):
    js, ts = JE.get_study(name, **kw), TE.get_study(name, **kw)
    assert (ts.name, ts.num_steps, ts.seeds(), ts._seed_values()) == (
        js.name, js.num_steps, js.seeds(), js._seed_values())
    assert list(ts.axes) == list(js.axes)
    jcells, tcells = js.resolve(), ts.resolve()
    assert [c.name for c in tcells] == [c.name for c in jcells]
    for tc, jc in zip(tcells, jcells):
        for field in ("scheduler", "arrivals", "n_clients", "horizon",
                      "scheduler_kwargs", "arrival_kwargs", "faults"):
            assert getattr(tc, field) == getattr(jc, field), field
        np.testing.assert_array_equal(np.asarray(tc.taus), np.asarray(jc.taus))
        (tsched, ten), (jsched, jen) = tc.build(), jc.build()
        assert type(tsched).__name__ == type(jsched).__name__
        assert tsched.n_clients == jsched.n_clients
        for field, value in vars(ten).items():
            want = np.asarray(getattr(jen, field))
            np.testing.assert_array_equal(np.asarray(value), want, field)


def test_registries_match_jax():
    assert TE.axis_names() == JE.axis_names()
    assert TE.AXIS_ORDER == JE.axes.AXIS_ORDER
    assert TE.study_names() == JE.study_names()
    assert TE.grid_names() == JE.grid_names()
    tg = TE.get_grid("fig1", n_clients=8, horizon=31, taus=[1, 3])
    jg = JE.get_grid("fig1", n_clients=8, horizon=31, taus=[1, 3])
    assert [(c.name, c.horizon) for c in tg] == [(c.name, c.horizon) for c in jg]
    tl = TE.scenario_grid(["alg1", "oracle"], ["binary"], 4, 9)
    jl = JE.scenario_grid(["alg1", "oracle"], ["binary"], 4, 9)
    assert [c.name for c in tl] == [c.name for c in jl]


@pytest.mark.parametrize("call", [
    lambda E: E.get_study("nope"),
    lambda E: E.get_grid("nope"),
    lambda E: E.get_axis("nope"),
    lambda E: E.Study("s", num_steps=5).axis("nope", 1),
    lambda E: E.Study("s", num_steps=5, axes={
        "scheduler": "alg1", "arrivals": "periodic",
        "taus_profile": "nope"}).resolve(),
    lambda E: E.Study("s", num_steps=5, axes={
        "scheduler": "nope", "arrivals": "periodic"}).resolve()[0].build(),
    lambda E: E.Study("s", num_steps=5, axes={
        "scheduler": "alg1", "arrivals": "nope"}).resolve()[0].build(),
    lambda E: E.Study("s", num_steps=5, axes={"scheduler": "alg1"}).resolve(),
], ids=["study", "grid", "axis", "axis-chained", "taus-profile", "scheduler",
        "arrivals", "missing-axes"])
def test_unknown_names_raise_like_jax(call):
    with pytest.raises(ValueError) as je:
        call(JE)
    with pytest.raises(ValueError) as te:
        call(TE)
    assert str(te.value) == str(je.value)
    assert "have" in str(te.value)


# -------------------------------------------------------------- numerics

NUMERIC_CASES = {
    "fig1": {"n_clients": N_CAP},
    "capacity_sweep": {"n_clients": N_CAP, "capacities": (1.0, 2.5)},
    "day_night": {"n_clients": N_CAP, "period": 10},
    "population_scaling": {"n_clients": (4, 8, 16)},
}


@pytest.fixture(scope="module")
def problems():
    jprob = jconv.make_quadratic(jax.random.PRNGKey(0), N_CAP, dim=DIM,
                                 hetero=1.0)
    return jprob, _torch_problem(jprob)


@pytest.fixture(scope="module")
def jax_runs(problems):
    """JAX's result of each numeric study, computed once."""
    jprob, _ = problems
    cache = {}

    def get(name):
        if name not in cache:
            study = JE.get_study(name, num_steps=T, seeds=SEEDS,
                                 **NUMERIC_CASES[name])
            cache[name] = study.run(
                grads_fn=lambda w, k, t: jprob.all_grads(w, key=k, noise=0.05),
                p=jprob.p, optimizer=j_sgd(0.01),
                loss_fn=jprob.suboptimality, params0=jnp.asarray(W0),
                config=JE.ExecutionConfig(
                    eval_fn=lambda w: {"subopt": jprob.suboptimality(w)},
                    eval_every=EVAL_EVERY))
        return cache[name]

    return get


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(NUMERIC_CASES))
def test_study_numerics_match_jax(name, problems, jax_runs):
    _, tprob = problems
    study = TE.get_study(name, num_steps=T, seeds=SEEDS, **NUMERIC_CASES[name])
    tr = study.run(
        grads_fn=lambda w, k, t: tprob.all_grads(w, key=k, noise=0.05),
        p=tprob.p, optimizer=t_sgd(0.01), loss_fn=tprob.suboptimality,
        params0=torch.from_numpy(W0), use_kernel=True, device="cpu",
        config=TE.ExecutionConfig(
            eval_fn=lambda w: {"subopt": tprob.suboptimality(w)},
            eval_every=EVAL_EVERY))
    jr = jax_runs(name)
    assert list(tr) == list(jr) and tr.axes == jr.axes
    for cell in tr:
        t, j = tr[cell], jr[cell]
        assert tr.labels(cell) == jr.labels(cell)
        np.testing.assert_array_equal(t.history.participation.numpy(),
                                      np.asarray(j.history.participation))
        np.testing.assert_array_equal(t.diverged.numpy(), np.asarray(j.diverged))
        np.testing.assert_array_equal(t.history.finite.numpy(),
                                      np.asarray(j.history.finite))
        for got, want in ((t.history.loss, j.history.loss),
                          (t.history.weight_sum, j.history.weight_sum),
                          (t.params, j.params),
                          (t.evals["subopt"], j.evals["subopt"])):
            _close(got, want)
    if name == "population_scaling":
        assert [tr[c].history.participation.shape[-1] for c in tr] == [4, 8, 16]
    assert tr.divergence() == jr.divergence()


# ------------------------------------------------------ caches, refusals


def test_simulator_memoized_and_bounded(problems):
    _, tprob = problems
    study = TE.get_study("fig1", n_clients=N_CAP, num_steps=3, seeds=1)
    grads = lambda w, k, t: tprob.all_grads(w)
    opt = t_sgd(0.01)
    a = study.simulator(grads_fn=grads, p=tprob.p, optimizer=opt, device="cpu")
    b = study.simulator(grads_fn=grads, p=tprob.p.clone(), optimizer=opt,
                        device="cpu")
    assert a is b and a.device == torch.device("cpu")
    study.run(grads_fn=grads, p=tprob.p, optimizer=opt,
              params0=torch.from_numpy(W0), device="cpu")
    assert study.cache_stats() == {"hits": 2, "misses": 1, "evictions": 0,
                                   "size": 1, "maxsize": TE.SIM_CACHE_SIZE}
    for i in range(TE.SIM_CACHE_SIZE + 2):
        study.simulator(grads_fn=grads, p=tprob.p, optimizer=t_sgd(0.1 + i),
                        device="cpu")
    stats = study.cache_stats()
    assert stats["size"] == TE.SIM_CACHE_SIZE and stats["evictions"] == 3
    assert study.clear_cache() == stats and study.cache_stats()["size"] == 0


def test_refusals_name_their_roadmap_step(problems, tmp_path):
    _, tprob = problems
    study = TE.get_study("fig1", n_clients=N_CAP, num_steps=3, seeds=1)
    kw = dict(grads_fn=lambda w, k, t: tprob.all_grads(w), p=tprob.p,
              optimizer=t_sgd(0.01), params0=torch.from_numpy(W0),
              device="cpu")
    # Placement is ported: a mesh must be the port's rank mesh, and is
    # checked before any step runs.
    with pytest.raises(TypeError, match="placement.Mesh"):
        study.run(config=TE.ExecutionConfig(mesh=object()), **kw)
    # checkpoint_dir is ported: it runs, and with a mesh it is refused
    # as the JAX package refuses it.
    ckpt = study.run(config=TE.ExecutionConfig(
        checkpoint_dir=str(tmp_path / "ckpt")), **kw)
    plain = study.run(**kw)
    for cell in plain:
        for x, y in zip(tree_leaves(tuple(ckpt[cell])),
                        tree_leaves(tuple(plain[cell]))):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match=r"incompatible with \['mesh'\]"):
        study.run(config=TE.ExecutionConfig(
            checkpoint_dir=str(tmp_path / "m"), mesh=object()), **kw)
    # Manifests are ported: the study and its config round-trip, and an
    # envelope without a format is refused by its decoder.
    cfg = TE.ExecutionConfig(checkpoint_every=5)
    assert TE.ExecutionConfig.from_json(cfg.to_json()) == cfg
    assert TE.Study.from_json(study.to_json()).to_manifest() == \
        study.to_manifest()
    for call in (lambda: TE.ExecutionConfig.from_manifest({}),
                 lambda: TE.ExecutionConfig.from_json("{}"),
                 lambda: TE.Study.from_manifest({}),
                 lambda: TE.Study.from_json("{}")):
        with pytest.raises(ValueError, match="unsupported format None"):
            call()


def test_no_card_and_no_device_raises(problems, monkeypatch, tmp_path):
    """Nothing falls back to the CPU by itself: without a card, the
    study, the examples and the bench raise unless given a device."""
    _, tprob = problems
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    study = TE.get_study("fig1", n_clients=N_CAP, num_steps=3, seeds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        study.run(grads_fn=lambda w, k, t: tprob.all_grads(w), p=tprob.p,
                  optimizer=t_sgd(0.01), params0=torch.from_numpy(W0))
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.run_grid(study.resolve(), grads_fn=lambda w, k, t: w, p=tprob.p,
                    optimizer=t_sgd(0.01), params0=torch.from_numpy(W0),
                    num_steps=3)
    for rel, argv in (("examples_torch/quickstart.py", []),
                      ("examples_torch/paper_cifar.py",
                       ["--out", str(tmp_path / "x.csv")]),
                      ("benchmarks_torch/theory.py", []),
                      ("examples_torch/serve_batch.py", []),
                      ("benchmarks_torch/serve_bench.py", ["--fast"]),
                      ("src/repro_torch/launch/serve.py", ["--demo"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            _load(rel).main(argv)
    assert not (tmp_path / "x.csv").exists()


# ------------------------------------------------------------ milestones


def test_quickstart_alg1_beats_both_benchmarks():
    finals = _load("examples_torch/quickstart.py").main(
        ["--device", "cpu", "--steps", "150", "--seeds", "2"])
    assert finals["alg1"] < finals["benchmark1"]
    assert finals["alg1"] < finals["benchmark2"]
    assert finals["oracle"] < finals["alg1"]


def test_theory_rows_match_jax_reference():
    steps, seeds = 100, 2
    jprob = jconv.make_quadratic(jax.random.PRNGKey(3), 8, dim=8, hetero=0.5)
    theory = _load("benchmarks_torch/theory.py")
    got = theory.measure("cpu", problem=_torch_problem(jprob), steps=steps,
                         seeds=seeds)
    # The JAX bench's computation on the same problem, per seed through
    # its engine's eval_fn route (its plain run trips caveat R1).
    taus = [theory.TAUS[i % 4] for i in range(8)]
    study = JE.Study("theorem1", num_steps=steps, axes={
        "scheduler": "alg1", "arrivals": "periodic", "n_clients": 8,
        "taus_profile": taus, "seeds": seeds})
    eta_max = jconv.max_step_size(jprob.mu, jprob.lsmooth)
    radius = float(jnp.linalg.norm(jprob.w_star)) + 10.0
    g2 = jprob.grad_second_moment_bound(radius)
    c = float(jconv.variance_constant(jprob.p, jnp.asarray(taus, jnp.float32), g2))
    w0 = jnp.full((8,), 5.0)
    f0 = float(jprob.suboptimality(w0))
    f_star = abs(float(jprob.global_loss(jprob.w_star)))
    assert [r["frac"] for r in got] == list(theory.FRACS)
    for rec in got:
        eta = rec["frac"] * eta_max
        res = study.run(grads_fn=lambda p, k, t: jprob.all_grads(p),
                        p=jprob.p, optimizer=j_sgd(eta),
                        loss_fn=jprob.suboptimality, params0=w0,
                        config=JE.ExecutionConfig(eval_fn=jnp.sum,
                                                  eval_every=steps))
        per_seed = np.asarray(res["alg1_periodic"].history.loss)[:, -100:].mean(-1)
        s = JE.seed_stats(per_seed)
        bound = float(jconv.theorem1_bound(steps, f0, jprob.mu, jprob.lsmooth,
                                           eta, c))
        np.testing.assert_allclose(rec["eta"], eta, rtol=1e-6)
        np.testing.assert_allclose(rec["empirical"], s["mean"], rtol=1e-5,
                                   atol=1e-5 * f_star)
        np.testing.assert_allclose(rec["bound"], bound, rtol=1e-5)
        assert (rec["seeds"], rec["n_nan"]) == (s["n_seeds"], s["n_nan"])
        assert rec["holds"] == (s["mean"] <= bound)
    rows = theory.rows(got)
    assert [r.split(",")[0] for r in rows] == [
        f"theorem1_eta{f}" for f in theory.FRACS]
    assert all("holds=" in r and "bound=" in r for r in rows)


def test_paper_cifar_runs_and_writes_csv(tmp_path):
    out = tmp_path / "fig1.csv"
    final = _load("examples_torch/paper_cifar.py").main(
        ["--device", "cpu", "--iters", "10", "--eval-every", "5",
         "--out", str(out)])
    rows = list(csv.DictReader(out.open()))
    assert [(r["method"], r["iteration"]) for r in rows] == [
        (m, it) for m in ("alg1", "benchmark1", "benchmark2", "oracle")
        for it in ("5", "10")]
    assert all(0.0 <= float(r["test_accuracy"]) <= 1.0 for r in rows)
    assert set(final) == {"alg1", "benchmark1", "benchmark2", "oracle"}
