"""Preemption-safe study execution in the port
(``repro_torch.experiments.execute_cells_resumable``), on the CPU.

Against the JAX package's own ``execute_cells_resumable`` (it does not
reach ROADMAP caveat R1), on the quadratic problem of
``tests/test_resumable.py`` — N = 8, dim 6, 30 steps; one fault-free
cell, one ``drop`` cell, one ragged n = 6 cell — with
``checkpoint_every`` 0 and 7: participation, ``finite`` and
``diverged`` bit for bit; ``loss``, ``weight_sum`` and params within
``rtol=1e-5, atol=1e-6`` (the packages sum the gradients' products in
different orders). The manifests are equal, fingerprint included, and
``study_fingerprint`` gives JAX's hex digest for a flat and a dict
``params0`` (bf16 leaf included). A halted study (``halt_on_divergence``)
pads its tail as JAX does.

Inside the port, bit for bit: chunked equals unchunked equals
``execute_cells``; a finished directory replays without running a step;
a fingerprint mismatch refuses; a run killed with SIGKILL after a
checkpoint (a subprocess, ``device="cpu"``) and resumed equals the
uninterrupted run; ``Study.run`` with ``checkpoint_dir`` equals it
without.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.core import make_quadratic as j_make_quadratic
from repro.core.trainer import ClientSimulator as JSim
from repro.experiments import engine as jengine
from repro.optim import sgd as j_sgd
from repro_torch import experiments as TE
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves
from repro_torch.core import ClientSimulator as TSim
from repro_torch.core import make_quadratic as t_make_quadratic
from repro_torch.optim import sgd as t_sgd

ROOT = Path(__file__).resolve().parents[1]
N, DIM, STEPS = 8, 6, 30


def _scenarios(E, extra=()):
    return [
        E.Scenario(name="alg1_per", scheduler="alg1", arrivals="periodic",
                   n_clients=N, horizon=STEPS + 1),
        E.Scenario(name="alg1_drop", scheduler="alg1", arrivals="periodic",
                   n_clients=N, horizon=STEPS + 1, faults="drop",
                   fault_kwargs={"rate": 0.3}),
        E.Scenario(name="bench_bin", scheduler="benchmark1",
                   arrivals="binary", n_clients=6, horizon=STEPS + 1),
        *extra]


def _poison(E):
    return E.Scenario(name="poison", scheduler="alg1", arrivals="periodic",
                      n_clients=N, horizon=STEPS + 1, faults="corrupt",
                      fault_kwargs={"rate": 1.0, "scale": float("nan")})


@pytest.fixture(scope="module")
def jsim():
    problem = j_make_quadratic(jax.random.PRNGKey(2), n_clients=N, dim=DIM)
    return JSim(grads_fn=lambda p, k, t: problem.all_grads(p, key=k,
                                                           noise=0.05),
                p=problem.p, optimizer=j_sgd(0.02),
                loss_fn=problem.suboptimality)


def _port_sim(counter=None):
    problem = t_make_quadratic(trandom.PRNGKey(2, device="cpu"), N, dim=DIM)

    def grads(p, k, t):
        if counter is not None:
            counter.append(1)
        return problem.all_grads(p, key=k, noise=0.05)

    return TSim(grads_fn=grads, p=problem.p, optimizer=t_sgd(0.02),
                loss_fn=problem.suboptimality, use_kernel=True, device="cpu")


@pytest.fixture(scope="module")
def tsim():
    return _port_sim()


def _w0(E):
    return jnp.full((DIM,), 4.0) if E is jengine else torch.full((DIM,), 4.0)


def _assert_bitwise(a, b):
    assert list(a) == list(b)
    for name in a:
        la, lb = tree_leaves(tuple(a[name])), tree_leaves(tuple(b[name]))
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y), name


def _assert_like_jax(tres, jres):
    assert list(tres) == list(jres)
    for name in tres:
        t, j = tres[name], jres[name]
        assert t.evals is None and j.evals is None
        for got, want in ((t.history.participation, j.history.participation),
                          (t.history.finite, j.history.finite),
                          (t.diverged, j.diverged)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
        for got, want in ((t.history.loss, j.history.loss),
                          (t.history.weight_sum, j.history.weight_sum),
                          (t.params, j.params)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("every", [0, 7])
def test_matches_jax_resumable(jsim, tsim, tmp_path, every):
    kw = dict(num_steps=STEPS, seeds=3, checkpoint_every=every)
    jres = jengine.execute_cells_resumable(
        _scenarios(jengine), sim=jsim, params0=_w0(jengine),
        checkpoint_dir=str(tmp_path / "j"), **kw)
    tres = TE.execute_cells_resumable(
        _scenarios(TE), sim=tsim, params0=_w0(TE),
        checkpoint_dir=str(tmp_path / "t"), **kw)
    _assert_like_jax(tres, jres)
    jman = json.load(open(tmp_path / "j" / "manifest.json"))
    tman = json.load(open(tmp_path / "t" / "manifest.json"))
    assert tman == jman
    for gid in tman["groups"]:
        assert sorted(os.listdir(tmp_path / "t" / gid)) == \
            sorted(os.listdir(tmp_path / "j" / gid))
        step = tman["groups"][gid]["step"]
        with np.load(tmp_path / "t" / gid / f"step_{step}.npz") as t, \
                np.load(tmp_path / "j" / gid / f"step_{step}.npz") as j:
            assert sorted(t.files) == sorted(j.files)
            for name in t.files:
                assert t[name].shape == j[name].shape, name


def test_halted_study_matches_jax(jsim, tsim, tmp_path):
    kw = dict(num_steps=STEPS, seeds=2, checkpoint_every=10,
              halt_on_divergence=True)
    jres = jengine.execute_cells_resumable(
        _scenarios(jengine)[:1] + [_poison(jengine)], sim=jsim,
        params0=_w0(jengine), checkpoint_dir=str(tmp_path / "j"), **kw)
    tres = TE.execute_cells_resumable(
        _scenarios(TE)[:1] + [_poison(TE)], sim=tsim, params0=_w0(TE),
        checkpoint_dir=str(tmp_path / "t"), **kw)
    _assert_like_jax(tres, jres)
    hist = tres["poison"].history
    assert hist.loss.shape[-1] == STEPS and not bool(hist.finite.any())
    assert bool(torch.isnan(hist.loss[..., 10:]).all())
    assert bool(torch.isnan(hist.participation[..., 10:, :]).all())
    assert tres["poison"].diverged.tolist() == [0, 0]
    tman = json.load(open(tmp_path / "t" / "manifest.json"))
    assert tman == json.load(open(tmp_path / "j" / "manifest.json"))
    assert [g["step"] for g in tman["groups"].values() if g["halted"]] == [10]
    ref = TE.execute_cells(_scenarios(TE)[:1], sim=tsim, params0=_w0(TE),
                           num_steps=STEPS, seeds=2)
    _assert_bitwise({"alg1_per": tres["alg1_per"]}, ref)


def test_fingerprint_matches_jax():
    for E in (jengine, TE):
        assert E.MANIFEST_FORMAT == "study-manifest/v1"
    seeds = [0, 4, 9]
    flat = np.linspace(-1, 1, 11).astype(np.float32)
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.array([1.5, -2.0], np.float32),
            "h": np.array([0.1, 3.0, -7.0], np.float32)}
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    jtree["h"] = jtree["h"].astype(jnp.bfloat16)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    ttree["h"] = ttree["h"].bfloat16()
    extra = lambda E: (E.Scenario(  # noqa: E731
        name="x", scheduler="battery_adaptive", arrivals="day_night",
        n_clients=5, horizon=STEPS + 1, taus=np.array([1, 2, 3, 4, 5]),
        scheduler_kwargs={"capacity": 2.5}, arrival_kwargs={"period": 10},
        faults="stale", fault_kwargs={"rate": 0.25, "delay": 2}),)
    for jp, tp in ((jnp.asarray(flat), torch.from_numpy(flat)),
                   (jtree, ttree)):
        want = jengine.study_fingerprint(_scenarios(jengine, extra(jengine)),
                                         STEPS, seeds, jp)
        got = TE.study_fingerprint(_scenarios(TE, extra(TE)), STEPS, seeds,
                                   tp)
        assert got == want
    assert TE.study_fingerprint(_scenarios(TE), STEPS, seeds, ttree) != \
        TE.study_fingerprint(_scenarios(TE), STEPS + 1, seeds, ttree)


def test_chunked_equals_unchunked_equals_plain(tsim, tmp_path):
    kw = dict(sim=tsim, params0=_w0(TE), num_steps=STEPS, seeds=3)
    ref = TE.execute_cells(_scenarios(TE), **kw)
    one = TE.execute_cells_resumable(
        _scenarios(TE), checkpoint_dir=str(tmp_path / "one"), **kw)
    chunked = TE.execute_cells_resumable(
        _scenarios(TE), checkpoint_dir=str(tmp_path / "chunk"),
        checkpoint_every=7, keep=2, **kw)
    _assert_bitwise(one, ref)
    _assert_bitwise(chunked, ref)
    assert sorted(os.listdir(tmp_path / "chunk" / "g000")) == [
        "step_28.npz", "step_30.npz"]


def test_finished_directory_replays_without_advancing(tmp_path):
    calls, seen = [], []
    sim = _port_sim(calls)
    kw = dict(sim=sim, params0=_w0(TE), num_steps=STEPS, seeds=2,
              checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=10)
    first = TE.execute_cells_resumable(_scenarios(TE), **kw)
    ran = len(calls)
    assert ran == 3 * 2 * STEPS
    again = TE.execute_cells_resumable(
        _scenarios(TE), progress=lambda *a: seen.append(a), **kw)
    assert len(calls) == ran, "a finished directory ran steps"
    _assert_bitwise(again, first)
    manifest = json.load(open(tmp_path / "ck" / "manifest.json"))
    assert set(manifest) == {"format", "fingerprint", "num_steps",
                             "checkpoint_every", "groups"}
    assert manifest["format"] == TE.MANIFEST_FORMAT
    assert manifest["num_steps"] == STEPS
    assert manifest["checkpoint_every"] == 10
    assert all(g["step"] == STEPS and not g["halted"]
               for g in manifest["groups"].values())
    assert seen == [(gid, STEPS, STEPS) for gid in manifest["groups"]]


def test_fingerprint_mismatch_and_unported_options_refuse(tsim, tmp_path):
    kw = dict(sim=tsim, num_steps=STEPS, seeds=2,
              checkpoint_dir=str(tmp_path / "ck"))
    first = TE.execute_cells_resumable(_scenarios(TE), params0=_w0(TE), **kw)
    with pytest.raises(ValueError, match="fingerprint"):
        TE.execute_cells_resumable(_scenarios(TE), params0=_w0(TE) + 1.0,
                                   **kw)
    # The executable cache is ported: a finished directory replays
    # through it, bit for bit and without running a chunk.
    from repro_torch.serve import ExecutableCache

    cache = ExecutableCache()
    again = TE.execute_cells_resumable(_scenarios(TE), params0=_w0(TE),
                                       executable_cache=cache, **kw)
    _assert_bitwise(again, first)
    assert cache.stats()["compiles"] == 0


def test_study_checkpointed_run(tsim, tmp_path):
    study = (TE.Study("resume", num_steps=STEPS)
             .axis("scheduler", "alg1").axis("arrivals", "periodic")
             .axis("faults", [None, ("drop", {"rate": 0.3}),
                              ("stale", {"rate": 0.5, "delay": 3})])
             .axis("seeds", 2))
    plain = study.run(sim=tsim, params0=_w0(TE))
    ck = study.run(sim=tsim, params0=_w0(TE), config=TE.ExecutionConfig(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=8))
    _assert_bitwise(dict(ck.items()), dict(plain.items()))
    assert ck.axes == plain.axes and ck.downgrades == ()
    for conflict in ({"sequential": True}, {"eval_fn": lambda w: w}):
        with pytest.raises(ValueError, match="incompatible"):
            study.run(sim=tsim, params0=_w0(TE), config=TE.ExecutionConfig(
                checkpoint_dir=str(tmp_path / "c"), **conflict))


_CHILD = textwrap.dedent("""
    import os, signal, sys
    import torch
    from repro_torch import random as trandom
    from repro_torch.core import ClientSimulator, make_quadratic
    from repro_torch.experiments import Scenario, execute_cells_resumable
    from repro_torch.optim import sgd

    ckdir, kill_after = sys.argv[1], int(sys.argv[2])
    N, DIM, STEPS = 8, 6, 30
    problem = make_quadratic(trandom.PRNGKey(2, device="cpu"), N, dim=DIM)
    sim = ClientSimulator(
        grads_fn=lambda p, k, t: problem.all_grads(p, key=k, noise=0.05),
        p=problem.p, optimizer=sgd(0.02), loss_fn=problem.suboptimality,
        use_kernel=True, device="cpu")
    scenarios = [
        Scenario(name="alg1_per", scheduler="alg1", arrivals="periodic",
                 n_clients=N, horizon=STEPS + 1),
        Scenario(name="alg1_drop", scheduler="alg1", arrivals="periodic",
                 n_clients=N, horizon=STEPS + 1, faults="drop",
                 fault_kwargs={"rate": 0.3}),
        Scenario(name="bench_bin", scheduler="benchmark1",
                 arrivals="binary", n_clients=6, horizon=STEPS + 1),
    ]
    saved = []

    def progress(gid, step, num_steps):
        if step > 0:
            saved.append(step)
        if len(saved) >= kill_after:
            os.kill(os.getpid(), signal.SIGKILL)

    execute_cells_resumable(
        scenarios, sim=sim, params0=torch.full((DIM,), 4.0),
        num_steps=STEPS, seeds=2, checkpoint_dir=ckdir, checkpoint_every=7,
        progress=progress)
    print("finished without being killed")
""")


@pytest.mark.parametrize("kill_after", [2, 6])
def test_kill9_and_resume_bitwise(tsim, tmp_path, kill_after):
    """SIGKILL after the ``kill_after``-th checkpoint — inside the first
    group (2) or in the second group (6, after the first finished) —
    then resume: bitwise the uninterrupted run."""
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    child = subprocess.run([sys.executable, "-c", _CHILD, ck, str(kill_after)],
                           env=env, capture_output=True, text=True,
                           timeout=180)
    assert child.returncode == -signal.SIGKILL, child.stderr
    manifest = json.load(open(os.path.join(ck, "manifest.json")))
    done = [g["step"] for g in manifest["groups"].values()]
    assert 0 < sum(done) < STEPS * len(done)
    kw = dict(sim=tsim, params0=_w0(TE), num_steps=STEPS, seeds=2,
              checkpoint_every=7)
    resumed = TE.execute_cells_resumable(_scenarios(TE), checkpoint_dir=ck,
                                         **kw)
    whole = TE.execute_cells_resumable(
        _scenarios(TE), checkpoint_dir=str(tmp_path / "whole"), **kw)
    _assert_bitwise(resumed, whole)
