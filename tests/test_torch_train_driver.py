"""Port parity: the LM train driver (``repro_torch.launch.train``)
against the JAX package's ``repro.launch.train.main``.

A reduced stablelm (one ``attn_mlp`` layer, d_model 256, f32) trained by
both drivers on the CPU with the arguments of
``tests/test_resumable.py`` (alg1 on periodic arrivals, 4 clients), on 4
steps with a checkpoint every 2. JAX's ``main`` does not reach
``run_carry(donate=True)`` (ROADMAP R1).

Held: the loss stream against JAX's ``rtol=1e-4`` and the active
clients and Σω a step bitwise; a run halted after step 2 and resumed
equal to the straight run, its losses and its last checkpoint bit for
bit; a run halted in one package and resumed in the other, its loss
tail ``rtol=1e-4`` and its scheduler state, energy state and batch key
bitwise; the driver's refusals (no card, ``--resume`` without a
directory).
"""

import os

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

import repro.launch.train as j_train
from repro_torch.launch import train as t_train


STEPS, HALT = 4, 2


def _driver_args(ckdir, *extra):
    """``tests/test_resumable.py``'s arguments, on 4 steps with a
    checkpoint every 2 (that test runs 12, a checkpoint every 6)."""
    return ["--arch", "stablelm-1.6b", "--reduced",
            "--steps", str(STEPS), "--global-batch", "4",
            "--seq-len", "16", "--n-clients", "4",
            "--scheduler", "alg1", "--arrivals", "periodic",
            "--ckpt-every", str(HALT), "--checkpoint-dir", str(ckdir), *extra]


class _RecordingJax:
    """``jax`` for ``repro.launch.train``, with ``jax.jit`` recording the
    metrics every jitted train step returns."""

    def __init__(self, log):
        self._log = log

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def call(*args):
            out = jitted(*args)
            if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
                self._log.append({k: np.asarray(v) for k, v in out[1].items()})
            return out
        return call


def _jax_main(argv, monkeypatch):
    log = []
    with monkeypatch.context() as m:
        m.setattr(j_train, "jax", _RecordingJax(log))
        losses = j_train.main(argv)
    return losses, log


def _port_main(argv):
    log = []
    losses = t_train.main(argv + ["--device", "cpu"], on_step=lambda step, state, metrics: log.append(
        {k: v.numpy().copy() for k, v in metrics.items()}))
    return losses, log


@pytest.fixture(scope="module")
def jax_straight(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_straight")
    mp = pytest.MonkeyPatch()
    try:
        losses, log = _jax_main(_driver_args(d), mp)
    finally:
        mp.undo()
    return d, losses, log


def test_driver_matches_jax_main(jax_straight, tmp_path):
    _, jlosses, jlog = jax_straight
    losses, log = _port_main(_driver_args(tmp_path / "a"))
    assert len(losses) == len(jlosses) == STEPS
    assert len(log) == len(jlog) == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for got, want in zip(log, jlog):
        np.testing.assert_array_equal(got["active_clients"], want["active_clients"])
        np.testing.assert_array_equal(got["weight_sum"], want["weight_sum"])
    assert {float(m["active_clients"]) for m in log} != {4.0}  # alg1 masks


def test_driver_halt_and_resume_bitwise(tmp_path):
    straight, _ = _port_main(_driver_args(tmp_path / "a"))
    halted, _ = _port_main(_driver_args(tmp_path / "b", "--halt-at", str(HALT)))
    resumed, _ = _port_main(_driver_args(tmp_path / "b", "--resume"))
    assert len(straight) == STEPS and len(halted) == HALT
    assert len(resumed) == STEPS - HALT
    assert halted == straight[:HALT] and resumed == straight[HALT:]
    a = np.load(tmp_path / "a" / f"step_{STEPS}.npz")
    b = np.load(tmp_path / "b" / f"step_{STEPS}.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _loop_state(path):
    """The scheduler state, energy state and batch key of a driver
    checkpoint, by member name (the key words as int64)."""
    with np.load(path) as z:
        return {k: z[k].astype(np.int64) if k == "k_batch" else z[k]
                for k in z if not k.startswith("state/")}


def test_jax_halt_resumed_by_port(jax_straight, tmp_path, monkeypatch):
    d, jlosses, _ = jax_straight
    _jax_main(_driver_args(tmp_path, "--halt-at", str(HALT)), monkeypatch)
    resumed, _ = _port_main(_driver_args(tmp_path, "--resume"))
    assert len(resumed) == STEPS - HALT
    np.testing.assert_allclose(resumed, jlosses[HALT:], rtol=1e-4)
    last = f"step_{STEPS}.npz"
    got, want = _loop_state(tmp_path / last), _loop_state(d / last)
    assert sorted(got) == sorted(want) and "k_batch" in got
    assert any(k.startswith("sched_state/") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with np.load(tmp_path / last) as z, np.load(d / last) as w:
        assert sorted(z) == sorted(w)


def test_port_halt_resumed_by_jax(jax_straight, tmp_path, monkeypatch):
    d, jlosses, _ = jax_straight
    halted, _ = _port_main(_driver_args(tmp_path, "--halt-at", str(HALT)))
    np.testing.assert_allclose(halted, jlosses[:HALT], rtol=1e-4)
    resumed, _ = _jax_main(_driver_args(tmp_path, "--resume"), monkeypatch)
    assert len(resumed) == STEPS - HALT
    np.testing.assert_allclose(resumed, jlosses[HALT:], rtol=1e-4)
    last = f"step_{STEPS}.npz"
    got, want = _loop_state(tmp_path / last), _loop_state(d / last)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_driver_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "1"])
    from importlib import util
    spec = util.spec_from_file_location(
        "train_lm_example", os.path.join(os.path.dirname(__file__), "..",
                                         "examples_torch", "train_lm.py"))
    example = util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main(["--steps", "1"])


def test_driver_refuses_resume_without_a_directory():
    with pytest.raises(SystemExit, match="--checkpoint-dir"):
        t_train.main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "1",
                      "--resume", "--device", "cpu"])
