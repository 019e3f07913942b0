"""The port's checkpoints (``repro_torch.checkpoint``), on the CPU.

- ``save_pytree`` / ``restore_pytree`` round trip every dtype the port
  holds (bf16 through f32, exactly), a dict and a NamedTuple carry, with
  tensors back on the template's device and numpy leaves as numpy.
- The member names are the JAX package's (``a/b/0``, NamedTuple field
  names), read from the same tree by both packages.
- A structure or shape mismatch raises. A member whose dtype is not the
  one the port writes is cast to it when every value converts exactly
  (the JAX package's uint32 key words into the port's int64 ones); a
  lossy cast (a float into an int64 template, a word past int32) raises,
  naming the file and the leaf.
- A truncated npz and a corrupt member raise, naming the file and the
  leaf.
- ``CheckpointManager`` keeps ``keep`` files; a temp file left behind
  by a crash before the rename is ignored; ``write_json_atomic`` writes
  the whole document.
- A flat ``SimCarry`` saved mid-run (sgd, and adam with a stale-update
  ring in the carry) and restored continues bit for bit as one
  uninterrupted ``run_carry``.
"""

import json
import os
import zipfile
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.checkpoint import checkpoint as jckpt
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_pytree, save_pytree,
                                    write_json_atomic)
from repro_torch.core import ClientSimulator, StaleUpdates, make_quadratic
from repro_torch.core import make_arrivals, make_scheduler
from repro_torch.optim import adam, sgd


class Pair(NamedTuple):
    first: torch.Tensor
    second: tuple


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 4, generator=g),
        "f64": torch.randn(5, generator=g, dtype=torch.float64),
        "f16": torch.randn(2, 2, generator=g).half(),
        "bf16": torch.randn(7, generator=g).bfloat16(),
        "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "i64": torch.tensor([2 ** 40, -1]),
        "u8": torch.tensor([0, 255], dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(3.5),
        "carry": Pair(first=torch.ones(2), second=((), torch.zeros(1, 3),
                                                  None)),
        "host": np.arange(4, dtype=np.int16),
    }


def test_round_trip_keeps_dtypes_structure_and_devices(tmp_path):
    tree = _tree()
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree)
    template = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor)
                    else v) for k, v in tree.items()}
    template["carry"] = Pair(torch.zeros(2), ((), torch.zeros(1, 3), None))
    template["host"] = np.zeros(4, np.int16)
    got = restore_pytree(path, template)
    assert set(got) == set(tree)
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and got[k].device == v.device
            assert torch.equal(got[k], v), k
    assert isinstance(got["carry"], Pair) and got["carry"].second[0] == ()
    assert got["carry"].second[2] is None
    assert torch.equal(got["carry"].second[1], tree["carry"].second[1])
    assert isinstance(got["host"], np.ndarray) and got["host"].dtype == np.int16
    np.testing.assert_array_equal(got["host"], tree["host"])
    with np.load(path) as data:
        assert data["bf16"].dtype == np.float32  # npz holds no bf16


def test_member_names_are_the_jax_packages(tmp_path):
    arrays = {"a": np.ones(2, np.float32),
              "b": (np.zeros(1, np.int32), {"c": np.ones(3, np.float32)})}
    save_pytree(str(tmp_path / "t.npz"), {
        "a": torch.ones(2), "b": (torch.zeros(1, dtype=torch.int32),
                                  {"c": torch.ones(3)})})
    jckpt.save_pytree(str(tmp_path / "j.npz"),
                      jax.tree_util.tree_map(jnp.asarray, arrays))
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files) == ["a", "b/0", "b/1/c"]
        for name in t.files:
            np.testing.assert_array_equal(t[name], j[name])


def test_structure_shape_and_dtype_mismatch_raise(tmp_path):
    path = str(tmp_path / "t.npz")
    save_pytree(path, {"a": torch.ones(3), "k": torch.zeros(2,
                                                            dtype=torch.int64)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        restore_pytree(path, {"a": torch.ones(3), "b": torch.ones(1)})
    with pytest.raises(ValueError, match="shape mismatch for 'a'"):
        restore_pytree(path, {"a": torch.ones(4),
                              "k": torch.zeros(2, dtype=torch.int64)})
    # The JAX package keeps PRNG key words as uint32, the port as int64:
    # a checkpoint the JAX package wrote restores, each word exactly.
    jpath = str(tmp_path / "j.npz")
    words = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    jckpt.save_pytree(jpath, {"a": jnp.ones(3), "k": jnp.asarray(words)})
    got = restore_pytree(jpath, {"a": torch.ones(3),
                                 "k": torch.zeros(4, dtype=torch.int64)})
    assert got["k"].dtype == torch.int64
    assert got["k"].tolist() == words.tolist()
    # A lossy cast still raises, naming the file and the leaf: the words
    # do not fit int32, and a float leaf does not go into an int64 one.
    with pytest.raises(ValueError, match=r"j\.npz: dtype mismatch for 'k'"
                                         r".*do not fit int32"):
        restore_pytree(jpath, {"a": torch.ones(3),
                               "k": torch.zeros(4, dtype=torch.int32)})
    with pytest.raises(ValueError, match=r"j\.npz: dtype mismatch for 'a'"
                                         r".*float32 does not cast exactly"):
        restore_pytree(jpath, {"a": torch.zeros(3, dtype=torch.int64),
                               "k": torch.zeros(4, dtype=torch.int64)})


def test_truncated_and_corrupt_files_name_file_and_leaf(tmp_path):
    path = str(tmp_path / "t.npz")
    tree = {"alpha": torch.arange(4096, dtype=torch.float32),
            "beta": torch.ones(8)}
    save_pytree(path, tree)
    raw = open(path, "rb").read()
    trunc = str(tmp_path / "trunc.npz")
    with open(trunc, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(ValueError, match=r"trunc\.npz is unreadable"):
        restore_pytree(trunc, tree)
    # Flip bytes inside alpha's data: the member's CRC no longer holds.
    with zipfile.ZipFile(path) as z:
        info = z.getinfo("alpha.npy")
    bad = bytearray(raw)
    at = info.header_offset + 30 + len(info.filename) + 1000
    bad[at:at + 8] = b"\xff" * 8
    corrupt = str(tmp_path / "corrupt.npz")
    with open(corrupt, "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(ValueError, match=r"corrupt\.npz: leaf 'alpha' is "
                                         r"corrupt"):
        restore_pytree(corrupt, tree)


def test_retention_and_temp_files(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "g000"), keep=2)
    for step in (5, 10, 15, 20):
        mgr.save(step, {"w": torch.full((2,), float(step))})
    assert sorted(os.listdir(mgr.directory)) == ["step_15.npz", "step_20.npz"]
    # A crash between the temp write and the rename leaves a temp file
    # behind: it never counts as a checkpoint.
    with open(os.path.join(mgr.directory, "tmpabc123.tmp.npz"), "wb") as f:
        f.write(b"torn")
    assert latest_step(mgr.directory) == 20
    state, step = mgr.restore({"w": torch.zeros(2)})
    assert step == 20 and torch.equal(state["w"], torch.full((2,), 20.0))
    keep_all = CheckpointManager(str(tmp_path / "all"), keep=0)
    for step in range(4):
        keep_all.save(step, {"w": torch.zeros(1)})
    assert latest_step(keep_all.directory) == 3
    assert len(os.listdir(keep_all.directory)) == 4
    keep_all.delete()
    assert latest_step(keep_all.directory) is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_write_json_atomic(tmp_path):
    path = str(tmp_path / "d" / "manifest.json")
    write_json_atomic(path, {"b": [1, 2], "a": None})
    write_json_atomic(path, {"b": [3], "a": "x"})
    assert json.load(open(path)) == {"a": "x", "b": [3]}
    assert os.listdir(tmp_path / "d") == ["manifest.json"]


@pytest.mark.parametrize("opt,faults", [(sgd(0.02), None),
                                        (adam(0.05), StaleUpdates(0.5, 2))],
                         ids=["sgd", "adam-stale"])
def test_resumed_carry_equals_uninterrupted_run(tmp_path, opt, faults):
    n, dim = 8, 6
    problem = make_quadratic(trandom.PRNGKey(2, device="cpu"), n, dim=dim)
    sim = ClientSimulator(
        grads_fn=lambda w, k, t: problem.all_grads(w, key=k, noise=0.05),
        p=problem.p, optimizer=opt, loss_fn=problem.suboptimality,
        scheduler=make_scheduler("alg2", n),
        energy=make_arrivals("binary", n, 30), faults=faults,
        use_kernel=True, device="cpu")
    w0 = torch.full((dim,), 4.0)
    spec = sim.flat_spec(w0)
    key = trandom.PRNGKey(7, device="cpu")
    whole, hist = sim.run_carry(sim.init(key, w0, spec=spec), 20, spec=spec)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    half, first = sim.run_carry(sim.init(key, w0, spec=spec), 9, spec=spec)
    mgr.save(9, half)
    restored, step = mgr.restore(sim.init(trandom.PRNGKey(0, device="cpu"),
                                          w0, spec=spec))
    assert step == 9
    rest, second = sim.run_carry(restored, 11, spec=spec)
    got, want = tree_leaves(tuple(rest)), tree_leaves(tuple(whole))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b, c in zip(first, second, hist):
        assert torch.equal(torch.cat([a, b]), c)
    if faults is not None:
        assert rest.fault_state.shape == (2, n, dim)

