"""Port parity: the expert-parallel MoE layer across ranks, against JAX.

``repro_torch.models.moe`` under a mesh of ranks against
``repro.models.moe`` under ``jax.make_mesh`` of the same shape (the
conftest's 8 CPU devices), f32, inputs numpy arrays from a seed and one
JAX parameter tree for both packages:

- ``_local_moe`` against JAX's for every ``(e_start, e_count)`` slice of
  8 experts (1, 2, 4 and 8 ranks along ``"model"``), top-1 and top-2;
- the global path with its tokens as ``ds = 2`` data shards in one
  process, under a mesh whose ``"model"`` axis does not divide the
  experts or whose data axes do not divide the batch;
- ranks started by ``launch_simulated`` (``tests/torch_moe_worker.py``,
  gloo on the CPU), each world size launched once for the module: 2 ranks
  at ``(1, 2)`` and ``(2, 1)``, 4 at ``(2, 2)`` and ``(1, 4)``, each rank
  on its rows (``data_rows``) with its experts (``place_params``); the
  JAX package's fallback conditions at ``(2, 1)`` with a batch of 3 and
  at ``(2, 2)`` with 7 experts;
- a reduced phi3.5-moe and a reduced llama4-scout (its shared expert
  added after the reduction), two MoE layers: prefill and 4 greedy decode
  steps at ``(1, 2)`` against JAX's ``make_prefill_step`` and
  ``make_serve_step`` under the mesh;
- a rank whose expert leaves are not its share raises on every rank.

Tolerances: ``top_e`` and ``keep`` bitwise; the output and the aux loss
``rtol=1e-5, atol=1e-6``; logits ``rtol=atol=1e-4`` and greedy tokens
equal, as ``tests/test_torch_zoo.py`` holds the reduced configs off a
mesh. On 2 ranks at ``(1, 2)`` the output and the aux are bitwise the
port's own one-process ``apply_moe`` (asserted: at most two of a
token's partial outputs are not zero, and their sum is the one-process
sum's), not JAX's (f32 products summed in another order: up to 9.5e-7
apart at these inputs).
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

from repro.configs import get_config as j_get_config
from repro.launch.steps import make_prefill_step as j_prefill
from repro.launch.steps import make_serve_step as j_serve
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch import random as trandom
from repro_torch._tree import key_str, tree_flatten_with_path, tree_leaves
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.experiments.placement import Mesh
from repro_torch.launch import distributed as D
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.common import use_mesh

WORKER = str(Path(__file__).resolve().parent / "torch_moe_worker.py")
E, DM, FF = 8, 16, 24
B, S = 4, 8
TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _layer(name, mesh, top_k, *, n_experts=E, cf=1.25, shared=False, b=B):
    return {"name": name, "mesh": list(mesh), "top_k": top_k,
            "n_experts": n_experts, "capacity_factor": cf, "shared": shared,
            "b": b}


LAYERS = {
    2: [_layer("m12_top1", (1, 2), 1), _layer("m12_top2", (1, 2), 2),
        _layer("m12_cf05", (1, 2), 2, cf=0.5),
        _layer("m12_shared", (1, 2), 1, shared=True),
        _layer("m21_top1", (2, 1), 1), _layer("m21_top2", (2, 1), 2),
        # b % dp != 0: the global path with ds = 2 on every rank.
        _layer("m21_b3", (2, 1), 2, b=3)],
    4: [_layer("m22_top1", (2, 2), 1), _layer("m22_top2", (2, 2), 2),
        _layer("m14_top1", (1, 4), 1), _layer("m14_top2", (1, 4), 2),
        # n_experts % tp != 0: the global path, the rows split.
        _layer("m22_e7", (2, 2), 2, n_experts=7)],
}
ARCHS = {"phi35": "phi3.5-moe-42b-a6.6b", "llama4": "llama4-scout-17b-a16e"}
# Two MoE layers (``reduced()`` keeps one), so the second layer's input
# is the first's expert-parallel output.
MODEL_CFG = {"superblock": (("attn_moe", 2, False),), "dtype_name": "float32"}
MB, MS, STEPS = 4, 16, 4


def _j_cfg(arch):
    return j_get_config(arch).reduced().replace(**MODEL_CFG)


def _t_cfg(arch):
    return t_get_config(arch).reduced().replace(**MODEL_CFG)


def _layer_params(case, seed):
    return jmoe.init_moe(jax.random.PRNGKey(seed), DM, FF, case["n_experts"],
                         jnp.float32, shared_expert=case["shared"])


def _layer_x(case, seed):
    return np.random.default_rng(seed).standard_normal(
        (case["b"], S, DM)).astype(np.float32)


def _j_mesh(shape):
    """``jax.make_mesh`` of ``shape`` with Auto axes: the JAX package's
    global path constrains its buffers with ``with_sharding_constraint``,
    which jax 0.9's default Explicit axes refuse."""
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _j_apply(case, params, x, mesh_shape=None):
    fn = jax.jit(lambda p, x: jmoe.apply_moe(
        p, x, n_experts=case["n_experts"], top_k=case["top_k"],
        capacity_factor=case["capacity_factor"],
        shared_expert=case["shared"]))
    if mesh_shape is None:
        return fn(params, x)
    with _j_mesh(mesh_shape):
        return fn(params, x)


def _j_routing(router_w, x, top_k, n_experts, capacity, ds=1):
    """JAX's top_e and keep for tokens ``x``, by the lines of its
    ``apply_moe`` / ``_local_moe``: positions counted within each of
    ``ds`` shards, kept below ``capacity``."""
    xt = jnp.asarray(x, jnp.float32).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt @ router_w, axis=-1)
    _, top_e = jax.lax.top_k(probs, top_k)
    flat_e = top_e.reshape(ds, -1)
    onehot = jax.nn.one_hot(flat_e, n_experts, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=1) * onehot, -1) - 1
    return np.asarray(top_e), np.asarray(pos < capacity).reshape(top_e.shape)


def _capacity(t, top_k, cf, n_experts):
    return int(max(1, (t * top_k * cf) // n_experts))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(prefix, tree):
    leaves, _ = tree_flatten_with_path(_numpy_tree(tree))
    return {f"{prefix}/{key_str(path)}": leaf for path, leaf in leaves}


def _tokens(vocab, seed, b=MB, s=MS):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------ one process

@pytest.mark.parametrize("top_k", [1, 2], ids=["top1", "top2"])
def test_local_moe_matches_jax_for_every_expert_slice(top_k):
    """Each rank's partial output and aux, and its routing (the capacity's
    verdict on the rank's experts), for every slice of 8 experts a 1-,
    2-, 4- or 8-way ``"model"`` axis gives."""
    case = _layer("local", (1, 1), top_k)
    jp = _layer_params(case, 5)
    tp = params_from_jax(_numpy_tree(jp), device="cpu")
    x = _layer_x(case, 6).reshape(-1, DM)
    cap = _capacity(x.shape[0], top_k, 1.25, E) // 2  # some drops
    top_e, fits = _j_routing(jp["router"]["w"], x, top_k, E, cap)
    for tpn in (1, 2, 4, 8):
        count = E // tpn
        for index in range(tpn):
            lo, hi = index * count, (index + 1) * count
            kw = dict(n_experts=E, top_k=top_k, act="silu", capacity=cap,
                      e_start=lo, e_count=count)
            want_y, want_aux = jmoe._local_moe(
                jp["router"]["w"], jp["w_gate"][lo:hi], jp["w_up"][lo:hi],
                jp["w_down"][lo:hi], jnp.asarray(x), **kw)
            tmoe.routing_log = []
            try:
                got_y, got_aux = tmoe._local_moe(
                    tp["router"]["w"], tp["w_gate"][lo:hi],
                    tp["w_up"][lo:hi], tp["w_down"][lo:hi],
                    torch.from_numpy(x), **kw)
                (log_e, log_keep), = tmoe.routing_log
            finally:
                tmoe.routing_log = None
            np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                       **TOL)
            np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux),
                                       **TOL)
            np.testing.assert_array_equal(log_e.numpy(), top_e)
            np.testing.assert_array_equal(log_keep.numpy(), fits)
            mine = (top_e >= lo) & (top_e < hi)
            assert (np.asarray(want_y)[~(mine & fits).any(-1)] == 0).all()


GLOBAL = [_layer("e6_m24", (2, 4), 2, n_experts=6),
          _layer("e8_m22_b3", (2, 2), 2, b=3),
          _layer("e8_m22_b3_top1_shared", (2, 2), 1, b=3, shared=True)]


@pytest.mark.parametrize("case", GLOBAL, ids=[c["name"] for c in GLOBAL])
def test_global_path_with_two_data_shards_matches_jax(case):
    """Where the expert-parallel path does not apply (the ``"model"``
    axis does not divide the experts, or the data axes the batch), every
    rank runs JAX's global path on every row: positions and the capacity
    counted per data shard (``ds = 2``), slot ``(e·ds + s)·cap + pos``.
    One process: a mesh layout with no ranks of its own, whose path has
    no collective."""
    jp = _layer_params(case, 7)
    x = _layer_x(case, 8)
    want_y, want_aux = _j_apply(case, jp, x, case["mesh"])
    off_y, _ = _j_apply(case, jp, x)
    assert np.abs(np.asarray(want_y) - np.asarray(off_y)).max() > 0, \
        "the data shards' capacity should move the output"
    mesh = Mesh(("data", "model"), np.arange(np.prod(case["mesh"])).reshape(
        case["mesh"]))
    tp = params_from_jax(_numpy_tree(jp), device="cpu")
    t = case["b"] * S
    assert not tmoe._expert_parallel(mesh, case["n_experts"], case["b"])
    tmoe.routing_log = []
    try:
        with use_mesh(mesh):
            assert tmoe._data_shards(t) == 2
            got_y, got_aux = tmoe.apply_moe(
                tp, torch.from_numpy(x), n_experts=case["n_experts"],
                top_k=case["top_k"], shared_expert=case["shared"])
        (log_e, log_keep), = tmoe.routing_log
    finally:
        tmoe.routing_log = None
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux), **TOL)
    top_e, keep = _j_routing(
        jp["router"]["w"], x, case["top_k"], case["n_experts"],
        _capacity(t // 2, case["top_k"], 1.25, case["n_experts"]), ds=2)
    np.testing.assert_array_equal(log_e.numpy(), top_e)
    np.testing.assert_array_equal(log_keep.numpy(), keep)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_on_a_mesh_is_place_params_bitwise(arch):
    """``init_lm(key, cfg, mesh=)`` draws each rank's experts alone, with
    the bits of ``place_params(init_lm(key, cfg), mesh)``; every other
    leaf is the whole draw's."""
    cfg = _t_cfg(ARCHS[arch])
    whole = tt.init_lm(trandom.PRNGKey(2, device="cpu"), cfg)
    for shape in ((1, 2), (2, 2), (1, 4)):
        for coords in np.ndindex(*shape):
            mesh = Mesh(("data", "model"),
                        np.arange(np.prod(shape)).reshape(shape), coords)
            mine = tt.init_lm(trandom.PRNGKey(2, device="cpu"), cfg,
                              mesh=mesh)
            placed = tt.place_params(whole, mesh)
            for (path, a), b in zip(tree_flatten_with_path(mine)[0],
                                    tree_leaves(placed)):
                assert torch.equal(a, b), (shape, coords, key_str(path))
            gate = mine["stack"]["seg0"]["moe"]["w_gate"]
            assert gate.shape[-3] == cfg.n_experts // shape[1]


@pytest.mark.parametrize("rows", [slice(0, 1), slice(1, 3), slice(3, 4),
                                  slice(2, 2)], ids=str)
def test_row_draws_are_the_whole_draw_s_rows(rows, monkeypatch):
    """``normal(key, shape, rows=)`` gives the rows' bits in the whole
    draw, across the draw's slices too (a slice of 7 elements here)."""
    key = trandom.PRNGKey(4, device="cpu")
    whole = trandom.normal(key, (4, 3, 5))
    assert torch.equal(trandom.normal(key, (4, 3, 5), rows=rows), whole[rows])
    monkeypatch.setattr(trandom, "DRAW_SLICE", 7)
    assert torch.equal(trandom.normal(key, (4, 3, 5), rows=rows), whole[rows])


def test_mesh_context_and_rows():
    """``use_mesh`` nests and restores; a rank's rows are its block over
    the data axes when they divide the batch, else every row; the
    expert-parallel path's conditions are the JAX package's on the
    global batch."""
    from repro_torch.models.common import (current_mesh, data_rows,
                                           rows_split)
    from repro_torch.experiments.placement import make_mesh

    mesh = Mesh(("data", "model"), np.arange(4).reshape(2, 2), (1, 0))
    assert current_mesh() is None
    with use_mesh(mesh, batch=6):
        assert current_mesh() is mesh and rows_split()
        assert data_rows(6, mesh) == slice(3, 6)
        assert tmoe._expert_parallel(mesh, 8, 3)
        assert not tmoe._expert_parallel(mesh, 7, 3)
        assert tmoe.expert_slice(8) == slice(0, 4)
        with use_mesh(None):
            assert current_mesh() is None
        assert current_mesh() is mesh
    with use_mesh(mesh, batch=5):
        assert not rows_split() and data_rows(5, mesh) == slice(0, 5)
        assert not tmoe._expert_parallel(mesh, 8, 5)
        assert tmoe._data_shards(5 * 4) == 2 and tmoe._data_shards(5) == 1
    with use_mesh(mesh):  # no batch: every row
        assert not rows_split() and tmoe._expert_parallel(mesh, 8, 4)
    assert current_mesh() is None
    one = make_mesh((1, 1))  # this process alone: no process group
    assert one.coords == (0, 0) and one.row_group is None and one.group is None
    with pytest.raises(ValueError, match="needs 2 global ranks"):
        make_mesh((1, 2))
    with pytest.raises(ValueError, match="last"):
        make_mesh((1, 1), ("model", "data"))


# ------------------------------------------------------------ the ranks

def _launch(world, tmp_path_factory):
    in_dir = str(tmp_path_factory.mktemp(f"ep_in{world}"))
    out = str(tmp_path_factory.mktemp(f"ep_out{world}"))
    arrays, refs = {}, {}
    for i, case in enumerate(LAYERS[world]):
        jp, x = _layer_params(case, 10 + i), _layer_x(case, 20 + i)
        arrays.update(_flat(f"layer/{case['name']}/params", jp))
        arrays[f"layer/{case['name']}/x"] = x
        refs[case["name"]] = (jp, x)
    models, refuse = [], []
    if world == 2:
        for arch, name in ARCHS.items():
            jcfg = _j_cfg(name)
            jp = jax.jit(lambda k: jt.init_lm(k, jcfg))(jax.random.PRNGKey(0))
            arrays.update(_flat(f"model/{arch}", jp))
            arrays[f"model/{arch}/tokens"] = _tokens(jcfg.vocab, 30)
            refs[arch] = jp
            models.append({"name": arch, "arch": name, "params": arch,
                           "cfg": MODEL_CFG, "mesh": [1, 2], "steps": STEPS})
        arrays["model/phi35_refused/tokens"] = arrays["model/phi35/tokens"]
        refuse.append(dict(models[0], name="phi35_refused"))
    np.savez(os.path.join(in_dir, "inputs.npz"), **arrays)
    with open(os.path.join(in_dir, "cases.json"), "w") as f:
        json.dump({"layer": LAYERS[world], "model": models,
                   "refuse": refuse}, f)
    D.launch_simulated(world, command=[sys.executable, WORKER],
                       argv=[in_dir, out], timeout=240)
    ranks = [dict(np.load(os.path.join(out, f"ep_p{r}.npz")))
             for r in range(world)]
    errors = []
    for r in range(world):
        with open(os.path.join(out, f"errors_p{r}.json")) as f:
            errors.append(json.load(f))
    return {"ranks": ranks, "errors": errors, "refs": refs, "world": world}


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _launch(2, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _launch(4, tmp_path_factory)


CASES = [(w, c) for w in (2, 4) for c in LAYERS[w]]


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}ranks-{c['name']}" for w, c in CASES])
def test_expert_parallel_layer_matches_jax(world, case, request):
    """Each rank's rows of the output, the aux, and its tokens' routing
    against JAX's ``apply_moe`` under ``jax.make_mesh`` of the same shape;
    the ranks of a data row hold the same output."""
    run = request.getfixturevalue(f"ranks{world}")
    name = case["name"]
    jp, x = run["refs"][name]
    want_y, want_aux = _j_apply(case, jp, x, case["mesh"])
    want_y = np.asarray(want_y)
    dp, tpn = case["mesh"]
    ep = case["n_experts"] % tpn == 0 and case["b"] % dp == 0
    split = case["b"] % dp == 0
    outputs = {}
    for rank, res in enumerate(run["ranks"]):
        lo, hi = res[f"{name}|rows"]
        assert (hi - lo) == (case["b"] // dp if split else case["b"])
        np.testing.assert_allclose(res[f"{name}|y"], want_y[lo:hi], **TOL,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(res[f"{name}|aux"], np.asarray(want_aux),
                                   **TOL, err_msg=f"rank {rank}")
        rows_t = (hi - lo) * S
        ds = 1 if split else (dp if rows_t % dp == 0 else 1)
        cap = _capacity(rows_t // ds, case["top_k"], case["capacity_factor"],
                        case["n_experts"])
        top_e, keep = _j_routing(jp["router"]["w"], x[lo:hi], case["top_k"],
                                 case["n_experts"], cap, ds=ds)
        np.testing.assert_array_equal(res[f"{name}|top_e"], top_e)
        np.testing.assert_array_equal(res[f"{name}|keep"], keep)
        outputs.setdefault((lo, hi), []).append(res[f"{name}|y"])
    for same in outputs.values():
        for y in same[1:]:
            np.testing.assert_array_equal(y, same[0])
    if world == 2 and tuple(case["mesh"]) == (1, 2):
        assert ep
        tp = params_from_jax(_numpy_tree(jp), device="cpu")
        one_y, one_aux = tmoe.apply_moe(
            tp, torch.from_numpy(x), n_experts=case["n_experts"],
            top_k=case["top_k"], capacity_factor=case["capacity_factor"],
            shared_expert=case["shared"])
        for res in run["ranks"]:
            np.testing.assert_array_equal(res[f"{name}|y"], one_y.numpy())
            np.testing.assert_array_equal(res[f"{name}|aux"], one_aux.numpy())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_expert_parallel_prefill_and_decode_match_jax(ranks2, arch):
    """A reduced model on 2 ranks at ``(1, 2)``, each rank half its
    experts: the prefill's last-position logits and 4 greedy decode steps
    against JAX's jitted steps under ``jax.make_mesh((1, 2))``; both ranks
    alike, and their routing the port's one-process run's bit for bit."""
    name = ARCHS[arch]
    jcfg, tcfg = _j_cfg(name), _t_cfg(name)
    jp = ranks2["refs"][arch]
    toks = _tokens(jcfg.vocab, 30)
    with _j_mesh((1, 2)):
        want = np.asarray(jax.jit(j_prefill(jcfg))(
            jp, {"tokens": jnp.asarray(toks)}))
        jstep = jax.jit(j_serve(jcfg))
        js = jt.init_decode_state(jcfg, MB, STEPS)
        jtok, steps = jnp.asarray(toks[:, :1]), []
        for pos in range(STEPS):
            jn, jl, js = jstep(jp, jtok, js, jnp.asarray(pos))
            steps.append((np.asarray(jn), np.asarray(jl)))
            jtok = jn[:, None]
    tmoe.routing_log = []
    try:
        tt.hidden_states(params_from_jax(_numpy_tree(jp), device="cpu"),
                         tcfg, torch.from_numpy(toks))
        one_log = tmoe.routing_log
    finally:
        tmoe.routing_log = None
    assert len(one_log) == 2
    for rank, res in enumerate(ranks2["ranks"]):
        assert list(res[f"{arch}|rows"]) == [0, MB]
        np.testing.assert_allclose(res[f"{arch}|prefill"], want, **LOGIT_TOL,
                                   err_msg=f"rank {rank}")
        for pos, (jn, jl) in enumerate(steps):
            np.testing.assert_array_equal(res[f"{arch}|token{pos}"], jn)
            np.testing.assert_allclose(res[f"{arch}|logits{pos}"], jl,
                                       **LOGIT_TOL, err_msg=f"step {pos}")
        assert sum(k.startswith(f"{arch}|prefill_top_e")
                   for k in res) == len(one_log)
        for i, (top_e, keep) in enumerate(one_log):
            np.testing.assert_array_equal(res[f"{arch}|prefill_top_e{i}"],
                                          top_e.numpy())
            np.testing.assert_array_equal(res[f"{arch}|prefill_keep{i}"],
                                          keep.numpy())
    for key in ranks2["ranks"][0]:
        if key.startswith(arch + "|"):
            np.testing.assert_array_equal(ranks2["ranks"][0][key],
                                          ranks2["ranks"][1][key])


def test_wrong_expert_count_raises_on_every_rank(ranks2):
    """Rank 1 given all the experts where the mesh gives it half: both
    ranks raise before any layer runs (rank 0's leaves are right)."""
    for rank, errors in enumerate(ranks2["errors"]):
        assert set(errors) == {"phi35_refused"}, (rank, errors)
        assert "expert leaves do not hold the 2 experts of 4" in \
            errors["phi35_refused"]
    assert "this rank's" in ranks2["errors"][1]["phi35_refused"]
    assert "this rank's" not in ranks2["errors"][0]["phi35_refused"]
    assert "phi35_refused|prefill" not in ranks2["ranks"][0]
