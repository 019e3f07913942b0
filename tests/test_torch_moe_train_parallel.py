"""Port parity: training under expert parallelism across ranks, against JAX.

``repro_torch``'s ``make_train_step`` and ``make_sgd_train_step`` on
ranks under a ``("data", "model")`` or a ``("data",)`` mesh
(``tests/torch_moe_train_worker.py``,
gloo on the CPU, started by ``launch_simulated``; each world size once
for the module) against the JAX package's under ``jax.make_mesh`` of the
same shape (the conftest's 8 CPU devices, Auto axes), jitted. A reduced
phi3.5-moe and a reduced llama4-scout (its shared expert outside the
reduction), two ``attn_moe`` layers, f32, B 8 x S 16, 4 clients of which
the last (rows 6 and 7) is masked, one JAX parameter tree for both
packages. Meshes ``(1, 2)`` and ``(2, 1)`` on 2 ranks, ``(2, 2)`` and
``(1, 4)`` on 4, and the JAX package's fallbacks: a batch of 9 at
``(2, 1)`` (every rank every row, the global path at ds = 2) and 7
experts at ``(2, 2)`` (the global path, the rows split). A ``("data",)``
mesh of 2 ranks, with no ``"model"`` axis, trains as plain data
parallelism: a reduced stablelm-1.6b (dense) and the reduced phi3.5-moe
(the global path, the rows split), each rank's gradients summed over
the mesh.

The JAX package's gradient under a mesh is not the one off it where the
data axes split the rows (the capacity and the aux are a data shard's),
so each mesh is held against JAX under the same mesh.

Held:
- the metrics ``rtol=1e-5``;
- adamw's first moment after one step (``0.1·g``) every leaf
  ``rtol=1e-4, atol=1e-6``, the experts a rank's block;
- the parameters after one SGD step ``rtol=1e-5, atol=1e-6``;
- ``chain_clip(adamw)`` given the mesh and ``moe.model_split``'s leaves:
  the global norm (their squares summed over the row) against JAX's
  gradient's, and its ``mu`` as adamw's;
- inside the port: at a capacity factor of E/top_k without the aux loss,
  the masked client's rows given other tokens leave the update the same
  bits (and move it when the client is active); remat's recomputation,
  with its collectives, gives the same bits; at ``(1, 2)`` the ranks'
  metrics are the port's one-process step's bit for bit (its gradients
  at the tolerance above: the partial gradients of the tokens are summed
  over the row in another order);
- each rank's data group: the ranks that share its ``"model"`` index
  (every rank of a ``("data",)`` mesh).

One process: ``_local_moe``'s backward against ``jax.grad`` of JAX's for
every expert slice; the coefficients of a rank's rows taken from the
global batch; ``moe.model_split``; ``flat=True`` under a mesh refused, and
rows split over a mesh with no group along its data axes.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.configs import get_config as j_get_config
from repro.launch.steps import make_sgd_train_step as j_sgd_step
from repro.launch.steps import make_train_step as j_train_step
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.optim import adamw as j_adamw
from repro.optim import chain_clip as j_chain_clip
from repro_torch import random as trandom
from repro_torch._tree import key_str, tree_flatten_with_path, tree_map
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.trainer import build_energy_train_step
from repro_torch.experiments.placement import Mesh
from repro_torch.launch import distributed as D
from repro_torch.launch.steps import make_sgd_train_step, make_train_step
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.common import use_mesh
from repro_torch.optim import Optimizer, chain_clip, sgd

WORKER = str(Path(__file__).resolve().parent / "torch_moe_train_worker.py")
ARCHS = {"phi35": "phi3.5-moe-42b-a6.6b", "llama4": "llama4-scout-17b-a16e",
         "stablelm": "stablelm-1.6b"}
# Two MoE layers (``reduced()`` keeps one): the first layer's gradient
# passes through the second's expert-parallel backward.
MODEL_CFG = {"superblock": (("attn_moe", 2, False),), "dtype_name": "float32"}
DENSE_CFG = {"dtype_name": "float32"}
EP_AXES, DATA_AXES = ("data", "model"), ("data",)
B, S, N_CLIENTS = 8, 16, 4
LR, SGD_LR, MAX_NORM = 1e-4, 0.05, 0.05
MASK = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
SCALE = np.array([1.5, 1.0, 2.0, 1.0], np.float32)
METRIC_TOL = dict(rtol=1e-5)
MU_TOL = dict(rtol=1e-4, atol=1e-6)
SGD_TOL = dict(rtol=1e-5, atol=1e-6)


def _case(name, arch, mesh, *, b=B, n_experts=None, axes=EP_AXES, **flags):
    cfg = dict(DENSE_CFG if arch == "stablelm" else MODEL_CFG)
    if n_experts is not None:
        cfg["n_experts"] = n_experts
    return dict(name=name, arch=ARCHS[arch], mesh=list(mesh), axes=list(axes),
                b=b, cfg=cfg, n_clients=N_CLIENTS, lr=LR, sgd_lr=SGD_LR,
                max_norm=MAX_NORM, **flags)


CASES = {
    2: [_case("phi35_m12", "phi35", (1, 2), masked=True, remat=True),
        _case("phi35_m21", "phi35", (2, 1), masked=True),
        _case("llama4_m12", "llama4", (1, 2)),
        _case("llama4_m21", "llama4", (2, 1)),
        # b % dp != 0: every rank every row, the global path at ds = 2.
        _case("phi35_m21_b9", "phi35", (2, 1), b=9),
        # No "model" axis: plain data parallelism, the MoE's global path.
        _case("stablelm_d2", "stablelm", (2,), axes=DATA_AXES),
        _case("phi35_d2", "phi35", (2,), axes=DATA_AXES)],
    4: [_case("phi35_m22", "phi35", (2, 2), clip=True, masked=True),
        _case("phi35_m14", "phi35", (1, 4)),
        _case("llama4_m22", "llama4", (2, 2)),
        _case("llama4_m14", "llama4", (1, 4)),
        # n_experts % tp != 0: the global path, the rows split.
        _case("phi35_m22_e7", "phi35", (2, 2), n_experts=7)],
}
ALL = [(w, c) for w in (2, 4) for c in CASES[w]]


def _cfgs(case):
    kw = dict(case["cfg"])
    return (j_get_config(case["arch"]).reduced().replace(**kw),
            t_get_config(case["arch"]).reduced().replace(**kw))


def _j_mesh(shape, axes):
    """``jax.make_mesh`` with Auto axes (jax 0.9's default Explicit axes
    refuse the global path's ``with_sharding_constraint``)."""
    return jax.make_mesh(tuple(shape), tuple(axes),
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def _sizes(case):
    """(dp, tp) of the case's mesh."""
    sizes = dict(zip(case["axes"], case["mesh"]))
    return sizes.get("data", 1), sizes.get("model", 1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(prefix, tree):
    leaves, _ = tree_flatten_with_path(_np(tree))
    return {f"{prefix}/{key_str(path)}": leaf for path, leaf in leaves}


def _batch(b, vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, S + 1)).astype(np.int32)
    ids = np.minimum(np.arange(b) // 2, N_CLIENTS - 1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "client_ids": ids}


def _replaced(batch, vocab, seed):
    """The batch with the last client's rows (the masked one's, last)
    given other tokens."""
    rng = np.random.default_rng(seed)
    rows = batch["client_ids"] == N_CLIENTS - 1
    out = {k: v.copy() for k, v in batch.items()}
    toks = rng.integers(0, vocab, (int(rows.sum()), S + 1)).astype(np.int32)
    out["tokens"][rows], out["labels"][rows] = toks[:, :-1], toks[:, 1:]
    return out


def _j_params(jcfg):
    return jax.jit(lambda k: jt.init_lm(k, jcfg))(jax.random.PRNGKey(0))


def _j_reference(case, jp, batch):
    """JAX's adamw, SGD (and with ``clip``, chain_clip(adamw)) steps under
    the case's mesh, one jit: (metrics, mu, SGD params, clip mu)."""
    jcfg, _ = _cfgs(case)
    ia, sa = j_train_step(jcfg, N_CLIENTS, lr=LR)
    is_, ss = j_sgd_step(jcfg, N_CLIENTS, lr=SGD_LR)
    ic, sc = j_train_step(jcfg, N_CLIENTS,
                          optimizer=j_chain_clip(j_adamw(LR), MAX_NORM))
    clip = bool(case.get("clip"))

    def steps(params, batch, mask, scale):
        a, metrics = sa(ia(params), batch, mask, scale)
        s, _ = ss(is_(params), batch, mask, scale)
        c = sc(ic(params), batch, mask, scale)[0].opt_state.mu if clip else None
        return metrics, a.opt_state.mu, s.params, c

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with _j_mesh(case["mesh"], case["axes"]):
        out = jax.jit(steps)(jp, jb, jnp.asarray(MASK), jnp.asarray(SCALE))
    return _np(out)


def _launch(world, cases, arrays, in_dir, out):
    np.savez(os.path.join(in_dir, "inputs.npz"), **arrays)
    with open(os.path.join(in_dir, "cases.json"), "w") as f:
        json.dump(cases, f)
    D.launch_simulated(world, command=[sys.executable, WORKER],
                       argv=[in_dir, out], timeout=240)
    return {c["name"]: [dict(np.load(os.path.join(out, f"{c['name']}_p{r}.npz")))
                        for r in range(world)] for c in cases}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' ranks, launched beside JAX's jitted references."""
    params, batches, arrays = {}, {}, {2: {}, 4: {}}
    for world, case in ALL:
        jcfg, _ = _cfgs(case)
        pkey = (case["arch"], jcfg.n_experts)
        if pkey not in params:
            params[pkey] = _j_params(jcfg)
        batch = _batch(case["b"], jcfg.vocab, 30 + case["b"])
        batches[case["name"]] = (params[pkey], batch)
        name, a = case["name"], arrays[world]
        a.update(_flat(f"{name}/params", params[pkey]))
        a.update({f"{name}/batch/{k}": v for k, v in batch.items()})
        a[f"{name}/mask"], a[f"{name}/scale"] = MASK, SCALE
        if case.get("masked"):
            other = _replaced(batch, jcfg.vocab, 40)
            a.update({f"{name}/replaced/{k}": other[k]
                      for k in ("tokens", "labels")})
    with ThreadPoolExecutor(max_workers=6) as pool:
        ranks = {w: pool.submit(_launch, w, CASES[w], arrays[w], *(
            str(tmp_path_factory.mktemp(f"ept_{kind}{w}"))
            for kind in ("in", "out"))) for w in (2, 4)}
        refs = {c["name"]: pool.submit(_j_reference, c, *batches[c["name"]])
                for _, c in ALL}
        return {"ranks": {n: r for w in ranks for n, r in ranks[w].result()
                          .items()},
                "refs": {n: f.result() for n, f in refs.items()},
                "inputs": batches}


def _rank_block(case, rank):
    """(model index, experts a rank) of ``rank`` when the case's mesh
    cuts the experts over ``"model"``, else None."""
    dp, tp = _sizes(case)
    n_experts = case["cfg"].get("n_experts", 4)
    if tp == 1 or n_experts % tp or case["b"] % dp:
        return None
    return rank % tp, n_experts // tp


def _want(case, rank, tree):
    """JAX's leaves of ``tree`` as this rank holds them: its block of
    each expert leaf when the mesh cuts them."""
    flat = _flat("", tree)
    block = _rank_block(case, rank)
    if block is None:
        return flat
    index, count = block
    return {k: (v[..., index * count:(index + 1) * count, :, :]
                if k.rsplit("/", 2)[-2] == "moe" and k.rsplit("/", 1)[-1]
                in tmoe.EXPERT_LEAVES else v) for k, v in flat.items()}


def _assert_leaves(got, prefix, want, tol, label):
    keys = sorted(k for k in got if k.startswith(prefix + "/"))
    assert sorted(prefix + k for k in want) == keys, label
    for k in keys:
        np.testing.assert_allclose(got[k], want[k[len(prefix):]], **tol,
                                   err_msg=f"{label} {k}")


@pytest.mark.parametrize("world,case", ALL,
                         ids=[f"{w}ranks-{c['name']}" for w, c in ALL])
def test_train_steps_match_jax_under_the_same_mesh(runs, world, case):
    """Every rank's metrics, adamw ``mu`` and SGD params against JAX's
    steps under the same mesh; its data group the ranks of its column;
    chain_clip's norm and ``mu``."""
    metrics, mu, sgd_params, clip_mu = runs["refs"][case["name"]]
    dp, tp = _sizes(case)
    for rank, res in enumerate(runs["ranks"][case["name"]]):
        label = f"{case['name']} rank {rank}"
        for k, v in metrics.items():
            np.testing.assert_allclose(res[f"metrics/{k}"], v, **METRIC_TOL,
                                       err_msg=f"{label} {k}")
        _assert_leaves(res, "mu", _want(case, rank, mu), MU_TOL, label)
        _assert_leaves(res, "sgd", _want(case, rank, sgd_params), SGD_TOL,
                       label)
        column = [rank % tp + tp * d for d in range(dp)] if dp > 1 else [rank]
        assert res["data_group"].tolist() == column, label
        if case.get("clip"):
            g = np.sqrt(sum(np.sum(np.square(np.float64(x) / np.float32(0.1)))
                            for x in jax.tree_util.tree_leaves(mu)))
            assert g > MAX_NORM, "the norm should be clipped"
            np.testing.assert_allclose(res["clip_norm"], g, rtol=1e-5,
                                       err_msg=label)
            _assert_leaves(res, "clip_mu", _want(case, rank, clip_mu),
                           MU_TOL, label)


MASKED = [c for _, c in ALL if c.get("masked")]


@pytest.mark.parametrize("case", MASKED, ids=[c["name"] for c in MASKED])
def test_masked_client_rows_leave_the_update_bitwise(runs, case):
    """At a capacity factor of E/top_k and without the aux loss, the
    masked client's rows given other tokens leave every rank's update the
    same bits; with the client active they move it."""
    for rank, res in enumerate(runs["ranks"][case["name"]]):
        assert bool(res["masked_same"]), f"rank {rank}"
        assert not bool(res["unmasked_same"]), f"rank {rank}"


def test_remat_recomputes_the_same_bits(runs):
    """Remat's recomputation, with its forward collectives run again in
    the backward, gives the step without it bit for bit."""
    for rank, res in enumerate(runs["ranks"]["phi35_m12"]):
        assert bool(res["remat_same"]), f"rank {rank}"


@pytest.mark.parametrize("arch", ["llama4", "phi35"])
def test_ranks_at_1x2_against_the_one_process_step(runs, arch):
    """At ``(1, 2)`` each rank's metrics are the port's one-process step's
    bit for bit; its ``mu`` and SGD params at the JAX tolerances (a
    token's gradient is summed over the row's partials in another
    order)."""
    name = f"{arch}_m12"
    case = next(c for _, c in ALL if c["name"] == name)
    jp, batch = runs["inputs"][name]
    _, tcfg = _cfgs(case)
    params = params_from_jax(_np(jp), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mask, scale = torch.from_numpy(MASK), torch.from_numpy(SCALE)
    init, step = make_train_step(tcfg, N_CLIENTS, lr=LR)
    state, metrics = step(init(params), tb, mask, scale)
    init, step = make_sgd_train_step(tcfg, N_CLIENTS, lr=SGD_LR)
    after = step(init(params), tb, mask, scale)[0].params
    for rank, res in enumerate(runs["ranks"][name]):
        for k, v in metrics.items():
            assert np.array_equal(res[f"metrics/{k}"], v.numpy()), (rank, k)
        for prefix, tree in (("mu", state.opt_state.mu), ("sgd", after)):
            want = _want(case, rank, tree_map(lambda x: x.numpy(), tree))
            _assert_leaves(res, prefix, want,
                           MU_TOL if prefix == "mu" else SGD_TOL,
                           f"rank {rank}")


# ------------------------------------------------------------ one process

E, DM, FF = 8, 16, 24


@pytest.mark.parametrize("top_k", [1, 2], ids=["top1", "top2"])
def test_local_moe_backward_matches_jax_for_every_expert_slice(top_k):
    """The gradients of ``sum(y·c) + 0.3·aux`` through one rank's
    ``_local_moe`` (its router, its experts and its tokens) against
    ``jax.grad`` of JAX's, for every slice of 8 experts a 1-, 2-, 4- or
    8-way ``"model"`` axis gives, at a capacity that drops some."""
    jp = jmoe.init_moe(jax.random.PRNGKey(5), DM, FF, E, jnp.float32)
    tp = params_from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4 * 8, DM)).astype(np.float32)
    c = rng.standard_normal((4 * 8, DM)).astype(np.float32)
    cap = max(1, int(x.shape[0] * top_k * 1.25) // E) // 2
    for tpn in (1, 2, 4, 8):
        count = E // tpn
        kw = dict(n_experts=E, top_k=top_k, act="silu", capacity=cap,
                  e_count=count)

        @jax.jit
        def j_grad(r, g, u, d, xt, e_start):
            def j_loss(r, g, u, d, xt):
                y, aux = jmoe._local_moe(r, g, u, d, xt, e_start=e_start,
                                         **kw)
                return jnp.sum(y * c) + 0.3 * aux
            return jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(r, g, u, d, xt)

        for index in range(tpn):
            lo, hi = index * count, (index + 1) * count
            want = j_grad(jp["router"]["w"], jp["w_gate"][lo:hi],
                          jp["w_up"][lo:hi], jp["w_down"][lo:hi],
                          jnp.asarray(x), lo)
            args = [t.clone().requires_grad_() for t in (
                tp["router"]["w"], tp["w_gate"][lo:hi], tp["w_up"][lo:hi],
                tp["w_down"][lo:hi], torch.from_numpy(x))]
            y, aux = tmoe._local_moe(*args, e_start=lo, **kw)
            (torch.sum(y * torch.from_numpy(c)) + 0.3 * aux).backward()
            for name, a, w in zip(("router", "w_gate", "w_up", "w_down", "x"),
                                  args, want):
                np.testing.assert_allclose(
                    a.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6,
                    err_msg=f"{tpn} ranks, slice {index}: {name}")


def _grads_optimizer():
    """An optimizer whose state after a step is the step's gradient."""
    return Optimizer(init=lambda params: (),
                     update=lambda grads, state, params=None: (
                         tree_map(torch.zeros_like, grads), grads))


def test_coefficients_take_the_global_batch():
    """Under a ``(2, 1)`` layout with no process group (each data shard's
    step alone), a shard steps its own rows with the coefficients of the
    global batch: the shards' gradients and weighted losses sum to the
    one-process step's. With a shard's batch size, every coefficient
    would double."""
    cfg = t_get_config("stablelm-1.6b").reduced()
    params = tt.init_lm(trandom.PRNGKey(1, device="cpu"), cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(B, cfg.vocab, 7).items()}
    mask, scale = torch.from_numpy(MASK), torch.from_numpy(SCALE)
    init, step = build_energy_train_step(
        per_example_loss_fn=lambda p, b: tt.per_example_loss(p, cfg, b),
        optimizer=_grads_optimizer(), n_clients=N_CLIENTS)
    whole, m_whole = step(init(params), batch, mask, scale)
    parts, weighted = [], 0.0
    for d in range(2):
        layout = Mesh(("data", "model"), np.arange(2).reshape(2, 1), (d, 0))
        with use_mesh(layout, batch=B):
            state, m = step(init(params), batch, mask, scale)
        parts.append(state.opt_state)
        weighted = weighted + m["weighted_loss"]
        assert torch.equal(m["active_clients"], m_whole["active_clients"])
    torch.testing.assert_close(weighted, m_whole["weighted_loss"], rtol=1e-6,
                               atol=0)
    summed = tree_map(lambda a, b: a + b, *parts)
    for (path, got), want in zip(tree_flatten_with_path(summed)[0],
                                 tree_flatten_with_path(whole.opt_state)[0]):
        torch.testing.assert_close(got, want[1], rtol=1e-5, atol=1e-7,
                                   msg=key_str(path))


def test_remat_recomputes_under_the_forward_mesh(monkeypatch):
    """Autograd runs a CUDA tensor's backward in a thread of its own, with
    no mesh context: remat's recomputation of a layer still runs under
    the forward's mesh. Here the backward runs in another thread, after
    the context has closed."""
    import threading

    from repro_torch.models import blocks
    from repro_torch.models.common import current_mesh

    cfg = t_get_config(ARCHS["phi35"]).reduced().replace(**MODEL_CFG,
                                                         remat=True)
    params = tt.init_lm(trandom.PRNGKey(3, device="cpu"), cfg)
    leaves = [x.requires_grad_() for x in
              (leaf for _, leaf in tree_flatten_with_path(params)[0])]
    batch = {k: torch.from_numpy(v) for k, v in _batch(B, cfg.vocab, 9).items()}
    layout = Mesh(("data", "model"), np.arange(2).reshape(2, 1), (1, 0))
    seen, real = [], blocks.apply_moe

    def recording(*args, **kw):
        seen.append(current_mesh())
        return real(*args, **kw)

    monkeypatch.setattr(blocks, "apply_moe", recording)
    with use_mesh(layout, batch=B):
        losses, aux = tt.per_example_loss(
            params, cfg, {k: v[4:] for k, v in batch.items()})
        total = torch.sum(losses) + aux
    assert seen == [layout, layout]
    grads = []
    worker = threading.Thread(
        target=lambda: grads.append(torch.autograd.grad(total, leaves)))
    worker.start()
    worker.join()
    assert len(grads) == 1 and seen == [layout] * 4


def test_flat_under_a_mesh_raises():
    """``flat=True`` keeps one (P,) optimizer buffer, which cannot follow
    a mesh's placement: refused, naming the JAX package's reason."""
    cfg = t_get_config("stablelm-1.6b").reduced()
    init, step = build_energy_train_step(
        per_example_loss_fn=lambda p, b: tt.per_example_loss(p, cfg, b),
        optimizer=sgd(0.1), n_clients=N_CLIENTS, flat=True)
    layout = Mesh(("data", "model"), np.arange(2).reshape(1, 2), (0, 0))
    with use_mesh(layout, batch=B), pytest.raises(ValueError,
                                                   match="leave flat off"):
        init({"w": torch.zeros(3)})


def test_rows_split_without_a_data_group_raises():
    """A mesh of ranks that splits the rows but has no process group
    along its data axes to sum the shards' gradients over raises, rather
    than let each rank step its own rows' gradient."""
    cfg = t_get_config("stablelm-1.6b").reduced()
    params = tt.init_lm(trandom.PRNGKey(1, device="cpu"), cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(B, cfg.vocab, 7).items()}
    init, step = make_sgd_train_step(cfg, N_CLIENTS, lr=SGD_LR)
    layout = Mesh(("data", "model"), np.arange(2).reshape(2, 1), (0, 0),
                  group=object())
    with use_mesh(layout, batch=B), pytest.raises(
            ValueError, match="no process group along them"):
        step(init(params), batch, torch.from_numpy(MASK),
             torch.from_numpy(SCALE))


def test_model_split_names_the_experts_cut_over_model():
    """``moe.model_split``: the expert leaves a rank holds its block of
    (``place_params`` at ``(1, 2)``), none off a mesh or where the
    ``"model"`` axis does not divide the experts; ``chain_clip`` given
    them off a mesh clips by the plain norm."""
    def split(n_experts, shape):
        cfg = t_get_config(ARCHS["phi35"]).reduced().replace(
            **MODEL_CFG, n_experts=n_experts)
        params = tt.init_lm(trandom.PRNGKey(2, device="cpu"), cfg)
        if shape is not None:
            layout = Mesh(("data", "model"), np.arange(2).reshape(shape),
                          (0, 1) if shape == (1, 2) else (1, 0))
            params = tt.place_params(params, layout)
        return params, tmoe.model_split(params)

    params, cut = split(4, (1, 2))
    assert sorted("/".join(map(str, p)) for p in cut) == [
        f"stack/seg0/moe/{k}" for k in sorted(tmoe.EXPERT_LEAVES)]
    assert not split(4, None)[1] and not split(7, (1, 2))[1]
    assert not split(4, (2, 1))[1]
    grads = tree_map(torch.ones_like, params)
    plain, given = (clip.update(grads, clip.init(params))[0] for clip in (
        chain_clip(sgd(1.0), 0.5), chain_clip(sgd(1.0), 0.5, split=cut)))
    for (path, a), (_, b) in zip(tree_flatten_with_path(plain)[0],
                                 tree_flatten_with_path(given)[0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0,
                                   msg=key_str(path))
