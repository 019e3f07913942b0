"""A rank of ``tests/test_torch_moe_train_parallel.py``'s training runs.

Started by ``repro_torch.launch.distributed.launch_simulated(N,
command=[python, this file], argv=[in_dir, out_dir])``: it starts its
rank from the ``REPRO_DIST_*`` environment on the CPU (gloo), reads the
cases the test wrote to ``in_dir/cases.json`` and their parameters (the
JAX package's, as numpy) and batches from ``in_dir/inputs.npz``, and
runs each on its mesh (``placement.make_mesh`` over the case's axes),
every rank the same cases in the same order. Each rank passes the global batch under
``use_mesh(mesh, batch=B)`` with its experts (``place_params``):

- one ``make_train_step`` adamw step and one ``make_sgd_train_step``
  step from the same parameters: the metrics, adamw's first moment
  ``mu`` and the parameters after SGD, every leaf (a rank's block of
  the experts);
- with ``clip``, one step of ``chain_clip(adamw)`` with the mesh and the
  leaves cut over ``"model"`` (``moe.model_split``): its ``mu`` and the
  global norm it clipped by;
- with ``masked``, one adamw step of ``build_energy_train_step`` at a
  capacity factor of E/top_k without the aux loss, again with the
  masked client's rows (the last) given other tokens: whether the
  parameters after it are the same bits; and with every client active,
  whether the new tokens move them;
- with ``remat``, the adamw step again with the config's remat on:
  whether ``mu`` and the metrics are the same bits.

Results go to ``out_dir/<case>_p<rank>.npz``, with the ranks of the
mesh's data group. Imports neither JAX nor the JAX package.
"""

import json
import os
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def unflatten(inputs, prefix):
    """The nested dict of ``inputs``' arrays under ``prefix/``."""
    tree = {}
    for key in inputs.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = key[len(prefix) + 1:].split("/")
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = inputs[key]
    return tree


def main(argv) -> int:
    sys.path.insert(0, SRC)
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch._tree import key_str, tree_flatten_with_path, tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core.trainer import build_energy_train_step
    from repro_torch.experiments import placement
    from repro_torch.launch import distributed as D
    from repro_torch.launch.steps import make_sgd_train_step, make_train_step
    from repro_torch.models import moe, transformer
    from repro_torch.models.common import use_mesh
    from repro_torch.optim import adamw, chain_clip, optimizers

    in_dir, out = argv[:2]
    D.init_from_env(device="cpu")
    size, rank = placement._world()
    D.share_threads(size)

    with open(os.path.join(in_dir, "cases.json")) as f:
        cases = json.load(f)
    inputs = np.load(os.path.join(in_dir, "inputs.npz"))

    def host(t):
        return t.detach().float().numpy()

    def leaves(prefix, tree):
        return {f"{prefix}/{key_str(p)}": host(x)
                for p, x in tree_flatten_with_path(tree)[0]}

    def same(a, b):
        return all(torch.equal(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    for case in cases:
        name = case["name"]
        kw = dict(case["cfg"])
        if "superblock" in kw:
            kw["superblock"] = tuple(tuple(seg) for seg in kw["superblock"])
        cfg = get_config(case["arch"]).reduced().replace(**kw)
        mesh = placement.make_mesh(case["mesh"], case["axes"])
        params = transformer.place_params(params_from_jax(
            unflatten(inputs, f"{name}/params"), device="cpu"), mesh)
        batch = {k: torch.from_numpy(inputs[f"{name}/batch/{k}"])
                 for k in ("tokens", "labels", "client_ids")}
        mask = torch.from_numpy(inputs[f"{name}/mask"])
        scale = torch.from_numpy(inputs[f"{name}/scale"])
        b = batch["tokens"].shape[0]
        res = {"data_group": np.array(
            dist.get_process_group_ranks(mesh.data_group)
            if mesh.data_group is not None else [rank])}
        with use_mesh(mesh, batch=b):
            init, step = make_train_step(cfg, case["n_clients"], lr=case["lr"])
            adam, metrics = step(init(params), batch, mask, scale)
            res.update({f"metrics/{k}": host(v) for k, v in metrics.items()})
            res.update(leaves("mu", adam.opt_state.mu))
            init, step = make_sgd_train_step(cfg, case["n_clients"],
                                             lr=case["sgd_lr"])
            res.update(leaves("sgd", step(init(params), batch, mask,
                                          scale)[0].params))
            if case.get("clip"):
                norms, split = [], moe.model_split(params)
                clip = chain_clip(adamw(case["lr"]), case["max_norm"],
                                  mesh=mesh, split=split)

                def update(grads, state, params=None):
                    norms.append(optimizers.global_norm(grads, mesh, split))
                    return clip.update(grads, state, params)

                init, step = make_train_step(
                    cfg, case["n_clients"],
                    optimizer=clip._replace(update=update))
                state, _ = step(init(params), batch, mask, scale)
                res.update(leaves("clip_mu", state.opt_state.mu))
                res["clip_norm"] = host(norms[0])
            if case.get("masked"):
                e_cfg = cfg.replace(
                    moe_capacity_factor=cfg.n_experts / cfg.top_k)
                init, step = build_energy_train_step(
                    per_example_loss_fn=lambda p, bt: transformer.
                    per_example_loss(p, e_cfg, bt),
                    optimizer=adamw(case["lr"]), n_clients=case["n_clients"],
                    aux_loss_weight=0.0)
                other = dict(batch, **{
                    k: torch.from_numpy(inputs[f"{name}/replaced/{k}"])
                    for k in ("tokens", "labels")})
                a = step(init(params), batch, mask, scale)[0].params
                c = step(init(params), other, mask, scale)[0].params
                res["masked_same"] = np.array(same(a, c))
                ones = torch.ones_like(mask)
                a = step(init(params), batch, ones, scale)[0].params
                c = step(init(params), other, ones, scale)[0].params
                res["unmasked_same"] = np.array(same(a, c))
            if case.get("remat"):
                init, step = make_train_step(cfg.replace(remat=True),
                                             case["n_clients"], lr=case["lr"])
                state_r, metrics_r = step(init(params), batch, mask, scale)
                res["remat_same"] = np.array(
                    same(state_r.opt_state.mu, adam.opt_state.mu)
                    and same(metrics_r, metrics))
        np.savez(os.path.join(out, f"{name}_p{rank}.npz"), **res)
    D.stop_rank()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
