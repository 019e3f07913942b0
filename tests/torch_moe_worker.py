"""A rank of ``tests/test_torch_moe_parallel.py``'s expert-parallel runs.

Started by ``repro_torch.launch.distributed.launch_simulated(N,
command=[python, this file], argv=[in_dir, out_dir[, device]])``: it
starts its rank from the ``REPRO_DIST_*`` environment, on the CPU (gloo)
or with ``cuda`` on the card, reads the cases the test wrote to
``in_dir/cases.json`` and their inputs and parameters (the JAX
package's, as numpy, or a seed the port's ``init_lm`` draws this rank's
share from) from ``in_dir/inputs.npz``, and runs each on its mesh
(``placement.make_mesh``), every rank the same cases in the same order:

- ``layer`` cases: ``moe.apply_moe`` on this rank's rows
  (``data_rows``) with its experts (``place_params``) under
  ``use_mesh(mesh, batch=B)``: the output, the aux loss and the routing
  log's ``(top_e, keep)``;
- ``model`` cases: ``make_prefill_step`` then greedy ``make_serve_step``
  steps on this rank's rows, the logits, tokens and routing logs, and
  the prefill's K3 launches;
- ``refuse`` cases: the model run with every rank but rank 0 holding all
  the experts (no ``place_params``): each rank's error message.

Results go to ``out_dir/ep_p<rank>.npz`` and the messages to
``out_dir/errors_p<rank>.json``. Imports neither JAX nor the JAX
package.
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

    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.experiments import placement
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import distributed as D
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import moe, transformer
    from repro_torch.models.common import data_rows, use_mesh

    in_dir, out, device = (argv + ["cpu"])[:3]
    device = D.init_from_env(device=None if device == "cuda" else device)
    size, rank = placement._world()
    D.share_threads(size)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    def host(t):
        return (t.float() if t.is_floating_point() else t).cpu().numpy()

    with open(os.path.join(in_dir, "cases.json")) as f:
        cases = json.load(f)
    inputs = np.load(os.path.join(in_dir, "inputs.npz"))
    results, errors = {}, {}

    def logged(fn):
        moe.routing_log = []
        try:
            return fn(), moe.routing_log
        finally:
            moe.routing_log = None

    for case in cases["layer"]:
        name = case["name"]
        mesh = placement.make_mesh(case["mesh"])
        x = torch.from_numpy(inputs[f"layer/{name}/x"])
        rows = data_rows(x.shape[0], mesh)
        params = transformer.place_params(
            {"moe": params_from_jax(unflatten(inputs, f"layer/{name}/params"),
                                    device="cpu")}, mesh)["moe"]
        with use_mesh(mesh, batch=x.shape[0]), torch.no_grad():
            (y, aux), log = logged(lambda: moe.apply_moe(
                params, x[rows], n_experts=case["n_experts"],
                top_k=case["top_k"], capacity_factor=case["capacity_factor"],
                shared_expert=case["shared"]))
        results[f"{name}|y"] = host(y)
        results[f"{name}|aux"] = host(aux)
        results[f"{name}|top_e"] = host(log[0][0])
        results[f"{name}|keep"] = host(log[0][1])
        results[f"{name}|rows"] = np.array([rows.start, rows.stop])

    for case in cases["model"] + cases["refuse"]:
        name = case["name"]
        kw = dict(case["cfg"])
        if "superblock" in kw:  # JSON's lists back to the config's tuples
            kw["superblock"] = tuple(tuple(seg) for seg in kw["superblock"])
        cfg = get_config(case["arch"]).reduced().replace(**kw)
        mesh = placement.make_mesh(case["mesh"])
        tokens = torch.from_numpy(inputs[f"model/{name}/tokens"]).to(device)
        b = tokens.shape[0]
        rows = data_rows(b, mesh)
        if "init" in case:
            params = transformer.init_lm(
                trandom.PRNGKey(case["init"], device=device), cfg, mesh=mesh)
        else:
            params = params_from_jax(
                unflatten(inputs, f"model/{case['params']}"), device=device)
            if case in cases["model"] or rank == 0:
                params = transformer.place_params(params, mesh)
        prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
        try:
            with use_mesh(mesh, batch=b), torch.no_grad():
                fa_ops.reset_launch_counts()
                logits, log = logged(lambda: prefill(
                    params, {"tokens": tokens[rows]}))
                results[f"{name}|launches"] = np.array(
                    fa_ops.launch_counts["flash_attention"])
                results[f"{name}|prefill"] = host(logits)
                for i, (top_e, keep) in enumerate(log):
                    results[f"{name}|prefill_top_e{i}"] = host(top_e)
                    results[f"{name}|prefill_keep{i}"] = host(keep)
                states = transformer.init_decode_state(
                    cfg, rows.stop - rows.start, case["steps"], device=device)
                tok = tokens[rows, :1]
                for pos in range(case["steps"]):
                    (tok, step_logits, states), _ = logged(
                        lambda: serve(params, tok, states, pos))
                    results[f"{name}|token{pos}"] = host(tok)
                    results[f"{name}|logits{pos}"] = host(step_logits)
                    tok = tok[:, None].long()
        except ValueError as e:
            errors[name] = str(e)
        results[f"{name}|rows"] = np.array([rows.start, rows.stop])

    np.savez(os.path.join(out, f"ep_p{rank}.npz"), **results)
    with open(os.path.join(out, f"errors_p{rank}.json"), "w") as f:
        json.dump(errors, f)
    D.stop_rank()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
