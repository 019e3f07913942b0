"""Energy-aware distributed LM training driver.

Port of ``repro.launch.train``. Runs a ported ``--arch`` (full or
``--reduced`` smoke variant) under any scheduler (alg1 / alg2 /
benchmark1 / benchmark2 / oracle) and any registered arrival family
(periodic / binary / uniform / the non-stationary day_night profile).
The energy scheduler steps beside the SPMD train step; the (mask, scale)
it emits each step is the paper's eq. (11/12) weighting, applied inside
the train step as a coefficient on each example's loss
(:func:`repro_torch.core.trainer.build_energy_train_step`). Keys,
batches and scheduler decisions are the JAX package's bit for bit
(:mod:`repro_torch.random`), and a full-state checkpoint of either
package resumes in the other.

It runs on the CUDA card, and raises when there is none, unless
``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --reduced --steps 6 --global-batch 8 --seq-len 32 --n-clients 4 \\
        --device cpu

``main(argv)`` returns the per-step losses, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config
from repro_torch.core.energy import arrival_family_names
from repro_torch.data import GlobalBatcher, make_lm_tokens
from repro_torch.experiments import build_components
from repro_torch.launch.steps import make_train_step
from repro_torch.models import count_params, init_lm
from repro_torch.optim import adamw


def default_scheduler_for(arrivals: str, requested: str) -> str:
    if requested != "auto":
        return requested
    return "alg1" if arrivals == "periodic" else "alg2"


def zero_side_inputs(cfg, batch_size: int, device) -> dict:
    """The all-zero vision tokens / audio frames a batch of ``cfg`` carries.

    A vision config's first ``n_vision_tokens`` positions and an
    encoder-decoder's memory come from these, as in the JAX driver: the
    synthetic token stream has no image or audio of its own.
    """
    out = {}
    if cfg.n_vision_tokens:
        out["vision_embeds"] = torch.zeros(
            (batch_size, cfg.n_vision_tokens, cfg.d_model), dtype=cfg.dtype,
            device=device)
    if cfg.enc_dec:
        out["audio_feats"] = torch.zeros(
            (batch_size, cfg.enc_len, cfg.d_model), dtype=cfg.dtype,
            device=device)
    return out


def main(argv=None, *, cfg=None, params=None, on_step=None,
         side_inputs=zero_side_inputs):
    """Run the driver on ``argv`` and return the per-step losses.

    ``cfg`` trains that :class:`~repro_torch.configs.base.ArchConfig` in
    place of ``--arch``'s (``examples_torch/train_lm.py`` passes its
    presets). ``params`` starts from that parameter tree instead of one
    drawn from ``--seed`` (the rest of the run still draws from it).
    ``on_step(step, state, metrics)`` is called after each step, once its
    loss has been read back from the device. ``side_inputs(cfg,
    batch_size, device)`` gives every batch's vision tokens or audio
    frames: by default :func:`zero_side_inputs`, the JAX driver's zeros.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=cfg is None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--n-clients", type=int, default=8)
    ap.add_argument("--scheduler", default="auto",
                    help="auto|alg1|alg2|benchmark1|benchmark2|oracle")
    ap.add_argument("--arrivals", default="periodic",
                    choices=arrival_family_names())
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="legacy params-only checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--checkpoint-dir", default="",
                    help="full-state resumable checkpoints (train state + "
                         "scheduler/energy state + data RNG), written "
                         "atomically every --ckpt-every steps")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--checkpoint-dir; the resumed run is bitwise "
                         "identical to the uninterrupted one")
    ap.add_argument("--halt-at", type=int, default=0,
                    help="stop right after the full-state checkpoint at "
                         "this step (simulated preemption; components are "
                         "still built for the full --steps horizon)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (raises "
                         "without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        # A full-width step allocates 6.6 GB f32 (B, S, V) buffers
        # between 1-2 GB layer buffers; in fixed-size segments the cache
        # fragments an 80 GB card to an out-of-memory error with tens of
        # GB reserved but unusable. Segments that grow in place do not.
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    cfg = get_config(args.arch) if cfg is None else cfg
    if args.reduced:
        cfg = cfg.reduced()
    key = trandom.PRNGKey(args.seed, device=device)
    k_param, k_data, k_sched, k_energy, k_batch = trandom.split(key, 5)

    if params is None:
        params = init_lm(k_param, cfg)
    print(f"arch={cfg.name} reduced={args.reduced} "
          f"params={count_params(params):,} device={device}")

    lm = make_lm_tokens(args.seed, 512, args.seq_len, cfg.vocab)
    batcher = GlobalBatcher({"raw": lm.tokens}, n_clients=args.n_clients,
                            global_batch=args.global_batch, device=device)

    sched_name = default_scheduler_for(args.arrivals, args.scheduler)
    # Same axis registry the Study API sweeps over — a driver run is the
    # one-cell special case of a study.
    scheduler, energy = build_components(
        scheduler=sched_name, arrivals=args.arrivals,
        n_clients=args.n_clients, horizon=args.steps + 1)
    energy = energy.to(device)

    init_state, train_step = make_train_step(
        cfg, args.n_clients, optimizer=adamw(args.lr))
    state = init_state(params)
    del params

    sched_state = scheduler.init(k_sched)
    energy_state = energy.init(k_energy)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    full_ckpt = (CheckpointManager(args.checkpoint_dir)
                 if args.checkpoint_dir else None)

    start_step = 0
    if args.resume:
        # The loop state is exactly (train state, scheduler state, energy
        # state, data RNG): restoring all four and re-entering the loop at
        # the saved step replays the identical step stream, so a resumed
        # run is bitwise equal to the uninterrupted one (DESIGN.md §10).
        if full_ckpt is None:
            raise SystemExit("--resume requires --checkpoint-dir")
        last = latest_step(args.checkpoint_dir)
        if last is not None:
            template = {"state": state, "sched_state": sched_state,
                        "energy_state": energy_state, "k_batch": k_batch}
            restored, start_step = full_ckpt.restore(template, last)
            state, sched_state = restored["state"], restored["sched_state"]
            energy_state, k_batch = (restored["energy_state"],
                                     restored["k_batch"])
            print(f"resumed from {full_ckpt.path(start_step)}")

    def sched_step(sstate, estate, t, k):
        k1, k2 = trandom.split(k)
        estate, arr = energy.arrivals(estate, t, k1)
        sstate, dec = scheduler.step(sstate, t, k2, arr)
        return sstate, estate, dec.mask, dec.scale

    def full_state():
        return {"state": state, "sched_state": sched_state,
                "energy_state": energy_state, "k_batch": k_batch}

    t_start = time.time()
    losses = []
    for step in range(start_step, args.steps):
        k_batch, kb, ks = trandom.split(k_batch, 3)
        batch_raw = batcher.sample(kb)
        batch = {
            "tokens": batch_raw["raw"][:, :-1],
            "labels": batch_raw["raw"][:, 1:],
            "client_ids": batch_raw["client_ids"],
        }
        batch.update(side_inputs(cfg, args.global_batch, device))
        t = torch.full((), step, dtype=torch.int32, device=device)
        sched_state, energy_state, mask, scale = sched_step(
            sched_state, energy_state, t, ks)
        state, metrics = train_step(state, batch, mask, scale)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step, state, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss={losses[-1]:.4f}  "
                  f"active={float(metrics['active_clients']):.0f}/"
                  f"{args.n_clients}  wsum={float(metrics['weight_sum']):.3f}")
        if ckpt and step and step % args.ckpt_every == 0:
            ckpt.save(step, state.params)
        if full_ckpt and (step + 1) % args.ckpt_every == 0:
            full_ckpt.save(step + 1, full_state())
        if args.halt_at and step + 1 == args.halt_at:
            if full_ckpt is None:
                raise SystemExit("--halt-at requires --checkpoint-dir")
            if (step + 1) % args.ckpt_every != 0:
                full_ckpt.save(step + 1, full_state())
            print(f"halted at step {step + 1} (simulated preemption)")
            return losses

    dt = time.time() - t_start
    done = args.steps - start_step
    tail = (f"loss {losses[0]:.4f} -> {np.mean(losses[-10:]):.4f}"
            if losses else "already complete")
    print(f"done: {done} steps in {dt:.1f}s "
          f"({max(done, 1) / dt:.2f} steps/s); {tail}")
    if ckpt:
        ckpt.save(args.steps, state.params)
    if full_ckpt:
        full_ckpt.save(args.steps, full_state())
    return losses


if __name__ == "__main__":
    main()
