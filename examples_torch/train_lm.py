"""End-to-end driver on the port: train a ~100M-parameter LM with
energy-aware distributed SGD for a few hundred steps.

The torch counterpart of ``examples/train_lm.py``. The model is the
stablelm-1.6b *family* scaled down (same blocks, norm and MLP; f32, no
remat): ``--preset small`` (~20M params) or ``--preset 100m`` (~105M).
It runs the production driver, :func:`repro_torch.launch.train.main`,
with the preset's config passed in. It runs on the CUDA card, and
raises when there is none, unless ``--device cpu`` is given:

    PYTHONPATH=src python examples_torch/train_lm.py --steps 200
    PYTHONPATH=src python examples_torch/train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 20
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import train as train_mod

PRESETS = {
    # name: (d_model, n_layers, n_heads, n_kv, d_ff, vocab)
    "small": (384, 6, 6, 6, 1024, 8192),      # ~20M params
    "100m": (640, 10, 10, 10, 1792, 50304),   # ~105M params
}


def make_cfg(preset: str) -> ArchConfig:
    d, l, h, kv, ff, vocab = PRESETS[preset]
    base = get_config("stablelm-1.6b")
    return base.replace(
        name=f"stablelm-family-{preset}", n_layers=l, d_model=d, n_heads=h,
        n_kv_heads=kv, head_dim=d // h, d_ff=ff, vocab=vocab,
        dtype_name="float32", remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--n-clients", type=int, default=8)
    ap.add_argument("--scheduler", default="alg1")
    ap.add_argument("--arrivals", default="periodic")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = make_cfg(args.preset)
    if args.global_batch % args.n_clients:
        args.n_clients = max(1, args.global_batch // 2)  # keep divisible
    driver_args = [
        "--arch", cfg.name,
        "--steps", str(args.steps),
        "--global-batch", str(args.global_batch),
        "--seq-len", str(args.seq_len),
        "--n-clients", str(args.n_clients),
        "--scheduler", args.scheduler,
        "--arrivals", args.arrivals,
    ]
    if args.device:
        driver_args += ["--device", args.device]
    losses = train_mod.main(driver_args, cfg=cfg)
    assert np.mean(losses[-10:]) < losses[0], "loss must decrease"
    print("train_lm: loss decreased ✓")
    return losses


if __name__ == "__main__":
    main()
