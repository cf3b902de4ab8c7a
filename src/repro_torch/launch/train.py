"""Command-line training of the port (one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --reduced --device cpu --steps 20 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm0 \
        --reduced --device cpu --steps 20 --batch 64

trains on the card by default (``--device cpu`` for the CPU) with Adam
and prints one JSON line of metrics per logged step, as
``repro.launch.train`` does; ``--ckpt-dir`` checkpoints every
``--ckpt-every`` steps and resumes from the latest checkpoint there.
"""
import argparse
import json

from repro_torch.configs import registry
from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                      RunConfig, ShapeConfig)
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(registry.ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens a sequence (dense archs)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--remat", default="none", choices=["none", "block"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    seq = 1 if cfg.family == "dlrm" else args.seq
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("cli", "train", seq, args.batch),
        parallel=ParallelConfig(remat=args.remat),
        optimizer=OptimizerConfig(lr=args.lr,
                                  warmup_steps=max(args.steps // 10, 1)))
    trainer = Trainer(run, device=args.device, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every)
    trainer.train(args.steps, log_every=max(args.steps // 10, 1))
    for m in trainer.metrics_log:
        print(json.dumps(m))
    return trainer.metrics_log


if __name__ == "__main__":
    main()
