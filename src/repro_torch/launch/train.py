"""Command-line training of the port (one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm0 --reduced \
        --device cpu --steps 20 --batch 64

trains on the card by default (``--device cpu`` for the CPU) with Adam
and prints one JSON line of metrics per logged step, as
``repro.launch.train`` does.  The DLRM trains; a dense arch raises
``NotImplementedError`` naming ROADMAP.md slice 4.
"""
import argparse
import json

from repro_torch.configs import registry
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm0", choices=list(registry.ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("cli", "train", 1, args.batch),
        optimizer=OptimizerConfig(lr=args.lr,
                                  warmup_steps=max(args.steps // 10, 1)))
    trainer = Trainer(run, device=args.device)
    trainer.train(args.steps, log_every=max(args.steps // 10, 1))
    for m in trainer.metrics_log:
        print(json.dumps(m))
    return trainer.metrics_log


if __name__ == "__main__":
    main()
