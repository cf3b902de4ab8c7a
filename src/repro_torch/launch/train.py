"""Command-line training of the port, on one device or over ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --reduced --device cpu --steps 20 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --reduced --device cpu --steps 3 --grad-compression int8
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm0 \
        --reduced --device cpu --steps 20 --batch 64
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-moe-30b-a3b --reduced --device cpu --steps 20 \
        --batch 8 --seq 64 --optimizer adafactor
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --reduced --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --reduced --device cpu --steps 3

    # data-parallel over 4 ranks (one process a rank):
    PYTHONPATH=src torchrun --nproc-per-node 4 -m \
        repro_torch.launch.train --arch olmo-1b --grad-compression int8

trains on the card by default (``--device cpu`` for the CPU) with
``--optimizer`` (adam, sgd or adafactor, as the reference offers) and
``--grad-compression`` (none, int8 or topk: the data-parallel exchange,
or its round trip on one device; ``parallel/compression.py``), and prints
one JSON line of metrics per logged step, as ``repro.launch.train`` does;
``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps and resumes from
the latest checkpoint there.

Started with ``WORLD_SIZE`` > 1 in its environment (``torchrun`` sets it,
with ``RANK``, ``LOCAL_RANK`` and the rendezvous), it joins the default
process group through ``--init-method`` (``env://`` by default): NCCL
where every rank of the host has a card of its own (``cuda:LOCAL_RANK``),
gloo where the ranks share one card or with ``--device cpu``.  It trains
over a (world, 1) ("data", "model") mesh, each rank on its rows of each
batch, and only rank 0 prints.
"""
import argparse
import json
import os

from repro_torch.configs import registry
from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                      RunConfig, ShapeConfig)
from repro_torch.parallel.context import LOCAL, ParallelContext
from repro_torch.train.trainer import Trainer, rank_device


def ranked_context(device: str, init_method: str) -> ParallelContext:
    """Under ``WORLD_SIZE`` > 1: join the default process group and return
    a context on a (world, 1) ("data", "model") mesh; else ``LOCAL``."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return LOCAL
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dev = rank_device(device)
    own_card = dev.type == "cuda" and dev.index is not None
    if own_card:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if own_card else "gloo",
                            init_method=init_method, world_size=world,
                            rank=int(os.environ["RANK"]))
    return ParallelContext(mesh=make_mesh((world, 1), ("data", "model")))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(registry.ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens a sequence (decoder archs)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--remat", default="none", choices=["none", "block"])
    ap.add_argument("--optimizer", default="adam",
                    choices=["adam", "sgd", "adafactor"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init-method", default="env://",
                    help="rendezvous of the ranks under WORLD_SIZE > 1")
    args = ap.parse_args(argv)

    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    seq = 1 if cfg.family == "dlrm" else args.seq
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("cli", "train", seq, args.batch),
        parallel=ParallelConfig(remat=args.remat,
                                grad_compression=args.grad_compression),
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr,
                                  warmup_steps=max(args.steps // 10, 1)))
    ctx = ranked_context(args.device, args.init_method)
    trainer = Trainer(run, device=args.device, ctx=ctx,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    trainer.train(args.steps, log_every=max(args.steps // 10, 1))
    if trainer.rank == 0:
        for m in trainer.metrics_log:
            print(json.dumps(m))
    if ctx.mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return trainer.metrics_log


if __name__ == "__main__":
    main()
