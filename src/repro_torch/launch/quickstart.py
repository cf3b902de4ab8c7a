"""Quickstart of the port: allocate a slice, train, then serve.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

The twin of ``examples/quickstart.py`` through ``repro_torch.cluster``:
allocate an (8, 8, 8) slice of the 4096-chip machine, train reduced
olmo-1b for 30 steps with checkpoints every 10 (in a temporary
directory), serve 4 requests on the trained weights, free the slice and
print the machine's utilization.  Runs on the card unless ``--device
cpu`` is given.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.cluster import SliceSpec, Supercomputer
from repro_torch.configs import registry
from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                      RunConfig, ShapeConfig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sc = Supercomputer(device=args.device)     # 64 blocks = 4096 chips
    sl = sc.allocate((8, 8, 8))                # 512-chip slice, any blocks
    print(f"allocated {sl.describe()} on blocks {sl.blocks}")
    print(f"  all-reduce(1 GiB) estimate: "
          f"{sl.cost.all_reduce(2 ** 30) * 1e3:.1f} ms")

    run = RunConfig(
        model=registry.get_reduced("olmo-1b"),
        shape=ShapeConfig("quick", "train", 64, 8),
        parallel=ParallelConfig(remat="none"),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=5))

    with tempfile.TemporaryDirectory() as ckpt:
        train = sl.train(run, 30, ckpt_dir=ckpt, ckpt_every=10, log_every=5)
        print("\ntraining log:")
        for m in train.metrics_log:
            print(f"  step {m['step']:3d}  loss {m.get('loss', 0):.4f}")

        print("\nserving 4 requests on the trained weights:")
        serve = sl.serve(run.model, train.params,
                         SliceSpec(slots=2, max_len=96, prompt_len=16))
        for i in range(4):
            serve.submit(np.arange(8) + i, max_new_tokens=8)
        stats = serve.run()
        print(f"  {stats['requests_done']} requests, "
              f"{stats['tokens']} tokens, "
              f"{stats['tokens_per_s']:.1f} tok/s")

    sl.free()
    print(f"\nslice freed; machine utilization {sc.utilization():.2f}")
    return train, stats, sc


if __name__ == "__main__":
    main()
