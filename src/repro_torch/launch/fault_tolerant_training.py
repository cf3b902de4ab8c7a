"""Fault-tolerant training on the port: block failure -> OCS re-route ->
restore.

    PYTHONPATH=src python -m repro_torch.launch.fault_tolerant_training \
        [--device cpu]

The twin of ``examples/fault_tolerant_training.py`` through
``repro_torch.cluster``: two (8, 8, 8) slices coexist on one machine, a
clean reference run and a faulted one.  Both train reduced olmo-1b for 12
steps with checkpoints every 4 (in temporary directories); a block of the
faulted slice dies at step 7, the supercomputer swaps a spare in, and the
session restores step 4 and finishes on the clean run's losses.  Runs on
the card unless ``--device cpu`` is given.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.cluster import Supercomputer
from repro_torch.configs import registry
from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                      RunConfig, ShapeConfig)


def example_run() -> RunConfig:
    """The example's run: reduced olmo-1b, 8 rows of 32 tokens, lr 1e-3."""
    return RunConfig(
        model=registry.get_reduced("olmo-1b"),
        shape=ShapeConfig("ft", "train", 32, 8),
        parallel=ParallelConfig(remat="none"),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2))


def drill(run: RunConfig, device="cuda"):
    """Train ``run`` for 12 steps (checkpoints every 4) clean and with a
    block failure at step 7 on two (8, 8, 8) slices of one machine on
    ``device``, print the example's report and return ``(machine, faulted
    session, reference session)``."""
    sc = Supercomputer(device=device)
    faulted = sc.allocate((8, 8, 8))
    reference = sc.allocate((8, 8, 8))
    print(f"faulted run on {faulted.describe()} blocks {faulted.blocks}")
    print(f"reference on   {reference.describe()} blocks {reference.blocks}")

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref = reference.train(run, 12, ckpt_dir=d2, ckpt_every=4,
                              log_every=1)
        sess = faulted.train(run, 12, ckpt_dir=d1, ckpt_every=4,
                             fail_at=7, log_every=1)

    print("\nmachine events:")
    for e in sc.events:
        print("  ", e)
    print("\nsession interruptions:")
    for ev in sess.interruptions:
        print(f"   {ev.kind}: {ev.detail} ({ev.circuits_moved} circuits, "
              f"{ev.downtime_s * 1e3:.0f} ms)")

    restarts = sum(1 for m in sess.metrics_log if m.get("event"))
    losses = {m["step"]: m["loss"] for m in sess.metrics_log if "loss" in m}
    ref_losses = {m["step"]: m["loss"] for m in ref.metrics_log
                  if "loss" in m}
    final = max(losses)
    print(f"\nsteps run:         {sess.state.step}")
    print(f"restarts:          {restarts}")
    print(f"final loss:        {losses[final]:.4f}")
    print(f"matches clean run: "
          f"{bool(np.isclose(losses[final], ref_losses[final], rtol=1e-5))}")

    faulted.free()
    reference.free()
    return sc, sess, ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return drill(example_run(), args.device)


if __name__ == "__main__":
    main()
