"""Train a DLRM with the port's embedding engine through a cluster training
session.

    PYTHONPATH=src python -m repro_torch.launch.train_dlrm --steps 150 \
        [--pergroup] [--device cpu]

The twin of ``examples/train_dlrm.py`` through ``repro_torch.cluster``:
allocate a (4, 4, 4) slice of an 8-block machine, open a training session
on it with checkpoints every 50 steps (in a temporary directory) and train
``demo_config()``: 12 zipf-skewed multivalent tables over widths 16, 8 and
32, deduplicated lookups, the dense interaction tower, Adam.  The fused
route (``ops.FusedLookup``: the fused lookup forward, the fused scatter
backward) is the default; ``--pergroup`` takes the per-table route
(``ops.GatherRows``: a row gather a table forward, the fused scatter a row
space backward).  ``--scale full`` is the whole of dlrm0, whose tables
need several devices: it raises before anything is allocated.  Runs on the
card unless ``--device cpu`` is given.
"""
import argparse
import tempfile

from repro_torch.cluster import Supercomputer
from repro_torch.configs import registry
from repro_torch.configs.base import (DLRMConfig, EmbeddingTableConfig,
                                      ModelConfig, OptimizerConfig,
                                      ParallelConfig, RunConfig, ShapeConfig)


def demo_config(tables: int = 12, vocab: int = 5000) -> ModelConfig:
    """Zipf-ish demo tables spread over three widths so the fused
    descriptor stream covers several width-groups."""
    dims = [16, 8, 32]
    specs = tuple(
        EmbeddingTableConfig(
            name=f"table_{i:02d}", vocab_size=vocab * (1 + i % 3),
            dim=dims[i % 3],
            avg_valency=[1.0, 4.0, 16.0][i % 3],
            max_valency=[1, 8, 32][i % 3],
            combiner="sum" if i % 2 == 0 else "mean")
        for i in range(tables))
    return ModelConfig(
        name="dlrm-demo", family="dlrm", num_layers=0, d_model=64, d_ff=0,
        vocab_size=0,
        dlrm=DLRMConfig(tables=specs, bottom_mlp=(64, 32),
                        top_mlp=(256, 128, 1), dense_features=13,
                        interaction="cat"))


def example_config(scale: str) -> ModelConfig:
    """``demo_config()`` for ``--scale demo``; ``--scale full`` raises."""
    if scale == "full":
        cfg = registry.get_config("dlrm0")
        n = sum(t.vocab_size * t.dim for t in cfg.dlrm.tables)
        raise NotImplementedError(
            f"--scale full trains the whole of dlrm0 ({n / 1e9:.1f}e9 table "
            f"parameters: {16 * n / 1e9:.0f} GB of f32 params, gradient, m "
            f"and v), which needs several devices; that is not ported to "
            f"repro_torch yet (ROADMAP.md queue 1, item 12)")
    return demo_config()


def example_run(cfg: ModelConfig, batch: int = 256,
                pergroup: bool = False) -> RunConfig:
    """The example's run of ``cfg``: ``batch`` samples a step, Adam at lr
    3e-4 after 20 warm-up steps, the per-table route with ``pergroup``."""
    return RunConfig(
        model=cfg,
        shape=ShapeConfig("dlrm", "train", 1, batch),
        parallel=ParallelConfig(remat="none", emb_pipeline=not pergroup),
        optimizer=OptimizerConfig(lr=3e-4, warmup_steps=20))


def train_dlrm(run: RunConfig, steps: int = 150, device="cuda", *,
               state=None, log_every: int = 10):
    """Train ``run`` for ``steps`` on a (4, 4, 4) slice of an 8-block
    machine on ``device`` (from ``state``, a `TrainerState` on that
    device, when given), logging every ``log_every`` steps; print the
    example's report and return the session."""
    sc = Supercomputer(num_blocks=8, device=device)
    with tempfile.TemporaryDirectory() as ckpt, \
            sc.allocate((4, 4, 4)) as slice_:
        print(f"slice: {slice_.describe()}")
        session = slice_.train(run, ckpt_dir=ckpt, ckpt_every=50)
        session.run(steps, log_every=log_every, state=state)
        print("\nstep   bce-loss")
        for m in session.metrics_log:
            if "loss" in m:
                print(f"{m['step']:5d}  {m['loss']:.4f}")
        losses = [m["loss"] for m in session.metrics_log if "loss" in m]
        first, last = losses[0], losses[-1]
        print(f"\nloss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return session


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--scale", choices=["demo", "full"], default="demo")
    ap.add_argument("--pergroup", action="store_true",
                    help="the per-table lookup route instead of the fused "
                         "one")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    run = example_run(example_config(args.scale), args.batch, args.pergroup)
    return train_dlrm(run, args.steps, args.device)


if __name__ == "__main__":
    main()
