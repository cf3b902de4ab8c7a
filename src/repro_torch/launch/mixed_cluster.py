"""Mixed train+serve cluster on the port: preemptible training under a
diurnal fleet.

    PYTHONPATH=src python -m repro_torch.launch.mixed_cluster [--device cpu]

The twin of ``examples/mixed_cluster.py`` through ``repro_torch``: one
`Supercomputer` of 4 blocks, two tenants.  A serving fleet (priority 1,
reduced olmo-1b with random weights from seed 0) autoscales against a
diurnal traffic curve and, when the machine is full, evicts the elastic
training tenant (priority 0, reduced olmo-1b) through the scheduler: the
trainer checkpoints (in a temporary directory), frees its blocks, and
resumes at the trough on whatever geometry then fits, continuing the same
loss curve.  Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import tempfile

from repro_torch.cluster import (ElasticTrainJob, MixedTenancyDriver,
                                 SliceSpec, Supercomputer, TrainTenantSpec)
from repro_torch.configs import registry
from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                      RunConfig, ShapeConfig)
from repro_torch.fleet import (AutoscalerConfig, FleetService, TrafficSpec,
                               generate)
from repro_torch.models import api


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sc = Supercomputer(num_blocks=4, device=args.device)  # 256 chips
    cfg = registry.get_reduced("olmo-1b")
    params = api.init_params(cfg, seed=0, device=sc.device)
    run = RunConfig(model=cfg,
                    shape=ShapeConfig("mixed", "train", 32, 4),
                    parallel=ParallelConfig(remat="none"),
                    optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2))

    svc = FleetService(
        sc, cfg, params,
        SliceSpec(slots=4, max_len=64, prompt_len=16, chunk=8),
        geometry=(4, 4, 4), initial_replicas=1, timing=0.15,
        autoscale=AutoscalerConfig(min_replicas=1, max_replicas=3,
                                   tick_s=0.05, cooldown_s=0.3,
                                   scale_up_backlog=3.0,
                                   scale_down_backlog=0.5,
                                   provision_s=0.1),
        priority=1, preempt_on_allocate=True)   # bursts may evict training

    with tempfile.TemporaryDirectory() as ckpt:
        job = ElasticTrainJob(sc, TrainTenantSpec(
            run=run, target_steps=60, ckpt_dir=ckpt,
            geometries=((4, 4, 12), (4, 4, 8), (4, 4, 4)),
            priority=0, base_step_s=0.25))
        job.try_start(0.0)
        print(f"training starts on {job.slice.dims} "
              f"(blocks {job.slice.blocks})")

        trace = generate(TrafficSpec(
            duration_s=4.0, rate_rps=14.0, pattern="diurnal",
            trough_frac=0.1, diurnal_period_s=4.0,
            new_tokens_choices=(16, 32), new_tokens_weights=(0.5, 0.5),
            prompt_len_max=8), seed=5)
        print(f"serving a diurnal day of {len(trace)} requests...")

        drv = MixedTenancyDriver(svc, job, window_s=0.5)
        rep = drv.run(trace, extra_windows=6)
        svc.close()

        print(f"\nserve : {rep.serve['completed']}/{rep.serve['offered']} "
              f"requests, slo_goodput={rep.serve['slo_goodput']:.2f}, "
              f"scale_ups={rep.serve['scale_ups']}, "
              f"scale_downs={rep.serve['scale_downs']}")
        print(f"train : {rep.train_steps}/{rep.train_target} steps, "
              f"{rep.train_preemptions} preemptions, "
              f"{rep.train_resumes} resumes, {rep.train_grows} grows")
        print(f"combined score: {rep.combined_score}")
        print("\ntraining odyssey:")
        for line in job.log:
            print(f"  {line}")
    assert rep.serve["completed"] + rep.serve["dropped"] \
        == rep.serve["offered"]
    return rep, job, sc


if __name__ == "__main__":
    main()
