"""Elastic fleet serving on the port: bursty traffic, autoscaling, a block
failure.

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet [--device cpu]

The twin of ``examples/serve_fleet.py`` through ``repro_torch``: one
`Supercomputer` of 3 blocks hosts an autoscaled pool of serve replicas
(reduced olmo-1b, random weights from seed 0) behind an SLO-aware router.
A bursty open-loop trace forces at least one scale-up and, once the burst
passes, a drain + scale-down.  Mid-run a serving block fails with no spare
left: the replica's in-flight requests re-route to the survivors and
finish there.  Time is virtual (a fixed cost a chunk), so the dynamics are
deterministic; the decoded tokens are real.  Runs on the card unless
``--device cpu`` is given.
"""
import argparse

from repro_torch.cluster import SliceSpec, Supercomputer
from repro_torch.configs import registry
from repro_torch.fleet import (AutoscalerConfig, FleetService, RouterConfig,
                               TrafficSpec, generate)
from repro_torch.models import api


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--duration", type=float, default=4.0)
    ap.add_argument("--policy", default="least_eta",
                    choices=("least_loaded", "least_eta", "round_robin"))
    ap.add_argument("--fail-at", type=float, default=2.2,
                    help="virtual time of the injected block failure "
                         "(mid-burst: the busiest replica dies)")
    args = ap.parse_args(argv)

    sc = Supercomputer(num_blocks=3, device=args.device)
    cfg = registry.get_reduced("olmo-1b")
    params = api.init_params(cfg, seed=0, device=sc.device)
    svc = FleetService(
        sc, cfg, params,
        SliceSpec(slots=4, max_len=64, prompt_len=16, chunk=8),
        geometry=(4, 4, 4),
        router=RouterConfig(policy=args.policy),
        autoscale=AutoscalerConfig(min_replicas=1, max_replicas=3,
                                   tick_s=0.05, cooldown_s=0.3,
                                   scale_up_backlog=3.0,
                                   scale_down_backlog=0.5,
                                   provision_s=0.1),
        timing=0.05)

    trace = generate(TrafficSpec(
        duration_s=args.duration, rate_rps=4.0, pattern="bursty",
        burst_x=10.0, burst_period_s=2.0, burst_len_s=0.5,
        new_tokens_choices=(8, 16, 32),
        new_tokens_weights=(0.5, 0.35, 0.15), prompt_len_max=12), seed=2)
    print(f"offered: {len(trace)} requests over {args.duration}s "
          f"(bursty), policy={args.policy}")

    # burn any idle spare just before killing the busiest replica's block,
    # so the loss cannot be absorbed by a swap: the slice goes LOST and its
    # in-flight requests must migrate to the survivors
    report = svc.run(trace,
                     fail_plan=[(args.fail_at - 0.05, "spare"),
                                (args.fail_at, "busiest")],
                     settle_s=3.0)

    print("\n-- fleet log --")
    for line in report.log:
        print("  " + line)
    print("\n-- machine events (Supercomputer.events) --")
    for e in sc.events:
        print("  " + e)

    print("\n-- report --")
    for k, v in report.to_dict().items():
        print(f"  {k}: {v}")

    ups = sum("scale-up: replica" in line or "undrained" in line
              for line in report.log)
    downs = sum("scale-down" in line for line in report.log)
    assert ups >= 1 and downs >= 1, "demo must scale up AND drain down"
    assert report.completed + report.dropped == report.offered
    svc.close()
    print(f"\nOK: {ups} scale-up(s), {downs} drain+scale-down(s), "
          f"{report.migrated} migrated, {report.completed} completed")
    return report, svc, sc


if __name__ == "__main__":
    main()
