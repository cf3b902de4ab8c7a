"""`repro_torch.cluster.MachineRegistry` and a fleet over several machines
and generations, on the CPU: against the reference, and the mirror of
``tests/test_hetfleet.py``.

  * the generation registry's economics (the copied ``core.costmodel``)
    round-trip through fig12's measurement path and keep their orderings;
  * the registry's placement (objective rankings, name uniquing,
    clean-before-preempt allocation, block accounting) and its
    ``overview`` equal the reference's on the same calls;
  * a `FleetService` over a v3 + v4 registry (reduced olmo-1b, JAX's
    weights through ``repro_torch.interop``) gives the reference's
    `FleetReport` exactly under each placement objective, the streams
    within the parity bar of ``tests/test_torch_fleet.py``;
  * the reference's het-fleet tests on the port: replica speed, the
    energy meter, slo_tiered routing, and the randomized cross-machine
    soak (pooled KV, fail/repair churn: conservation, no KV block leaked,
    every machine whole after teardown).
"""
import random

import pytest
import torch

from repro import cluster as JC
from repro.core import costmodel as JCM
from repro_torch.cluster import MachineRegistry, SliceSpec, Supercomputer
from repro_torch.core.costmodel import (FIG12_APPS, GEN_V3, GEN_V4, GEN_V5P,
                                        GENERATIONS, TPU_V3, TPU_V4, TPU_V5P,
                                        app_time_per_flop,
                                        generation_speedup)
from repro_torch.fleet import (AutoscalerConfig, FleetService, RouterConfig,
                               TrafficSpec, generate)
from test_torch_fleet import AUTOSCALE, J, _model, run_both


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the reduced model's ops are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_model():
    m = _model()
    return m["tcfg"], m["tp"]


def _fleet(blocks=(2, 2, 2), gens=(GEN_V4, GEN_V3, GEN_V5P)):
    return MachineRegistry([Supercomputer(b, generation=g, device="cpu")
                            for b, g in zip(blocks, gens)])


def _jfleet(blocks=(2, 2, 2), gens=("tpu_v4", "tpu_v3", "tpu_v5p")):
    return JC.MachineRegistry([
        JC.Supercomputer(b, generation=JCM.GENERATIONS[g])
        for b, g in zip(blocks, gens)])


class TestFig12RoundTrip:
    def test_v4_perf_factor_round_trips(self):
        assert abs(generation_speedup(TPU_V4) - GEN_V4.perf_factor) < 1e-3

    def test_v5p_perf_factor_round_trips(self):
        assert abs(generation_speedup(TPU_V5P) - GEN_V5P.perf_factor) < 1e-3

    def test_v3_is_the_baseline(self):
        assert GEN_V3.perf_factor == 1.0
        assert abs(generation_speedup(TPU_V3) - 1.0) < 1e-12

    def test_per_app_speedups_stay_in_paper_bands(self):
        for name, oi, cf in FIG12_APPS:
            s = (app_time_per_flop(TPU_V3, oi)
                 / app_time_per_flop(TPU_V4, oi, cf, cmem=True))
            if name == "RNN1":
                assert s >= 2.5, (name, s)
            else:
                assert 1.4 <= s <= 2.3, (name, s)

    def test_economics_orderings(self):
        pw = {n: g.perf_per_watt for n, g in GENERATIONS.items()}
        pd = {n: g.perf_per_dollar for n, g in GENERATIONS.items()}
        assert pw["tpu_v4"] > pw["tpu_v5p"] > pw["tpu_v3"]
        assert pd["tpu_v3"] > pd["tpu_v4"] > pd["tpu_v5p"]
        assert 2.5 <= pw["tpu_v4"] / pw["tpu_v3"] <= 2.9
        assert (GEN_V5P.perf_factor > GEN_V4.perf_factor
                > GEN_V3.perf_factor)


class TestMachineRegistry:
    def test_rank_by_objective(self):
        reg = _fleet()
        assert [m.generation.name for m in reg.rank("perf_watt")] == \
            ["tpu_v4", "tpu_v5p", "tpu_v3"]
        assert [m.generation.name for m in reg.rank("perf_dollar")] == \
            ["tpu_v3", "tpu_v4", "tpu_v5p"]
        assert [m.generation.name for m in reg.rank("perf")] == \
            ["tpu_v5p", "tpu_v4", "tpu_v3"]

    def test_names_unique_on_collision(self):
        reg = MachineRegistry([Supercomputer(1, generation=GEN_V4,
                                             device="cpu"),
                               Supercomputer(1, generation=GEN_V4,
                                             device="cpu")])
        assert len(set(reg.names())) == 2

    def test_allocate_prefers_clean_placement_over_preemption(self):
        reg = _fleet()
        best = reg.rank("perf_watt")[0]
        squatter = best.allocate((4, 4, 8), priority=0)   # fills tpu_v4
        sl = reg.allocate((4, 4, 8), objective="perf_watt", priority=1,
                          preempt=True)
        assert sl is not None
        assert sl._sc is not best, "preempted instead of placing clean"
        assert squatter.status == "active"
        assert reg.free_healthy_blocks() == 2

    def test_block_accounting_spans_machines(self):
        reg = _fleet()
        assert reg.num_blocks == 6 and reg.free_healthy_blocks() == 6
        sl = reg.allocate((4, 4, 4), objective="perf")     # 1 block on v5p
        assert reg.free_healthy_blocks() == 5
        sl._sc.fail_block(sl._job.blocks[0])  # spare swap on that machine
        assert sl.status == "active"
        assert reg.free_healthy_blocks() == 4              # spare consumed
        sl.free()
        assert reg.free_healthy_blocks() == 5              # 1 still failed


def test_registry_placements_and_overview_equal_the_reference():
    """The same calls on both registries: names, rankings, where each
    allocation lands, what preemption and failures leave, the overview."""
    out = []
    for reg in (_fleet(), _jfleet()):
        res = [reg.names()]
        for obj in ("perf", "perf_watt", "perf_dollar", "blind"):
            res.append([m.name for m in reg.rank(obj)])
        a = reg.allocate((4, 4, 4), objective="perf", priority=1)
        b = reg.allocate((4, 4, 8), objective="perf_dollar", priority=0)
        c = reg.allocate((4, 4, 8), objective="perf_watt", priority=2,
                         preempt=True)
        d = reg.allocate((4, 4, 8), objective="blind", priority=0)
        res += [[(s._sc.name, s.job_id, s.blocks) if s is not None else None
                 for s in (a, b, c, d)],
                reg.free_healthy_blocks(), reg.num_blocks,
                round(reg.utilization(), 12)]
        a._sc.fail_block(a.blocks[0])
        res += [reg.free_healthy_blocks(), reg.overview()]
        out.append(res)
    assert out[0] == out[1]


@pytest.mark.parametrize("placement", ["perf_watt", "perf", "perf_dollar",
                                       "blind"])
def test_v3_v4_fleet_report_equals_reference(placement):
    """An autoscaled slo_tiered fleet over a v4 machine of 2 blocks and a
    v3 machine of 3, a spare burnt then the busiest replica's block
    failed: the reports (energy, cost, replicas by machine included),
    logs, replica stats and streams of both packages agree."""
    def machines(pkg, kw):
        if pkg is J:
            return _jfleet(blocks=(2, 3), gens=("tpu_v4", "tpu_v3"))
        return _fleet(blocks=(2, 3), gens=(GEN_V4, GEN_V3))

    (js, _, jrep), (ts, _, trep) = run_both(
        arrivals=lambda pkg: pkg.generate(pkg.TrafficSpec(
            duration_s=2.0, rate_rps=10.0, pattern="bursty", burst_x=3.0,
            burst_period_s=1.0, burst_len_s=0.3, prompt_len_max=6,
            new_tokens_choices=(4, 8), new_tokens_weights=(0.5, 0.5)),
            seed=1),
        machines=machines,
        svc_kw=lambda pkg: dict(
            placement=placement, timing=0.02,
            router=pkg.RouterConfig(policy="slo_tiered"),
            autoscale=pkg.AutoscalerConfig(**dict(AUTOSCALE,
                                                  max_replicas=4))),
        run_kw=dict(fail_plan=[(0.7, "spare"), (0.8, "busiest")],
                    settle_s=0.5))
    assert trep.completed + trep.dropped == trep.offered > 0
    assert trep.energy_wh > 0 and sum(trep.replicas_by_machine.values()) \
        == trep.replicas_seen
    ts.close()
    js.close()


SOAK_SPEC = SliceSpec(slots=2, max_len=48, prompt_len=8, chunk=4,
                      kv_block=8)


class TestHetFleetService:
    def test_replica_speed_normalized_to_reference(self, small_model):
        cfg, params = small_model
        reg = _fleet(blocks=(1, 2, 2))                    # v4 holds exactly 1
        svc = FleetService(reg, cfg, params, SOAK_SPEC, geometry=(4, 4, 4),
                           initial_replicas=2, timing=0.01,
                           placement="perf_watt")
        by_gen = {r.gen: r for r in svc.replicas}
        assert by_gen["tpu_v4"].speed == 1.0
        assert abs(by_gen["tpu_v5p"].speed
                   - GEN_V5P.perf_factor / GEN_V4.perf_factor) < 1e-12
        assert by_gen["tpu_v5p"].virtual_chunk_s \
            < by_gen["tpu_v4"].virtual_chunk_s
        svc.close()

    def test_energy_meter_is_watts_times_lifetime(self, small_model):
        cfg, params = small_model
        reg = _fleet()
        svc = FleetService(reg, cfg, params, SOAK_SPEC, geometry=(4, 4, 4),
                           initial_replicas=1, timing=0.01,
                           placement="perf_watt")
        r = svc.replicas[0]
        watts = GEN_V4.watts_per_chip * 64                # (4,4,4) chips
        assert r.watts == watts
        assert abs(r.energy_wh(3600.0) - watts) < 1e-9
        assert abs(r.cost_usd(7200.0)
                   - 2 * GEN_V4.dollars_per_chip_hour * 64) < 1e-9
        svc.close()

    def test_slo_tiered_batch_prefers_slower_pool(self, small_model):
        cfg, params = small_model
        reg = _fleet(blocks=(1, 2, 2))
        svc = FleetService(reg, cfg, params, SOAK_SPEC, geometry=(4, 4, 4),
                           initial_replicas=2, timing=0.01,
                           placement="perf_watt",
                           router=RouterConfig(policy="slo_tiered",
                                               slo_fast_ttft_s=1.0))
        trace = generate(TrafficSpec(duration_s=0.5, rate_rps=8.0,
                                     prompt_len_max=8,
                                     new_tokens_choices=(4,),
                                     new_tokens_weights=(1.0,)), seed=2)
        fast = max(svc.replicas, key=lambda r: r.speed)
        slow = min(svc.replicas, key=lambda r: r.speed)
        for req in trace:
            pick = svc.router.pick(svc.replicas, now=0.0, req=req)
            if req.ttft_slo_s > 1.0:
                assert pick is slow, "batch tier must yield fast silicon"
            else:
                assert pick is fast
        svc.close()


def _soak_plans(rng, duration):
    fails, repairs = [], []
    for i in range(rng.randint(2, 3)):
        t = rng.uniform(0.2, duration * 0.6)
        target = rng.choice(["spare", "busiest", ("tpu_v3", "spare"),
                             ("tpu_v5p", "spare")])
        fails.append((t, target))
        repairs.append((t + rng.uniform(0.3, 0.8), f"failed:{i}"))
    return sorted(fails), sorted(repairs)


@pytest.mark.parametrize("seed", [0, 7, 23])
def test_conservation_and_zero_kv_leaks(small_model, seed):
    """Three generations, pooled prefix-shared KV, seeded fail/repair/scale
    churn: conservation, leak-free KV accounting, whole machines after."""
    cfg, params = small_model
    rng = random.Random(seed)
    duration = 2.0
    reg = _fleet(blocks=(3, 3, 2))
    svc = FleetService(
        reg, cfg, params, SOAK_SPEC, geometry=(4, 4, 4),
        initial_replicas=1, timing=0.02, placement="perf_watt",
        router=RouterConfig(policy="slo_tiered"),
        autoscale=AutoscalerConfig(min_replicas=1, max_replicas=5,
                                   tick_s=0.05, cooldown_s=0.2,
                                   scale_up_backlog=2.0,
                                   scale_down_backlog=0.5,
                                   provision_s=0.05))
    trace = generate(TrafficSpec(
        duration_s=duration, rate_rps=rng.uniform(10.0, 16.0),
        pattern="bursty", burst_x=3.0, burst_period_s=1.0,
        burst_len_s=0.3, prompt_len_max=8, header_len=4,
        new_tokens_choices=(4, 8), new_tokens_weights=(0.5, 0.5)),
        seed=seed)
    fail_plan, repair_plan = _soak_plans(rng, duration)
    rep = svc.run(trace, fail_plan=fail_plan, repair_plan=repair_plan,
                  settle_s=1.0)
    assert rep.completed + rep.dropped == len(trace)
    assert rep.dropped == 0, rep.drops_by_reason
    for r in trace:
        assert r.status == "done", (r.fid, r.status)
        assert len(r.out_tokens) == r.max_new_tokens
    for r in svc.replicas:
        eng = r.session.engine
        assert eng.depth == 0
        kv = eng.kvpool
        kv.check()
        s = kv.stats()
        assert s["free_blocks"] + s["allocated_blocks"] == s["num_blocks"], s
    assert rep.energy_wh > 0 and rep.perf_watt_goodput > 0
    assert sum(rep.replicas_by_machine.values()) == rep.replicas_seen
    svc.close()
    for m in reg:
        sched = m.scheduler
        assert not sched.jobs, f"{m.name} leaked {sched.jobs}"
        allb = set(range(m.num_blocks))
        assert sched.free | (allb - sched.healthy) == allb


def test_one_service_needs_one_device(small_model):
    cfg, params = small_model
    reg = MachineRegistry([Supercomputer(1, device="cpu"),
                           Supercomputer(1, device="meta")])
    with pytest.raises(AssertionError, match="one device"):
        FleetService(reg, cfg, params, SOAK_SPEC)
