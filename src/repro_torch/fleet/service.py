"""`FleetService` — many slices, one service.

The fleet event loop turns a pool of serve replicas (each a `Slice` of one
`Supercomputer` running the `ServeEngine` fast path) into a single
SLO-tracked service in front of open-loop traffic:

    traffic.generate(spec)  ──►  Router ──► ServeReplica ──► Slice/Engine
                                   ▲            │
                         Autoscaler┘            └── Supercomputer.allocate/free

Time is *virtual*: every replica chunk costs its measured wall latency (or
a fixed ``chunk_s`` in deterministic mode) on the fleet clock, and replicas
overlap in virtual time because they are independent slices of the modeled
machine — one device serializes compute the hardware would run in
parallel.  Tokens, outputs and queue dynamics are all real.

Failure path (§2.3 at fleet level): `Supercomputer.fail_block` on a serving
slice propagates a `SliceEvent` into the replica's session; with no spare
the slice is LOST, the service (subscribed machine-wide) evacuates the
replica's in-flight requests and re-routes them to survivors, where their
already-decoded tokens are re-prefilled as context.  The service keeps
serving; only capacity shrinks.

Port of ``repro/fleet/service.py``.  Every replica's engine runs on the
machine's device (``Supercomputer.device``, the card by default), warmup
included, and every engine shares ONE weight tree: the service moves the
params there once, so a replica costs its KV cache, not another copy of
the weights.  With a fixed ``timing=`` every decision (routing,
autoscaling, failures, drops) depends only on virtual time and request
budgets, so a trace gives the reference's `FleetReport` exactly; the
tokens themselves are the engine's.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.cluster.registry import MachineRegistry, slice_key
from repro_torch.cluster.slices import Slice, SliceEvent
from repro_torch.cluster.straggler import (StragglerConfig,
                                           StragglerDetector)
from repro_torch.cluster.supercomputer import Supercomputer
from repro_torch.configs.base import ModelConfig
from repro_torch.fleet.autoscaler import (Autoscaler, AutoscalerConfig,
                                          ForecastConfig)
from repro_torch.fleet.replica import (ACTIVE, DEAD, DRAINING, FREED,
                                       PROVISIONING, ServeReplica)
from repro_torch.fleet.router import Router, RouterConfig
from repro_torch.fleet.traffic import FleetRequest, FleetTrace
from repro_torch.models import quant as Q
from repro_torch.obs import Telemetry, VirtualClock
from repro_torch.optim.adam import tree_map
from repro_torch.serve.engine import ServeEngine, SliceSpec, _pct

Geometry = Union[int, Tuple[int, int, int]]
# fail/repair target: a block id or symbolic spec ("spare"/"busiest"/
# "replica:<id>"/"last_failed"/"failed:<i>"), optionally machine-scoped as
# ("<machine-name>", block-or-"spare") on a multi-machine fleet
BlockSpec = Union[int, str, Tuple[str, Union[int, str]]]
FailPlan = Sequence[Tuple[float, BlockSpec]]         # (virtual_t, target)
Arrivals = Union[FleetTrace, Sequence[FleetRequest]]
Machines = Union[Supercomputer, MachineRegistry, Sequence[Supercomputer]]


def params_on(params, device: torch.device):
    """``params`` on ``device``: leaves already there are kept as they are
    (no copy), the rest are moved once."""
    def move(x):
        if isinstance(x, Q.QTensor):
            return Q.QTensor(x.q.to(device), x.scale.to(device), x.tile)
        return x.to(device)
    return tree_map(move, params)


@dataclasses.dataclass
class FleetReport:
    """What one traffic scenario did to the fleet."""
    offered: int
    completed: int
    dropped: int
    drops_by_reason: Dict[str, int]  # "wait_queue_full" / "stranded"
    migrated: int                   # requests that survived a replica death
    tokens_served: int
    tokens_offered: int
    makespan_s: float               # virtual: first arrival -> last completion
    aggregate_tokens_per_s: float   # tokens_served / makespan
    p50_ttft_s: float
    p95_ttft_s: float
    slo_attainment: float           # SLO-met completions / offered
    served_goodput: float           # tokens_served / tokens_offered
    slo_goodput: float              # tokens of SLO-met requests / offered
    scale_ups: int
    scale_downs: int
    predictive_ups: int             # scale-ups fired by the forecaster
    straggler_swaps: int            # detector-fired spare swaps
    failures: int                   # fail_block hits on fleet slices
    replicas_seen: int
    # heterogeneous-fleet economics (all zero / single-keyed on a
    # generation-less or single-machine fleet)
    energy_wh: float                # allocated-lifetime Wh across replicas
    cost_usd: float                 # allocated-lifetime $ across replicas
    perf_watt_goodput: float        # SLO-met tokens per Wh
    slo_tokens_per_usd: float       # SLO-met tokens per dollar
    replicas_by_machine: Dict[str, int]  # machine name -> replicas placed
    replica_stats: List[Dict[str, Any]]
    log: List[str]

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready summary (drops the log and per-replica stats)."""
        d = dataclasses.asdict(self)
        d.pop("log")
        d.pop("replica_stats")
        return d


class FleetService:
    """Operate a pool of serve replicas over one `Supercomputer` — or a
    `MachineRegistry` of several, spanning hardware generations — as a
    single SLO-tracked service.

    Args:
      sc: the machine, a sequence of machines, or a `MachineRegistry`
        (the service subscribes to every machine's event stream).  With
        several machines, ``placement`` decides where scale-ups land and
        each replica's chunk latency scales by its generation's fig12
        perf factor relative to the first machine's generation.
      model_cfg/params: the served model; every replica's engine shares
        one copy of ``params`` on the machines' device (moved there once).
      spec: per-replica `SliceSpec` serving envelope.
      geometry: chip shape of each replica slice.
      initial_replicas: pool size at t=0 (raised to the autoscaler floor).
      router: routing policy config (`least_loaded`/`least_eta`/RR).
      autoscale: elastic controller config; None pins the pool size.
      timing: "measured" (real chunk wall latency) or a fixed virtual
        seconds-per-chunk for machine-independent control dynamics.
      max_wait_queue: backpressure bound; beyond it requests are dropped
        and reported.
      ttft_window_s: sliding window for the observed-p95-TTFT signal.
      priority: scheduling class of this service's slices.
      preempt_on_allocate: let scale-ups cooperatively evict strictly
        lower-priority tenants (the serving-burst-evicts-training story);
        pass ``"shrink"`` to prefer asking them to *shrink* (hand back
        blocks, keep training on a smaller geometry) over full eviction.
      placement: multi-machine scale-up objective — a generation score
        ("perf" / "perf_watt" / "perf_dollar": best machine first) or
        "blind" (generation-unaware round-robin; the baseline the
        het-fleet benchmark beats).  Ignored on a single machine.
    """

    def __init__(self, sc: Machines, model_cfg: ModelConfig, params,
                 spec: Optional[SliceSpec] = None, *,
                 geometry: Geometry = (4, 4, 4),
                 initial_replicas: int = 1,
                 router: Optional[RouterConfig] = None,
                 autoscale: Optional[AutoscalerConfig] = None,
                 forecast: Optional[ForecastConfig] = None,
                 timing: Union[str, float] = "measured",
                 max_wait_queue: int = 256,
                 ttft_window_s: float = 2.0,
                 priority: int = 1,
                 preempt_on_allocate: Union[bool, str] = False,
                 placement: str = "perf_watt",
                 straggler: Optional[StragglerConfig] = None,
                 obs: Optional[Telemetry] = None):
        assert model_cfg.family != "audio", \
            "fleet serving rides the fast path; the whisper enc-dec " \
            "family has no per-slot cache insert yet"
        # normalize the machine argument into a registry; ``self.sc``
        # stays the first machine so single-machine callers are untouched
        if isinstance(sc, MachineRegistry):
            self.registry = sc
        elif isinstance(sc, Supercomputer):
            self.registry = MachineRegistry([sc])
        else:
            self.registry = MachineRegistry(sc)
        assert len(self.registry) > 0, "need at least one machine"
        self.machines = self.registry.machines
        self.sc = self.machines[0]
        assert all(m.device == self.sc.device for m in self.machines), \
            "the machines of one service compute on one device"
        assert placement in ("perf", "perf_watt", "perf_dollar", "blind"), \
            placement
        self.placement = placement
        self._blind_rr = 0
        # chunk-latency reference: the FIRST machine's generation (a
        # homogeneous fleet divides by 1.0 — bitwise-unchanged timing)
        ref = self.sc.generation
        self._ref_perf = ref.perf_factor if ref else 1.0
        self.cfg = model_cfg
        self.params = params_on(params, self.sc.device)
        self.spec = spec or SliceSpec()
        self.geometry = geometry
        # telemetry: share the machine's handle by default, so machine and
        # fleet events land on one timeline; when its clock is a
        # VirtualClock, the event loop advances it in step with `self.now`
        # (fleet traces read in virtual seconds)
        self.obs = obs if obs is not None else self.sc.obs
        self._vclock = (self.obs.clock
                        if isinstance(self.obs.clock, VirtualClock) else None)
        # service-local drop breakdown (the registry counters are shared
        # across services on one Telemetry; the report stays per-service)
        self.drops_by_reason: Dict[str, int] = {}
        self.router = Router(router, obs=self.obs)
        self.autoscaler = (Autoscaler(autoscale, forecast=forecast)
                           if autoscale else None)
        self.chunk_s: Optional[float] = (
            None if timing == "measured" else float(timing))
        self.max_wait_queue = max_wait_queue
        self.ttft_window_s = ttft_window_s
        # scheduling class of this service's slices.  With
        # ``preempt_on_allocate`` a scale-up that cannot be placed asks the
        # machine to cooperatively evict strictly-lower-priority tenants
        # (an elastic training job checkpoints and frees) before giving up —
        # the serving-burst-evicts-training story of cluster/tenancy.py.
        self.priority = priority
        self.preempt_on_allocate = preempt_on_allocate
        # straggler policy: every replica gets its own detector (its slice
        # is its synchronization domain; cross-replica steps never sync)
        self.straggler_cfg = straggler
        self.deferred_scale_ups = 0     # scale-ups the machine could not place

        self.replicas: List[ServeReplica] = []
        self.retired: List[ServeReplica] = []   # freed/dead, stats only
        self.wait: deque = deque()
        self.requests: List[FleetRequest] = []
        # trace-mode accounting: when `run` serves a FleetTrace, requests
        # materialize lazily at arrival; entries dropped before ever
        # materializing are counted here instead of built just to be marked
        self._trace: Optional[FleetTrace] = None
        self._trace_stranded = 0
        # running completion counters: the measured per-replica service
        # rate (tokens/busy-second over mean tokens/request) that converts
        # an arrival-rate forecast into a replica target
        self._completed_n = 0
        self._tokens_done = 0
        self.log: List[str] = []
        self.now = 0.0
        self.failures = 0
        self.failed_blocks: List[int] = []
        # machine-scoped mirror of `failed_blocks` (job/block ids are only
        # unique per machine); repairs of "last_failed"/"failed:<i>" resolve
        # through this so they land on the machine that took the hit
        self._failed: List[Tuple[Supercomputer, int]] = []
        self._next_rep = 0
        self._by_job: Dict[Tuple[int, int], ServeReplica] = {}
        self.replicas_by_machine: Dict[str, int] = {}
        self._ttfts: deque = deque()          # (t_done, ttft) window
        self._warmed = False
        self.registry.subscribe(self._on_machine_event)
        if self.autoscaler:
            initial_replicas = max(initial_replicas,
                                   self.autoscaler.cfg.min_replicas)
        for _ in range(initial_replicas):
            self._scale_up(0.0, provision_s=0.0)

    # -- pool management ------------------------------------------------------

    def _log(self, msg: str) -> None:
        self.log.append(f"[t={self.now:8.3f}s] {msg}")

    def _drop(self, reason: str, n: int = 1, **detail) -> None:
        """Account one (or n) dropped request(s): labeled counter, a
        flight-recorder event, and a postmortem snapshot of the telemetry
        leading up to the drop (the drop-reporting trigger)."""
        self.drops_by_reason[reason] = self.drops_by_reason.get(reason, 0) + n
        self.obs.metrics.counter("fleet.drops", reason=reason).inc(n)
        self.obs.event("req.drop", cat="drop", track="router", t=self.now,
                       reason=reason, n=n, **detail)
        self.obs.postmortem("request_drop", t=self.now,
                            drop_reason=reason, n=n, **detail)

    def _machine_order(self) -> List[Supercomputer]:
        """Machines to try for the next scale-up, best first.  Generation
        placement ranks by the configured objective; ``blind`` round-robins
        registration order (the generation-unaware baseline)."""
        if self.placement == "blind":
            n = len(self.machines)
            order = [self.machines[(self._blind_rr + i) % n]
                     for i in range(n)]
            self._blind_rr += 1
            return order
        return self.registry.rank(self.placement)

    def _scale_up(self, now: float, *,
                  provision_s: Optional[float] = None
                  ) -> Optional[ServeReplica]:
        """Add capacity: reuse a draining replica when one exists (pure
        bookkeeping, no OCS programming), else allocate a fresh slice on
        the best machine under the placement objective — free capacity on
        ANY machine beats shrinking/evicting a tenant on a better one."""
        for r in self.replicas:
            if r.state == DRAINING:
                r.undrain()
                self._log(f"scale-up: undrained replica {r.rep_id}")
                self.obs.event("fleet.scale_up", cat="autoscaler",
                               track="autoscaler", t=now,
                               rep_id=r.rep_id, undrained=True)
                return r
        order = self._machine_order()
        sl = mach = None
        for m in order:
            sl = m.allocate(self.geometry, required=False,
                            priority=self.priority)
            if sl is not None:
                mach = m
                break
        if sl is None and self.preempt_on_allocate:
            for m in order:
                sl = m.allocate(self.geometry, required=False,
                                priority=self.priority,
                                preempt=self.preempt_on_allocate)
                if sl is not None:
                    mach = m
                    break
        if sl is None:
            self.deferred_scale_ups += 1
            self._log("scale-up: fleet full, allocation deferred")
            return None
        session = sl.serve(self.cfg, self.params, self.spec)
        if provision_s is None:
            provision_s = (self.autoscaler.cfg.provision_s
                           if self.autoscaler else 0.0)
        det = (StragglerDetector(self.straggler_cfg)
               if self.straggler_cfg else None)
        g = mach.generation
        chips = sl.num_chips
        rep = ServeReplica(self._next_rep, sl, session, now=now,
                           provision_s=provision_s, chunk_s=self.chunk_s,
                           straggler=det, tracer=self.obs.tracer,
                           speed=(g.perf_factor / self._ref_perf
                                  if g else 1.0),
                           watts=(g.watts_per_chip * chips if g else 0.0),
                           dollars_per_h=(g.dollars_per_chip_hour * chips
                                          if g else 0.0),
                           gen=(g.name if g else ""),
                           # blind placement stays blind end-to-end: no
                           # generation hint to the autoscaler's drain order
                           drain_rank=(g.perf_per_watt
                                       if g and self.placement != "blind"
                                       else 0.0))
        self._next_rep += 1
        self.replicas.append(rep)
        self._by_job[slice_key(sl)] = rep
        self.replicas_by_machine[mach.name] = \
            self.replicas_by_machine.get(mach.name, 0) + 1
        self._log(f"scale-up: replica {rep.rep_id} on {mach.name} "
                  f"job{sl.job_id} blocks={sl.blocks} "
                  f"(ready t+{provision_s:.2f}s)")
        self.obs.event("fleet.scale_up", cat="autoscaler", track="autoscaler",
                       t=now, rep_id=rep.rep_id, job_id=sl.job_id,
                       machine=mach.name)
        return rep

    def _scale_down(self, victim: ServeReplica) -> None:
        victim.drain()
        self._log(f"scale-down: draining replica {victim.rep_id} "
                  f"(depth={victim.depth})")
        self.obs.event("fleet.scale_down", cat="autoscaler",
                       track="autoscaler", t=self.now,
                       rep_id=victim.rep_id, depth=victim.depth)

    def _free_drained(self) -> None:
        for r in self.replicas:
            if r.drained:
                self._log(f"freed replica {r.rep_id} (drained)")
                r.free()
        # retire freed/dead replicas: a long-lived service must not keep
        # every past replica's engine (and its device KV cache) alive, nor
        # iterate them on every routing decision — retire() snapshots the
        # stats and drops the session/slice references
        gone = [r for r in self.replicas if r.state in (FREED, DEAD)]
        if gone:
            for r in gone:
                if r.t_end is None:
                    r.t_end = self.now   # stop the energy/cost meter
                self._by_job.pop(slice_key(r.slice), None)
                r.retire()
            self.retired.extend(gone)
            self.replicas = [r for r in self.replicas
                             if r.state not in (FREED, DEAD)]

    @property
    def live_replicas(self) -> List[ServeReplica]:
        """Replicas that can still do work (provisioning/active/draining)."""
        return [r for r in self.replicas
                if r.state in (PROVISIONING, ACTIVE, DRAINING)]

    def close(self) -> None:
        """Shut the service down: free every replica (each must owe no
        work — `ServeReplica.free` enforces it) and detach from the
        machine's event stream, so a long-lived `Supercomputer` hosting
        successive services does not accumulate dead subscribers."""
        for r in list(self.replicas):
            if r.state in (PROVISIONING, ACTIVE, DRAINING):
                r.free()
        self._free_drained()        # retires the freed replicas
        self.registry.unsubscribe(self._on_machine_event)

    # -- failure integration --------------------------------------------------

    def _on_machine_event(self, sl: Slice, ev: SliceEvent) -> None:
        rep = self._by_job.get(slice_key(sl))
        if rep is None:
            return
        if ev.kind == "lost":
            self.failures += 1
            orphans = rep.evacuate()
            self._log(f"replica {rep.rep_id} LOST ({ev.detail}); "
                      f"re-routing {len(orphans)} in-flight requests")
            self.obs.metrics.counter("fleet.evacuated").inc(len(orphans))
            self.obs.event("fleet.evacuate", cat="failure",
                           track=f"replica:{rep.rep_id}", t=self.now,
                           rep_id=rep.rep_id, orphans=len(orphans))
            # orphans jump the wait queue: they have already waited once
            for req in reversed(orphans):
                self.wait.appendleft(req)
            self._by_job.pop(slice_key(sl), None)
        elif ev.kind == "reconfigure":
            self.failures += 1
            self._log(f"replica {rep.rep_id} reconfigured around a failed "
                      f"block ({ev.circuits_moved} circuits, "
                      f"{ev.downtime_s * 1e3:.0f}ms stall)")

    @staticmethod
    def _machine_spare(m: Supercomputer) -> Optional[int]:
        spares = sorted(m.scheduler.free & m.scheduler.healthy)
        return spares[0] if spares else None

    def _resolve_target(self, spec: BlockSpec
                        ) -> Optional[Tuple[Supercomputer, int]]:
        """Fail-plan target resolved at fire time into (machine, block):
        a raw block id (first machine — the single-machine legacy form),
        "replica:<id>" (first block of that replica's slice, wherever it
        is), "busiest" (first block of the alive replica owing the most
        work fleet-wide), "spare" (a healthy free block — burn it to force
        the next failure into the no-spare LOST path; first machine that
        has one), or a ("<machine-name>", block-or-"spare") pair to pin
        the hit to one machine."""
        if isinstance(spec, tuple):
            name, inner = spec
            m = self.registry.get(name)
            if inner == "spare":
                b = self._machine_spare(m)
                return (m, b) if b is not None else None
            return (m, int(inner))
        if isinstance(spec, int):
            return (self.sc, spec)
        if spec == "spare":
            for m in self.machines:
                b = self._machine_spare(m)
                if b is not None:
                    return (m, b)
            return None
        if spec == "busiest":
            alive = [r for r in self.replicas
                     if r.alive and r.state != PROVISIONING]
            if not alive:
                return None
            busiest = max(alive, key=lambda r: (r.tokens_owed(), r.depth,
                                                -r.rep_id))
            return (busiest.slice._sc, busiest.slice.blocks[0])
        rep_id = int(str(spec).split(":", 1)[1])
        for r in self.replicas:
            if r.rep_id == rep_id and r.alive:
                return (r.slice._sc, r.slice.blocks[0])
        return None

    # -- dispatch -------------------------------------------------------------

    def _admit_or_wait(self, req: FleetRequest) -> None:
        if self.router.route(req, self.replicas, self.now) is not None:
            return
        if len(self.wait) < self.max_wait_queue:
            self.wait.append(req)
        else:
            req.status = "dropped"
            self._log(f"DROP req{req.fid} (wait queue full)")
            self._drop("wait_queue_full", fid=req.fid)

    def _flush_wait(self) -> None:
        while self.wait:
            if self.router.route(self.wait[0], self.replicas,
                                 self.now) is None:
                break
            self.wait.popleft()

    def _window_p95_ttft(self) -> Optional[float]:
        # keyed on COMPLETION time, evicted by filtering: completions from
        # different replicas append out of order in measured-timing mode,
        # so front-only eviction could trap stale samples behind new ones
        cutoff = self.now - self.ttft_window_s
        if self._ttfts:
            self._ttfts = deque((t, v) for t, v in self._ttfts
                                if t >= cutoff)
        if not self._ttfts:
            return None
        return _pct([v for _, v in self._ttfts], 95)

    def capacity_rps(self) -> Optional[float]:
        """Measured per-replica request service rate: decode throughput per
        busy replica-second over the observed mean tokens per completed
        request.  None until enough completions have been seen to trust
        the estimate — the forecaster abstains until then."""
        if self._completed_n < 8:
            return None
        toks = sum(r.tokens_served for r in self.replicas) \
            + sum(r.stats()["tokens_served"] for r in self.retired)
        busy = sum(r.busy_s for r in self.replicas) \
            + sum(r.stats()["busy_s"] for r in self.retired)
        if busy <= 0.0 or toks <= 0:
            return None
        mean_new = self._tokens_done / self._completed_n
        return (toks / busy) / max(1.0, mean_new)

    def _tick_autoscaler(self) -> None:
        assert self.autoscaler is not None
        action, victim = self.autoscaler.decide(
            self.now, self.replicas, len(self.wait),
            self._window_p95_ttft(), capacity_rps=self.capacity_rps())
        if action == "up":
            prev_pred = self.autoscaler.predictive_ups
            if self._scale_up(self.now) is not None:
                self.autoscaler.record("up", self.now)
                if self.autoscaler.predictive_ups > prev_pred:
                    # forecaster-fired pre-provision: mark it on the trace
                    # so a replay can tell predictive ups from reactive
                    self.obs.event("fleet.predictive_up", cat="autoscaler",
                                   track="autoscaler", t=self.now)
        elif action == "down":
            self._scale_down(victim)
            self.autoscaler.record("down", self.now)

    def warmup(self) -> None:
        """Warm the shared serving path outside virtual time: one throwaway
        engine (no slice) on the machine's device runs a request end to end,
        so replica chunk latencies never include the kernels' build and
        load or the allocator's first growth."""
        if self._warmed:
            return
        eng = ServeEngine(self.cfg, self.params, self.spec,
                          device=self.sc.device)
        eng.submit(np.arange(4, dtype=np.int32),
                   max_new_tokens=self.spec.chunk + 1)
        eng.run(max_steps=4 * self.spec.chunk)
        self._warmed = True

    # -- the event loop -------------------------------------------------------

    def run(self, requests: Arrivals, *,
            fail_plan: Optional[FailPlan] = None,
            repair_plan: Optional[FailPlan] = None,
            settle_s: float = 0.0,
            max_iters: int = 200_000,
            on_advance=None) -> FleetReport:
        """Serve one arrival trace to completion (plus ``settle_s`` virtual
        seconds of autoscaler cool-down, so drains/frees become visible).

        ``requests`` is either a `FleetTrace` (the structure-of-arrays
        form: arrivals are cursor-indexed straight off the numpy columns
        and each `FleetRequest` materializes only when its arrival time
        comes — a million-request day costs a million cheap column reads,
        not a million up-front objects) or a plain request sequence.  A
        sequence already sorted by arrival is used as-is (one O(n)
        monotonicity scan); only out-of-order input pays the sort.

        ``fail_plan``/``repair_plan`` inject `fail_block`/`repair_block`
        calls at virtual times; a repair target of ``"last_failed"``
        resolves to the most recently failed block at fire time (and
        ``"failed:<i>"`` to the i-th injected failure), so a scenario can
        kill a serving block and later hand it back for the autoscaler to
        reclaim.

        ``on_advance(now)`` is called after every virtual-clock advance —
        the co-tenancy hook: `cluster.tenancy` uses it to run training
        quanta in step with fleet time (the two tenants hold disjoint
        slices, so their compute overlaps in virtual time)."""
        if self.chunk_s is None:
            self.warmup()
        trace = requests if isinstance(requests, FleetTrace) else None
        if trace is not None:
            n_arr = len(trace)
            arr_t = trace.t_arrival
            self.requests = []          # filled as arrivals materialize
            arrivals: List[FleetRequest] = []
        else:
            arrivals = list(requests)
            key = lambda r: (r.t_arrival, r.fid)        # noqa: E731
            if any(key(arrivals[i]) > key(arrivals[i + 1])
                   for i in range(len(arrivals) - 1)):
                arrivals.sort(key=key)
            n_arr = len(arrivals)
            arr_t = None
            self.requests = list(arrivals)
        self._trace = trace
        self._trace_stranded = 0
        fails = sorted(fail_plan or [], key=lambda f: f[0])
        repairs = sorted(repair_plan or [], key=lambda f: f[0])
        ai = fi = ri = 0
        tick = self.autoscaler.cfg.tick_s if self.autoscaler else None
        next_tick = 0.0 if tick else float("inf")
        # settle is measured from the last *event* — which, for a re-entered
        # service (windowed tenancy driving), starts at the current clock,
        # so an idle follow-up run still grants the autoscaler settle_s of
        # tick time to drain surplus replicas
        last_event_t = self.now

        def next_arrival_t() -> float:
            return float(arr_t[ai]) if trace is not None \
                else arrivals[ai].t_arrival

        def work_remaining() -> bool:
            if (ai < n_arr or fi < len(fails) or ri < len(repairs)
                    or self.wait):
                return True
            return any(r.state in (PROVISIONING, ACTIVE, DRAINING)
                       and r.session.engine.depth > 0
                       for r in self.replicas)

        for _ in range(max_iters):
            # promote warmed-up replicas, release finished drains
            for r in self.replicas:
                if r.state == PROVISIONING and self.now >= r.ready_at:
                    r.state = ACTIVE
            self._free_drained()

            if not work_remaining():
                if (self.autoscaler is None
                        or self.now >= last_event_t + settle_s):
                    break
                steady = (not any(r.state == DRAINING
                                  for r in self.replicas)
                          and len(self.live_replicas)
                          <= self.autoscaler.cfg.min_replicas)
                if steady:
                    break
                self.now = max(self.now, next_tick)
                if self._vclock is not None:
                    self._vclock.advance(self.now)
                self._tick_autoscaler()
                next_tick = self.now + tick
                continue

            # -- next event time ---------------------------------------------
            cands: List[float] = []
            if ai < n_arr:
                cands.append(next_arrival_t())
            if fi < len(fails):
                cands.append(fails[fi][0])
            if ri < len(repairs):
                cands.append(repairs[ri][0])
            starts = [s for s in (r.next_start() for r in self.replicas)
                      if s is not None]
            cands.extend(starts)
            if tick:
                # ticks run whenever the loop is alive: an idle gap before
                # a distant repair must still drain surplus replicas
                cands.append(next_tick)
            # capacity can never return: no live replicas, no healthy free
            # blocks, and no repairs left to change that — fail the
            # stranded (and still-arriving) requests loudly instead of
            # spinning ticks until max_iters
            dead_end = (not self.live_replicas and ri >= len(repairs)
                        and self.registry.free_healthy_blocks() == 0)
            if dead_end and (self.wait or ai < n_arr):
                # before declaring the requests stranded, try one scale-up:
                # with `preempt_on_allocate` the machine may still carve a
                # slice out of a lower-priority tenant (e.g. an elastic
                # training job that checkpoints and frees on request)
                if self._scale_up(self.now) is not None:
                    # capacity reclaimed: hand it the stranded work so the
                    # new replica appears in the next event-time sweep
                    self._flush_wait()
                    continue
            if not cands or (dead_end and (self.wait or ai < n_arr)):
                stranded = list(self.wait)
                self.wait.clear()
                n_unmat = 0
                if trace is not None:
                    # never-materialized trace entries are counted dropped,
                    # not built just to be stamped — at fleet scale that is
                    # the difference between a counter and a million objects
                    n_unmat = n_arr - ai
                    self._trace_stranded += n_unmat
                else:
                    stranded += arrivals[ai:]
                ai = n_arr
                for req in stranded:
                    req.status = "dropped"
                self._log(f"no capacity and no path to any: dropped "
                          f"{len(stranded) + n_unmat} stranded requests")
                if stranded or n_unmat:
                    self._drop("stranded", n=len(stranded) + n_unmat)
                break
            self.now = max(self.now, min(cands))
            if self._vclock is not None:
                self._vclock.advance(self.now)
            if on_advance is not None:
                on_advance(self.now)

            # -- injected failures / repairs ---------------------------------
            while fi < len(fails) and fails[fi][0] <= self.now:
                tgt = self._resolve_target(fails[fi][1])
                if tgt is None:
                    # a scenario that declares a failure must see it land or
                    # know it didn't — silent skips make benchmarks measure
                    # something other than what they claim
                    self._log(f"SKIPPED fail_block({fails[fi][1]!r}): "
                              f"target did not resolve")
                else:
                    mach, block = tgt
                    self._log(f"injecting fail_block({block}) "
                              f"on {mach.name}")
                    self.failed_blocks.append(block)
                    self._failed.append((mach, block))
                    mach.fail_block(block)  # subscription handles rerouting
                    last_event_t = self.now
                fi += 1
            while ri < len(repairs) and repairs[ri][0] <= self.now:
                spec_b = repairs[ri][1]
                ri += 1
                if spec_b == "last_failed":
                    if not self._failed:
                        continue
                    tgt = self._failed[-1]
                elif isinstance(spec_b, str) and spec_b.startswith("failed:"):
                    # "failed:<i>": i-th injected failure of this service's
                    # lifetime — lets a plan that burns spares repair each
                    # of them individually
                    i = int(spec_b.split(":", 1)[1])
                    if i >= len(self._failed):
                        continue
                    tgt = self._failed[i]
                else:
                    tgt = self._resolve_target(spec_b)
                if tgt is not None:
                    mach, block = tgt
                    self._log(f"repair_block({block}) on {mach.name}")
                    mach.repair_block(block)
                    last_event_t = self.now
            # -- arrivals ----------------------------------------------------
            while ai < n_arr and next_arrival_t() <= self.now:
                if trace is not None:
                    req = trace.request(ai)
                    self.requests.append(req)
                else:
                    req = arrivals[ai]
                if self.autoscaler is not None:
                    self.autoscaler.observe_arrival(req.t_arrival)
                tr = self.obs.tracer
                if tr.enabled:
                    tr.event("req.arrival", cat="request", track="router",
                             t=req.t_arrival, fid=req.fid)
                self._admit_or_wait(req)
                ai += 1
            # -- autoscaler tick ---------------------------------------------
            if tick and self.now >= next_tick:
                self._tick_autoscaler()
                next_tick = self.now + tick
            # -- replica chunks ----------------------------------------------
            for r in list(self.replicas):
                if r.runnable(self.now):
                    for done in r.step(self.now):
                        self._ttfts.append((done.t_done, done.ttft_s))
                        self._completed_n += 1
                        self._tokens_done += len(done.out_tokens)
                        last_event_t = max(last_event_t, done.t_done)
            # completions freed slots; drain the wait queue into them
            self._flush_wait()
        else:
            raise RuntimeError(f"fleet loop did not converge in "
                               f"{max_iters} iterations")
        return self._report()

    # -- reporting ------------------------------------------------------------

    def report_for(self, requests: Sequence[FleetRequest]) -> FleetReport:
        """Build a `FleetReport` over an arbitrary request population —
        used by windowed drivers (`cluster.tenancy`) that feed one trace
        through several `run` calls and want one merged report at the end."""
        return self._report(requests)

    def _report(self, requests: Optional[Sequence[FleetRequest]] = None
                ) -> FleetReport:
        reqs = list(requests) if requests is not None else self.requests
        trace = self._trace if requests is None else None
        done = [r for r in reqs if r.status == "done"]
        dropped = [r for r in reqs if r.status == "dropped"]
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        tokens = sum(len(r.out_tokens) for r in done)
        offered_n = len(reqs)
        dropped_n = len(dropped)
        offered_tok = sum(r.max_new_tokens for r in reqs)
        t0 = min((r.t_arrival for r in reqs), default=0.0)
        if trace is not None and len(trace):
            # trace-mode: offered load comes from the columns — entries the
            # dead-end path dropped without materializing still count
            offered_n = len(trace)
            dropped_n += self._trace_stranded
            offered_tok = trace.tokens_offered
            t0 = float(trace.t_arrival[0])
        t1 = max((r.t_done for r in done if r.t_done), default=t0)
        makespan = max(t1 - t0, 1e-9)
        asc = self.autoscaler
        slo_tok = sum(len(r.out_tokens) for r in done if r.met_slo)
        # energy/cost meter: live replicas are charged up to `now`; retired
        # ones were stamped with t_end when freed/lost
        energy = sum(r.energy_wh(self.now) for r in self.replicas) \
            + sum(r.stats().get("energy_wh", 0.0) for r in self.retired)
        cost = sum(r.cost_usd(self.now) for r in self.replicas) \
            + sum(r.stats().get("cost_usd", 0.0) for r in self.retired)
        return FleetReport(
            offered=offered_n,
            completed=len(done),
            dropped=dropped_n,
            drops_by_reason=dict(self.drops_by_reason),
            migrated=sum(1 for r in reqs if r.migrations > 0),
            tokens_served=tokens,
            tokens_offered=offered_tok,
            makespan_s=round(makespan, 4),
            aggregate_tokens_per_s=round(tokens / makespan, 2),
            p50_ttft_s=round(_pct(ttfts, 50), 4),
            p95_ttft_s=round(_pct(ttfts, 95), 4),
            slo_attainment=round(
                sum(1 for r in done if r.met_slo) / max(1, offered_n), 4),
            served_goodput=round(tokens / max(1, offered_tok), 4),
            slo_goodput=round(slo_tok / max(1, offered_tok), 4),
            scale_ups=asc.scale_ups if asc else 0,
            scale_downs=asc.scale_downs if asc else 0,
            predictive_ups=asc.predictive_ups if asc else 0,
            straggler_swaps=sum(r.straggler_swaps
                                for r in self.retired + self.replicas),
            failures=self.failures,
            replicas_seen=self._next_rep,
            energy_wh=round(energy, 6),
            cost_usd=round(cost, 8),
            perf_watt_goodput=round(slo_tok / energy, 4) if energy > 0
            else 0.0,
            slo_tokens_per_usd=round(slo_tok / cost, 4) if cost > 0
            else 0.0,
            replicas_by_machine=dict(self.replicas_by_machine),
            replica_stats=[r.stats()
                           for r in self.retired + self.replicas],
            log=list(self.log),
        )
