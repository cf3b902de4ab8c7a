"""Mixed train+serve tenancy: training as an elastic, preemptible tenant.

The paper's availability argument (§2.3, §2.5) is that OCS reconfiguration
lets one machine carve, resize, and reclaim slices around failures and
shifting demand.  `repro_torch.fleet` already flexes *serving* capacity; this
module makes *training* the other tenant of the same machine:

  * `ElasticTrainJob` — a training run that lives across slices.  It
    allocates the largest geometry (from a preference list) that currently
    fits, trains real steps in window-sized quanta, and reacts to a
    ``"preempt"`` `SliceEvent` by checkpointing (slice-shape-elastic, see
    `train.checkpoint`), freeing its blocks, and waiting.  A later
    resume may land on a *different* geometry — the loss curve continues
    bitwise-identically because the checkpoint carries params + optimizer
    state + the data cursor, and the global batch is unchanged.
  * `MixedTenancyDriver` — the co-scheduler: one `Supercomputer`, one
    `FleetService` (high priority), one `ElasticTrainJob` (low priority).
    The fleet's virtual clock is chopped into windows; each window first
    serves its arrivals/failures, then lets training catch up with a
    quantum of real train steps.  A serving burst that cannot place a new
    replica evicts the training job through the scheduler's priority
    machinery (`FleetService(preempt_on_allocate=True)` →
    `Supercomputer.request_preemption`); at the trough the driver resumes
    training on whatever blocks drained replicas left behind.

Training throughput is geometry-aware in *virtual* time: a step on ``g``
blocks costs ``base_step_s / g`` virtual seconds (ideal data-parallel
scaling), so holding more blocks at the trough genuinely buys steps — the
utilization the static-partition baseline cannot reach.  The steps
themselves are real torch computation on the machine's device at fixed
global batch regardless of geometry (one device serializes what the
hardware would spread).

Port of ``repro/cluster/tenancy.py``.  An evicted, shrunk or finished job
drops its session, and with it the trainer's params and optimizer state,
so the device memory they held goes back to the allocator before the
requester's allocation returns (the serving burst gets it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import (TYPE_CHECKING, Any, Dict, List, Optional, Sequence,
                    Tuple, Union)

from repro_torch.cluster.registry import MachineRegistry
from repro_torch.cluster.slices import Slice, SliceEvent, TrainSession
from repro_torch.cluster.supercomputer import Supercomputer
from repro_torch.configs.base import RunConfig

if TYPE_CHECKING:                                     # pragma: no cover
    from repro_torch.fleet.service import FleetService
    from repro_torch.fleet.traffic import FleetRequest

WAITING = "waiting"          # never started, or not yet re-placed
RUNNING = "running"          # holds a slice, training in quanta
PREEMPTED = "preempted"      # evicted; checkpointed and block-less
DONE = "done"                # reached target_steps


def _blocks_needed(dims: Tuple[int, int, int]) -> int:
    a, b, c = dims
    return (a // 4) * (b // 4) * (c // 4)


def shrink_target(geometries: Sequence[Tuple[int, int, int]],
                  held_blocks: int, blocks_requested: int
                  ) -> Optional[Tuple[int, int, int]]:
    """Pick the geometry a cooperative tenant shrinks to when asked to hand
    back ``blocks_requested`` of its ``held_blocks``.

    Pure policy (property-tested in isolation): among the tenant's
    acceptable ``geometries`` (preference order, largest first), take the
    LARGEST one that both strictly shrinks and frees the full request;
    when none frees enough, fall back to the smallest acceptable geometry
    (best-effort — every freed block still helps the requester's tally).
    Returns None when the tenant is already at (or below) its minimum
    geometry: a shrink never strands the gang below the smallest shape it
    declared it can train on."""
    cands = [tuple(d) for d in geometries
             if _blocks_needed(d) < held_blocks]
    if not cands:
        return None
    for dims in cands:
        if held_blocks - _blocks_needed(dims) >= blocks_requested:
            return dims
    return cands[-1]


@dataclasses.dataclass(frozen=True)
class TrainTenantSpec:
    """Configuration of one elastic training tenant.

    Args:
      run: the training `RunConfig` (model/shape/parallel/optimizer); the
        global batch is fixed by it, independent of slice geometry.
      target_steps: stop after this many global steps.
      ckpt_dir: checkpoint root shared across every slice the job touches.
      geometries: acceptable chip geometries in preference order (largest
        first); resume takes the first that fits the machine's free blocks.
      priority: scheduling priority (keep it below the serving fleet's so
        bursts can evict training; between trainers it is the tier — a
        higher-priority trainer is shrunk/evicted last).
      base_step_s: virtual seconds one step costs on ONE block; on ``g``
        blocks a step costs ``base_step_s / g`` (ideal DP scaling).
      ckpt_every: periodic checkpoint interval in steps (preemption always
        checkpoints regardless).
      log_every: trainer metric logging period.
      name: label in logs/reports (several tenants share one machine).
      objective: machine-ranking objective for placement on a multi-machine
        registry — "perf_dollar" (default: deadline-free training drains
        to the cheapest silicon) or any other `MachineRegistry` objective
        ("blind" = registration order, the generation-unaware baseline).
    """
    run: RunConfig
    target_steps: int
    ckpt_dir: str
    geometries: Sequence[Tuple[int, int, int]] = ((4, 4, 8), (4, 4, 4))
    priority: int = 0
    base_step_s: float = 0.25
    ckpt_every: int = 10
    log_every: int = 1
    name: str = "train"
    objective: str = "perf_dollar"


class ElasticTrainJob:
    """A training run that survives preemption and slice-shape changes.

    Lifecycle: WAITING → (try_start) → RUNNING → (preempt) → PREEMPTED →
    (try_start on possibly different geometry) → RUNNING → … → DONE.

    Preemption is cooperative and arrives over the session listener hooks:
    the slice's ``"preempt"`` `SliceEvent` reaches the `TrainSession`,
    which flips the trainer's stop flag (mid-quantum) or this job's
    handler (between quanta); either way the job checkpoints, frees its
    blocks during the notification, and re-enters the waiting pool."""

    def __init__(self, sc: Union[Supercomputer, MachineRegistry],
                 spec: TrainTenantSpec):
        # accept one machine or a fleet; placement ranks machines by
        # perf/$ — training is deadline-free, so it drains to the cheapest
        # silicon that fits (the batch-goes-to-old-pools story)
        if isinstance(sc, MachineRegistry):
            self.registry = sc
        else:
            self.registry = MachineRegistry([sc])
        self.sc = self.registry[0]
        self.spec = spec
        self.state = WAITING
        self.slice: Optional[Slice] = None
        self.session: Optional[TrainSession] = None
        self.steps_done = 0
        self.preemptions = 0
        self.resumes = 0                    # re-placements after preemption
        self.grows = 0                      # voluntary moves to more blocks
        self.shrinks = 0                    # cooperative partial shrinks
        self.geometry_history: List[Tuple[float, Optional[Tuple[int, int, int]]]] = []
        self.log: List[str] = []
        self._in_quantum = False
        self._ever_started = False
        # last virtual time this job observed (boundary/quantum stamps);
        # events that originate inside the fleet loop (a scale-up evicting
        # us mid-window) are stamped with it — accurate to one window
        self._now = 0.0

    def __repr__(self):
        dims = self.slice.dims if self.slice else None
        return (f"ElasticTrainJob({self.state}, step={self.steps_done}/"
                f"{self.spec.target_steps}, dims={dims})")

    # -- capacity ------------------------------------------------------------

    @property
    def blocks_held(self) -> int:
        """Blocks currently owned (0 while preempted/waiting/done)."""
        return len(self.slice.blocks) if self.slice is not None else 0

    def steps_in(self, window_s: float) -> int:
        """Real steps one window buys at the current geometry (virtual
        ideal-DP scaling: more blocks → more steps per virtual second)."""
        if self.blocks_held == 0:
            return 0
        return max(1, int(round(window_s * self.blocks_held
                                / self.spec.base_step_s)))

    # -- placement -----------------------------------------------------------

    def try_start(self, now: float = 0.0, *, _count_resume: bool = True
                  ) -> bool:
        """Place the job on the largest preferred geometry that fits.

        Builds a fresh `Trainer` on the new slice (the checkpoint under
        ``ckpt_dir`` restores the data cursor and state on first
        `run_quantum`).  Returns True when a slice was obtained."""
        if self.state not in (WAITING, PREEMPTED):
            return False
        self._now = max(self._now, now)
        sl = None
        for dims in self.spec.geometries:
            sl = self.registry.allocate(dims, objective=self.spec.objective,
                                        priority=self.spec.priority)
            if sl is not None:
                break
        if sl is None:
            return False
        self.slice = sl
        self.session = sl.train(self.spec.run, None,
                                ckpt_dir=self.spec.ckpt_dir,
                                ckpt_every=self.spec.ckpt_every)
        self.session.add_listener(self._on_session_event)
        if self._ever_started and _count_resume:
            self.resumes += 1
        self._ever_started = True
        self.state = RUNNING
        self.geometry_history.append((now, sl.dims))
        self.log.append(f"[t={now:8.3f}s] {self.spec.name} tenant on "
                        f"{sl.dims} ({sl._sc.name} blocks={sl.blocks}, "
                        f"step={self.steps_done})")
        return True

    def maybe_grow(self, now: float = 0.0) -> bool:
        """Move to a larger preferred geometry when idle blocks allow it.

        A squeezed job (resumed on 1 block mid-burst) would otherwise sit
        on its small slice while the trough frees the machine around it.
        Growing is a checkpoint + free + re-place on the bigger shape —
        the same elastic path as preemption, driven by opportunity instead
        of eviction.  Returns True when the job moved."""
        if self.state != RUNNING:
            return False
        self._now = max(self._now, now)
        here = self.slice._sc                  # machine holding the slice
        free_here = len(here.scheduler.free & here.scheduler.healthy)
        free_elsewhere = max(
            (len(m.scheduler.free & m.scheduler.healthy)
             for m in self.registry if m is not here), default=0)
        held = self.blocks_held
        target = None
        for dims in self.spec.geometries:
            need = _blocks_needed(dims)
            if need <= held:
                break                       # already at best fit
            # growing in place reuses the held blocks; moving to another
            # machine is a full re-place, so only its own free pool counts
            if need <= held + free_here or need <= free_elsewhere:
                target = dims
                break
        if target is None:
            return False
        self._release_slice(save=True)
        self.state = WAITING
        if self.try_start(now, _count_resume=False):
            self.grows += 1
            self.log.append(f"[t={now:8.3f}s] {self.spec.name} tenant grew "
                            f"to {self.slice.dims}")
            return True
        return False

    # -- preemption ----------------------------------------------------------

    def _on_session_event(self, _session, ev: SliceEvent) -> None:
        if ev.kind == "preempt" and not self._in_quantum:
            # between quanta: the trainer is not running, so checkpoint and
            # free right here, inside the requester's notification — by the
            # time `Supercomputer.request_preemption` returns, the blocks
            # are genuinely free
            self._vacate(save=True, reason=ev.detail)
        elif ev.kind == "shrink_request" and not self._in_quantum:
            # partial shrink: hand back blocks WITHOUT vacating — the job
            # checkpoints, re-carves its slice to a smaller preferred
            # geometry in place (during this notification, so the
            # requester's `request_shrink` sees the blocks freed), and
            # keeps training.  Mid-quantum requests are ignored; the
            # requester falls back to full preemption.
            self._shrink_to(ev.blocks_needed)
        elif ev.kind == "lost":
            # block failure with no spare: the slice died under us; the
            # last periodic/preemption checkpoint is the resume point
            self._drop_slice()
            self.state = PREEMPTED
            self.geometry_history.append((self._now, None))
            self.log.append(f"train tenant slice LOST ({ev.detail}); "
                            f"will resume from checkpoint")

    def _shrink_to(self, blocks_needed: int) -> int:
        """Cooperatively shrink onto a smaller preferred geometry, keeping
        the job RUNNING on the same slice.  Checkpoint → close the old
        session (its trainer is compiled for the old shape) → `Slice.shrink`
        in place → fresh session that resumes from the checkpoint on the
        next quantum.  The loss curve continues bitwise-identically: the
        checkpoint carries params + optimizer state + data cursor, and the
        global batch is geometry-independent.  Returns blocks freed."""
        if self.state != RUNNING or self.slice is None:
            return 0
        held = self.blocks_held
        target = shrink_target(self.spec.geometries, held, blocks_needed)
        if target is None:
            return 0                        # already at minimum geometry
        if self.session is not None and self.session.state is not None:
            self.session.trainer.save(self.session.state)
        sl = self.slice
        if self.session is not None:
            self.session.state = None       # freed now (see `_drop_slice`)
            self.session.close()
        self.session = None
        sl.shrink(target)
        self.session = sl.train(self.spec.run, None,
                                ckpt_dir=self.spec.ckpt_dir,
                                ckpt_every=self.spec.ckpt_every)
        self.session.add_listener(self._on_session_event)
        self.shrinks += 1
        freed = held - len(sl.blocks)
        self.geometry_history.append((self._now, sl.dims))
        self.log.append(f"[t={self._now:8.3f}s] {self.spec.name} tenant "
                        f"shrank {held}->{len(sl.blocks)} blocks "
                        f"({sl.dims}) at step {self.steps_done}, "
                        f"freed {freed}")
        return freed

    def _drop_slice(self) -> None:
        if self.session is not None:
            # the session is still on the stack of the event that evicts
            # us: drop its state now, so the device memory is free before
            # the requester's allocation returns
            self.session.state = None
            self.session.close()
        self.session = None
        self.slice = None

    def _release_slice(self, *, save: bool) -> None:
        """Checkpoint (optionally), detach the session, and free the slice
        — the one release path used by preemption, growth, and completion."""
        if save and self.session is not None \
                and self.session.state is not None:
            self.session.trainer.save(self.session.state)
        sl = self.slice
        self._drop_slice()
        if sl is not None and sl.status == "active":
            sl.free()

    def _vacate(self, *, save: bool, reason: str) -> None:
        self._release_slice(save=save)
        self.preemptions += 1
        self.state = PREEMPTED
        self.geometry_history.append((self._now, None))
        self.log.append(f"[t={self._now:8.3f}s] train tenant preempted at "
                        f"step {self.steps_done} ({reason})")

    # -- the quantum ---------------------------------------------------------

    def run_quantum(self, window_s: float, now: float = 0.0) -> int:
        """Train for one window's worth of virtual time (real steps).

        Honors a mid-quantum preemption request: the trainer checkpoints at
        the step boundary and this method frees the slice before returning.
        Returns the number of steps actually completed."""
        if self.state != RUNNING:
            return 0
        self._now = max(self._now, now)
        target = min(self.spec.target_steps,
                     self.steps_done + self.steps_in(window_s))
        self._in_quantum = True
        try:
            state = self.session.run(target, log_every=self.spec.log_every)
        finally:
            self._in_quantum = False
        gained = state.step - self.steps_done
        self.steps_done = state.step
        if self.session.preempted:
            # trainer already checkpointed inside the loop
            self._vacate(save=False, reason="mid-quantum preempt")
        elif self.steps_done >= self.spec.target_steps:
            self._release_slice(save=True)
            self.state = DONE
            self.geometry_history.append((now, None))
            self.log.append(f"[t={now:8.3f}s] train tenant DONE "
                            f"at step {self.steps_done}")
        return gained


@dataclasses.dataclass
class TenancyReport:
    """What one mixed-workload scenario did to both tenants."""
    arm: str                        # "elastic" | "static"
    windows: int
    window_s: float
    train_steps: int
    train_target: int
    train_frac: float               # steps completed / target (mean over jobs)
    train_preemptions: int
    train_resumes: int
    train_grows: int
    geometry_changes: int           # distinct geometries the job ran on
    geometry_history: List[Any]
    serve: Dict[str, Any]           # merged FleetReport.to_dict()
    deferred_scale_ups: int
    combined_score: float           # train_frac + serve slo_goodput
    log: List[str]
    train_shrinks: int = 0          # cooperative partial shrinks (all jobs)
    per_job: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("log")
        d["geometry_history"] = [[t, list(g) if g else None]
                                 for t, g in self.geometry_history]
        return d


class MixedTenancyDriver:
    """Co-schedule one serving fleet and one elastic training job on one
    `Supercomputer`, reallocating blocks between the tenants over time.

    Per window: (1) the fleet serves the window's arrivals (its autoscaler
    may scale up — with ``preempt_on_allocate`` that eviction reaches the
    training job synchronously), (2) if training is block-less and the
    fleet is not starved, resume it on the largest geometry that fits,
    (3) training runs one quantum of real steps.  Serve and train time
    overlap: they are independent slices of the modeled machine.

    Args:
      service: the serving tenant (its `FleetService` owns the traffic,
        routing, autoscaling, and failure handling).
      train_job: the training tenant.
      window_s: training-quantum window in virtual seconds (how often the
        training tenant catches up with fleet time and placement decisions
        are revisited).
      resume_training: re-place the training job when capacity frees (turn
        off for a static arm whose training never moves).
    """

    def __init__(self, service: "FleetService",
                 train_job: Union[ElasticTrainJob,
                                  Sequence[ElasticTrainJob]],
                 *, window_s: float = 0.5, resume_training: bool = True):
        self.service = service
        jobs = ([train_job] if isinstance(train_job, ElasticTrainJob)
                else list(train_job))
        assert jobs, "need at least one training job"
        self.train_jobs = jobs
        self.train_job = jobs[0]            # primary (legacy accessor)
        self.window_s = window_s
        self.resume_training = resume_training
        self._deferred_seen = 0

    def _boundary(self, t: float) -> None:
        """One co-scheduling decision + training quantum at virtual ``t``.
        With several trainers, placement runs in priority-tier order
        (highest first — the top tier grabs freed blocks before the rest),
        then every RUNNING job gets its quantum."""
        svc = self.service
        starved = (svc.deferred_scale_ups > self._deferred_seen
                   or len(svc.wait) > 0)
        self._deferred_seen = svc.deferred_scale_ups
        by_tier = sorted(self.train_jobs,
                         key=lambda j: -j.spec.priority)
        if self.resume_training and not starved:
            for job in by_tier:
                if job.state in (WAITING, PREEMPTED):
                    job.try_start(now=t)
                else:
                    job.maybe_grow(now=t)
        for job in by_tier:
            job.run_quantum(self.window_s, now=t)

    def run(self, trace: Sequence["FleetRequest"], *,
            fail_plan: Optional[Sequence[Tuple[float, Any]]] = None,
            repair_plan: Optional[Sequence[Tuple[float, Any]]] = None,
            extra_windows: int = 2, arm: str = "elastic") -> TenancyReport:
        """Drive one scenario to completion and report both tenants.

        The whole trace runs through ONE `FleetService.run` (true arrival /
        failure / repair timing, no artificial drain points); training
        quanta fire from the fleet loop's ``on_advance`` hook at every
        ``window_s`` boundary of virtual time.  After the fleet drains, the
        remaining boundaries up to the horizon (+``extra_windows``) run
        training alone — the trough where reclaimed blocks buy steps.
        """
        # key on time only: targets mix ints and strings, which plain tuple
        # sorting would try (and fail) to compare on time ties
        fail_plan = sorted(fail_plan or [], key=lambda f: f[0])
        repair_plan = sorted(repair_plan or [], key=lambda f: f[0])
        horizon = max(
            [r.t_arrival for r in trace]
            + [t for t, _ in fail_plan] + [t for t, _ in repair_plan]
            + [0.0])
        n_windows = int(math.ceil(horizon / self.window_s + 1e-9)) \
            + 1 + extra_windows
        end_t = n_windows * self.window_s
        svc = self.service
        self._deferred_seen = svc.deferred_scale_ups
        next_t = self.window_s

        def on_advance(now: float) -> None:
            nonlocal next_t
            while next_t <= min(now, end_t):
                self._boundary(next_t)
                next_t += self.window_s

        svc.run(trace, fail_plan=fail_plan, repair_plan=repair_plan,
                settle_s=self.window_s, on_advance=on_advance)
        while next_t <= end_t:
            # fleet is drained; let the autoscaler settle (frees finished
            # drains) and give training the leftover machine
            svc.run([], settle_s=self.window_s)
            self._boundary(next_t)
            next_t += self.window_s
        serve_report = svc.report_for(trace)
        jobs = self.train_jobs
        primary = self.train_job
        dims_seen = {g for _, g in primary.geometry_history if g is not None}
        fracs = [j.steps_done / max(1, j.spec.target_steps) for j in jobs]
        train_frac = sum(fracs) / len(fracs)
        combined = round(train_frac + serve_report.slo_goodput, 4)
        per_job = [{
            "name": j.spec.name,
            "priority": j.spec.priority,
            "state": j.state,
            "steps": j.steps_done,
            "target": j.spec.target_steps,
            "frac": round(f, 4),
            "preemptions": j.preemptions,
            "resumes": j.resumes,
            "grows": j.grows,
            "shrinks": j.shrinks,
            "geometry_history": [[t, list(g) if g else None]
                                 for t, g in j.geometry_history],
        } for j, f in zip(jobs, fracs)]
        return TenancyReport(
            arm=arm,
            windows=n_windows,
            window_s=self.window_s,
            train_steps=sum(j.steps_done for j in jobs),
            train_target=sum(j.spec.target_steps for j in jobs),
            train_frac=round(train_frac, 4),
            train_preemptions=sum(j.preemptions for j in jobs),
            train_resumes=sum(j.resumes for j in jobs),
            train_grows=sum(j.grows for j in jobs),
            geometry_changes=len(dims_seen),
            geometry_history=list(primary.geometry_history),
            serve=serve_report.to_dict(),
            deferred_scale_ups=svc.deferred_scale_ups,
            combined_score=combined,
            log=(list(svc.log)
                 + [ln for j in jobs for ln in j.log]),
            train_shrinks=sum(j.shrinks for j in jobs),
            per_job=per_job,
        )
