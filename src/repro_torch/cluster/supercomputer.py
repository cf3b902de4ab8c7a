"""`Supercomputer` — the machine-level facade of `repro.cluster`.

One object owns the whole paper-§2 stack: the `OCSFabric` (port accounting +
circuit programming), the `SliceScheduler` (any-blocks-anywhere allocation,
spare swapping), the `CollectiveCostModel`, and the Figure-4 goodput
arithmetic.  Users ask it for `Slice` handles and never touch the plumbing:

    sc = Supercomputer()                      # 64 blocks = 4096 chips
    sl = sc.allocate((8, 8, 8))               # or sc.allocate(512)
    sess = sl.train(run_cfg, steps)           # / sl.serve(cfg, params)
    sl.free()

`submit` + `run_pending` form a minimal job queue so train/serve jobs beyond
current capacity wait their turn, and `fail_block` propagates the §2.3
swap-a-spare reconfiguration into whatever slice (and live sessions) owned
the failed block.

Port of ``repro/cluster/supercomputer.py``: the same machine model over
the copied ``repro_torch.core``, its telemetry in the port's
``obs.Telemetry``.  The compute of every slice runs on ``device`` (the card
by default; without one it raises unless given ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.cluster.slices import Slice, SliceEvent
from repro_torch.core.costmodel import (GENERATIONS, CollectiveCostModel,
                                        Generation, HardwareParams, TPU_V4)
from repro_torch.core.goodput import goodput_ocs, goodput_static
from repro_torch.core.scheduler import SliceScheduler
from repro_torch.core.topology import geometries_for, is_twistable
from repro_torch.models.api import resolve_device
from repro_torch.obs import Telemetry

Geometry = Union[int, Tuple[int, int, int]]


class CapacityError(RuntimeError):
    """Not enough healthy free blocks for the requested slice."""


class _NotifyingScheduler(SliceScheduler):
    """SliceScheduler that reports failure handling back to the facade, so
    events reach `Slice` handles even when a component (e.g. the trainer's
    fault hook) drives the scheduler directly."""

    def __init__(self, *args, on_failure=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._on_failure = on_failure

    def fail_block(self, block: int):
        res = super().fail_block(block)
        if self._on_failure is not None:
            self._on_failure(block, res)
        return res


@dataclasses.dataclass
class JobTicket:
    """One queued unit of work: a geometry request plus a function that gets
    the allocated `Slice` and returns the job's result.  ``priority`` orders
    the queue (higher first; FIFO within a priority)."""
    ticket_id: int
    dims: Tuple[int, int, int]
    twisted: bool
    fn: Callable[[Slice], Any]
    tag: str = ""
    priority: int = 0
    status: str = "queued"          # "queued" | "running" | "done" | "failed"
    result: Any = None
    error: Optional[str] = None


class Supercomputer:
    """Facade over one OCS-reconfigurable machine (default: 4096 chips)
    whose slices compute on ``device`` (default: the card)."""

    def __init__(self, num_blocks: int = 64, *,
                 hw: Optional[HardwareParams] = None,
                 generation: Optional[Generation] = None,
                 name: Optional[str] = None,
                 contiguous: bool = False,
                 obs: Optional[Telemetry] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if hw is None:
            hw = generation.hw if generation is not None else TPU_V4
        self.scheduler = _NotifyingScheduler(
            num_blocks, contiguous=contiguous, on_failure=self._on_failure)
        self.hw = hw
        # generation economics (perf factor, Watts, $/chip-hour) for the
        # multi-machine fleet placer; resolved from the hardware preset when
        # not given, None for hardware outside the registry
        self.generation = (generation if generation is not None
                           else GENERATIONS.get(hw.name))
        self.name = name if name is not None else hw.name
        self.costs = CollectiveCostModel(hw)
        self.slices: Dict[int, Slice] = {}      # job_id -> live Slice
        self.queue: List[JobTicket] = []
        self._next_ticket = 0
        self._subscribers: List[Callable[[Slice, SliceEvent], None]] = []
        # machine telemetry: a private wall-clock Telemetry unless the
        # caller shares one (the fleet layer injects a virtual-clock handle
        # so machine and fleet events land on one timeline)
        self.obs = obs if obs is not None else Telemetry()

    @property
    def fabric(self):
        """The machine's `OCSFabric` (port accounting, circuit state)."""
        return self.scheduler.fabric

    @property
    def num_blocks(self) -> int:
        """Total 4^3 blocks in the machine (64 = 4096 chips by default)."""
        return self.scheduler.num_blocks

    @property
    def events(self) -> List[str]:
        """Machine-level event log (allocations, failures, re-routes)."""
        return self.scheduler.events

    # -- geometry helpers ------------------------------------------------------

    @staticmethod
    def geometries(num_chips: int) -> List[Tuple[int, int, int]]:
        """All 4i×4j×4k slice shapes with this chip count (§2.5)."""
        return geometries_for(num_chips)

    def _resolve_geometry(self, geometry: Geometry,
                          twisted: bool) -> Tuple[int, int, int]:
        if isinstance(geometry, int):
            cands = geometries_for(geometry)
            if twisted:
                cands = [g for g in cands if is_twistable(g)]
            if not cands:
                raise ValueError(f"no 4i*4j*4k geometry for {geometry} chips"
                                 + (" (twisted)" if twisted else ""))
            # most cube-like shape: best bisection per §2.8's default choice
            return min(cands, key=lambda g: (max(g) / min(g), sum(g)))
        dims = tuple(geometry)
        assert len(dims) == 3, dims
        return dims

    # -- allocation ------------------------------------------------------------

    def allocate(self, geometry: Geometry, *, twisted: bool = False,
                 required: bool = True, priority: int = 0,
                 preempt: Union[bool, str] = False) -> Optional[Slice]:
        """Allocate a slice.

        Args:
          geometry: a ``(a, b, c)`` chip shape or a chip count (the most
            cube-like legal shape is picked).
          twisted: program the slice as a twisted torus (§2.8).
          required: raise `CapacityError` instead of returning None when the
            machine cannot place the slice.
          priority: scheduling priority recorded on the job (higher wins).
          preempt: when capacity is short, cooperatively evict strictly
            lower-priority slices (see `request_preemption`) and retry
            once.  The string ``"shrink"`` asks shrink-capable tenants to
            hand back blocks FIRST (`request_capacity`), falling back to
            full preemption only when partial shrink cannot free enough.

        Returns:
          A live `Slice` handle, or None (``required=False`` only).
        """
        dims = self._resolve_geometry(geometry, twisted)
        job = self.scheduler.allocate(dims, twisted=twisted,
                                      priority=priority)
        if job is None and preempt:
            ok = (self.request_capacity(dims, priority)
                  if preempt == "shrink"
                  else self.request_preemption(dims, priority))
            if ok:
                job = self.scheduler.allocate(dims, twisted=twisted,
                                              priority=priority)
        if job is None:
            if required:
                raise CapacityError(
                    f"cannot place {dims} slice: "
                    f"{len(self.scheduler.free & self.scheduler.healthy)} "
                    f"healthy free blocks")
            return None
        sl = Slice(self, job)
        self.slices[job.job_id] = sl
        obs = self.obs
        obs.metrics.counter("machine.allocations").inc()
        obs.event("slice.allocate", cat="slice",
                  track=f"slice:job{job.job_id}",
                  dims=dims, blocks=list(job.blocks))
        if obs.tracer.enabled:
            # slice lifecycle span: allocate -> free/lost (ended by
            # _obs_slice_event); long-lived, so begin/end not a `with`
            sl._obs_span = obs.tracer.begin(
                "slice.lifetime", cat="slice",
                track=f"slice:job{job.job_id}", dims=str(dims))
        return sl

    def request_preemption(self, geometry: Geometry, priority: int, *,
                           twisted: bool = False) -> bool:
        """Cooperatively evict lower-priority slices until a ``geometry``
        request at ``priority`` could be placed.

        Victim slices receive a ``"preempt"`` `SliceEvent` (delivered to
        their sessions, listeners, and machine subscribers).  A well-behaved
        tenant — e.g. an elastic training job — reacts by checkpointing and
        freeing the slice *during the notification*; slices whose owners do
        not free are left running (preemption here is a request, never a
        kill).  Returns True if enough blocks were actually freed."""
        dims = self._resolve_geometry(geometry, twisted)
        victims = self.scheduler.preemption_victims(dims, priority)
        if victims is None:
            return False
        need = self.scheduler.blocks_needed(dims)
        for job in victims:
            sl = self.slices.get(job.job_id)
            if sl is None:
                continue
            self.scheduler.events.append(
                f"preempt job{job.job_id} (prio {job.priority} < {priority})")
            sl.request_preempt(
                f"evicted for a priority-{priority} {dims} request")
            if len(self.scheduler.free & self.scheduler.healthy) >= need:
                break
        return len(self.scheduler.free & self.scheduler.healthy) >= need

    def request_capacity(self, geometry: Geometry, priority: int, *,
                         twisted: bool = False) -> bool:
        """Free enough healthy blocks for a ``geometry`` request at
        ``priority``, preferring PARTIAL SHRINK over full preemption.

        Pass 1 walks strictly-lower-priority slices in the same
        cheapest-first victim order as `preemption_victims` and asks each to
        `Slice.request_shrink` the remaining deficit — a shrink-aware tenant
        (the elastic trainer) re-checkpoints onto a smaller geometry and
        keeps running, handing back only what the request needs.  Only if
        shrink leaves a deficit does pass 2 fall back to
        `request_preemption` (full cooperative eviction).  Returns True if
        enough blocks are free on exit."""
        dims = self._resolve_geometry(geometry, twisted)
        need = self.scheduler.blocks_needed(dims)

        def have() -> int:
            return len(self.scheduler.free & self.scheduler.healthy)

        if have() >= need:
            return True
        cands = sorted((j for j in self.scheduler.jobs.values()
                        if j.priority < priority),
                       key=lambda j: (j.priority, len(j.blocks), -j.job_id))
        for job in cands:
            if have() >= need:
                break
            sl = self.slices.get(job.job_id)
            if sl is None:
                continue
            freed = sl.request_shrink(
                need - have(),
                f"priority-{priority} {dims} request needs blocks")
            if freed:
                self.scheduler.events.append(
                    f"shrink job{job.job_id} freed {freed} blocks for a "
                    f"priority-{priority} {dims} request")
        if have() >= need:
            return True
        return self.request_preemption(dims, priority, twisted=twisted)

    def subscribe(self, fn: Callable[[Slice, SliceEvent], None]):
        """Register a machine-level observer: ``fn(slice, event)`` fires for
        every slice lifecycle event (reconfigure/lost/free) regardless of who
        owns the slice.  This is how the fleet layer learns that `fail_block`
        hit one of its serving replicas and re-routes the in-flight requests
        instead of erroring the whole service.  Returns ``fn`` so it can be
        used as a decorator."""
        self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[Slice, SliceEvent], None]) -> None:
        """Detach a `subscribe`d observer (no-op if already detached) —
        long-lived machines hosting successive services must not keep dead
        observers reachable."""
        if fn in self._subscribers:
            self._subscribers.remove(fn)

    def _publish(self, sl: Slice, ev: SliceEvent) -> None:
        for fn in list(self._subscribers):
            fn(sl, ev)

    def _obs_slice_event(self, sl: Slice, ev: SliceEvent) -> None:
        """Telemetry for every post-allocation `SliceEvent` (called from
        `Slice._notify`): one instant event on the slice's lane, labeled
        counters, downtime histograms, the lifecycle span end on
        free/lost, and a flight-recorder postmortem on lost/preempt."""
        obs = self.obs
        track = f"slice:job{sl.job_id}"
        obs.metrics.counter("machine.slice_events", kind=ev.kind).inc()
        if ev.downtime_s > 0 and np.isfinite(ev.downtime_s):
            obs.metrics.histogram("machine.reconfig_downtime_s").observe(
                ev.downtime_s)
        obs.event(f"slice.{ev.kind}", cat="slice", track=track,
                  detail=ev.detail, circuits_moved=ev.circuits_moved,
                  downtime_s=ev.downtime_s)
        if ev.kind in ("lost", "free") and sl._obs_span is not None:
            obs.tracer.end(sl._obs_span)
            sl._obs_span = None
        if ev.kind in ("lost", "preempt"):
            obs.postmortem(f"slice_{ev.kind}", job_id=sl.job_id,
                           detail=ev.detail)

    def _release(self, sl: Slice) -> None:
        self.scheduler.release(sl.job_id)
        self.slices.pop(sl.job_id, None)
        sl.status = "freed"
        ev = SliceEvent("free", f"released blocks {sl.blocks}")
        sl._notify(ev)
        self._publish(sl, ev)

    def utilization(self) -> float:
        """Fraction of blocks currently owned by live slices."""
        return self.scheduler.utilization()

    # -- failures --------------------------------------------------------------

    def fail_block(self, block: int):
        """Fail a block machine-wide; the owning slice (if any) is re-routed
        onto a spare or, with no spares, marked lost — and every live session
        on it is notified.  Returns the scheduler's (job_id, moved, secs)."""
        self.obs.metrics.counter("machine.block_failures").inc()
        self.obs.event("machine.fail_block", cat="failure", block=block)
        return self.scheduler.fail_block(block)

    def repair_block(self, block: int) -> None:
        """Return a failed block to the healthy pool (it rejoins the free
        set unless a slice still maps it)."""
        self.obs.metrics.counter("machine.block_repairs").inc()
        self.obs.event("machine.repair_block", cat="failure", block=block)
        self.scheduler.repair_block(block)

    def set_block_slowdown(self, block: int, factor: float) -> None:
        """Mark a block as a straggler: healthy but ``factor``x slower per
        synchronous step (1.0 clears it).  Sessions on slices owning the
        block model their step time off it; the straggler detector is what
        should notice and `Slice.swap_straggler` it away."""
        self.obs.metrics.gauge("machine.block_slowdown",
                               block=block).set(factor)
        self.obs.event("machine.set_slowdown", cat="straggler",
                       block=block, factor=factor)
        self.scheduler.set_slowdown(block, factor)

    def _on_failure(self, block: int, result) -> None:
        if result is None:
            return                          # idle block, nobody to notify
        job_id, moved, secs = result
        sl = self.slices.get(job_id)
        if sl is None:
            return
        if secs == float("inf"):
            # no spare (or static cabling): the scheduler already killed the
            # job; the slice and its sessions are lost until repair.
            sl.status = "lost"
            self.slices.pop(job_id, None)
            ev = SliceEvent(
                "lost", f"block{block} failed, no spare", downtime_s=secs)
        else:
            ev = SliceEvent(
                "reconfigure", f"block{block} -> spare",
                circuits_moved=moved, downtime_s=secs)
        sl._notify(ev)
        self._publish(sl, ev)

    # -- job queue -------------------------------------------------------------

    def submit(self, geometry: Geometry, fn: Callable[[Slice], Any], *,
               twisted: bool = False, tag: str = "",
               priority: int = 0) -> JobTicket:
        """Queue `fn` to run on a slice of `geometry` once one can be placed.
        Tickets run in `run_pending` (priority order, FIFO within a
        priority, with backfill)."""
        dims = self._resolve_geometry(geometry, twisted)
        if twisted and not is_twistable(dims):
            raise ValueError(f"{dims} is not twistable")
        need = self.scheduler.blocks_needed(dims)
        if need > self.num_blocks:
            raise ValueError(f"{dims} needs {need} blocks; machine has "
                             f"{self.num_blocks}")
        t = JobTicket(self._next_ticket, dims, twisted, fn, tag=tag,
                      priority=priority)
        self._next_ticket += 1
        self.queue.append(t)
        return t

    def run_pending(self) -> List[JobTicket]:
        """Drain the queue: allocate, run, free — repeating until no queued
        ticket can be placed.  Higher-priority tickets go first; smaller
        lower-priority jobs backfill around a blocked head-of-line job (the
        §2.5 scheduling benefit)."""
        finished: List[JobTicket] = []
        progress = True
        while progress:
            progress = False
            ordered = sorted(self.queue,
                             key=lambda t: (-t.priority, t.ticket_id))
            for t in ordered:
                if t not in self.queue:
                    continue
                try:
                    sl = self.allocate(t.dims, twisted=t.twisted,
                                       required=False, priority=t.priority)
                except ValueError as e:     # bad geometry: fail the ticket,
                    self.queue.remove(t)    # keep the rest draining
                    t.status, t.error = "failed", f"{type(e).__name__}: {e}"
                    finished.append(t)
                    progress = True
                    continue
                if sl is None:
                    continue
                self.queue.remove(t)
                t.status = "running"
                try:
                    t.result = t.fn(sl)
                    t.status = "done"
                except Exception as e:      # keep the queue draining
                    t.error = f"{type(e).__name__}: {e}"
                    t.status = "failed"
                finally:
                    sl.free()
                finished.append(t)
                progress = True
        return finished

    # -- fleet arithmetic ------------------------------------------------------

    def expected_goodput(self, slice_chips: int, host_availability: float, *,
                         mode: Optional[str] = None, trials: int = 2000,
                         seed: int = 0) -> float:
        """Figure-4 goodput: expected machine fraction doing useful work at
        the given CPU-host availability.  ``mode`` defaults to this machine's
        wiring ("ocs", or "static" when built with contiguous=True)."""
        mode = mode or ("static" if self.scheduler.contiguous else "ocs")
        fn = {"ocs": goodput_ocs, "static": goodput_static}[mode]
        return fn(slice_chips, host_availability, trials=trials, seed=seed)

    def overview(self) -> Dict[str, Any]:
        """Machine snapshot: block counts, utilization, live slices, queue
        depth — the one-call observability surface."""
        free = len(self.scheduler.free & self.scheduler.healthy)
        return {
            "num_blocks": self.num_blocks,
            "healthy_blocks": len(self.scheduler.healthy),
            "free_blocks": free,
            "utilization": self.utilization(),
            "live_slices": {jid: sl.describe()
                            for jid, sl in self.slices.items()},
            "queued_tickets": len(self.queue),
        }
