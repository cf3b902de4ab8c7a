"""Slice session handles — the user-facing half of `repro.cluster`.

A `Slice` is what `Supercomputer.allocate` hands out: one OCS-programmed
torus slice (paper §2.3/§2.5) carrying its `SliceTopology` plus everything a
workload needs — the device its compute runs on, a topology-bound
collective cost model, and session constructors:

  * ``slice.train(run, steps)``     — fault-tolerant training on the slice,
  * ``slice.serve(cfg, params)``    — a batched serving session,
  * ``slice.dryrun(profile)``       — analytic step-time on THIS geometry,
  * ``slice.autotopo(profile)``     — the §4 search over all geometries of
                                      this chip count,
  * ``slice.retwist(True)``         — §2.8 twist as OCS reprogramming.

Sessions stay registered with their slice; when the machine swaps a failed
block underneath the slice (§2.3) every active session receives the
`SliceEvent`, so callers observe reconfigurations without touching the
scheduler or the fabric.

Port of ``repro/cluster/slices.py``.  The machine model (blocks, OCS
circuits, spares, cost model) is the reference's, copied in
``repro_torch.core``; the compute of every slice runs on one device (the
card by default), where the reference builds a jax mesh: ``Slice.device``
takes ``Slice.mesh``'s place and `Slice.parallel_context` is ``LOCAL``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.autotopo import (Evaluation, ModelProfile,
                                       ParallelSpec, estimate_step_time,
                                       search)
from repro_torch.core.ocs import reconfig_time
from repro_torch.core.topology import SliceTopology, is_twistable
from repro_torch.parallel.context import LOCAL, ParallelContext
from repro_torch.serve.engine import ServeEngine, SliceSpec

if TYPE_CHECKING:                                     # pragma: no cover
    from repro_torch.cluster.supercomputer import Supercomputer


@dataclasses.dataclass(frozen=True)
class SliceEvent:
    """One thing that happened to a slice after allocation."""
    kind: str                   # "allocate" | "reconfigure" | "retwist" |
                                # "straggler" | "preempt" | "lost" | "free" |
                                # "shrink_request" | "shrink"
    detail: str
    circuits_moved: int = 0
    downtime_s: float = 0.0
    blocks_needed: int = 0      # "shrink_request" only: blocks asked back


class SliceError(RuntimeError):
    """Operation on a freed or lost slice."""


# ---------------------------------------------------------------------------
# Topology-bound cost model
# ---------------------------------------------------------------------------

class BoundCollectives:
    """`CollectiveCostModel` with the slice topology pre-bound, so callers
    ask ``slice.cost.all_reduce(bytes)`` without ever holding a topology."""

    def __init__(self, model, topo: SliceTopology):
        self._model = model
        self._topo = topo

    def all_reduce(self, bytes_per_chip: float,
                   dims_subset: Optional[Sequence[int]] = None) -> float:
        """Seconds for an all-reduce of ``bytes_per_chip`` on this slice
        (optionally over a subset of torus dimensions)."""
        return self._model.all_reduce(self._topo, bytes_per_chip, dims_subset)

    def all_gather(self, bytes_per_chip_out: float,
                   dims_subset: Optional[Sequence[int]] = None) -> float:
        """Seconds for an all-gather producing ``bytes_per_chip_out`` per
        chip (reduce-scatter is cost-symmetric: same estimate)."""
        return self._model.all_gather(self._topo, bytes_per_chip_out,
                                      dims_subset)

    reduce_scatter = all_gather

    def all_to_all(self, bytes_per_chip: float) -> float:
        """Seconds for an all-to-all of ``bytes_per_chip`` (twist-aware)."""
        return self._model.all_to_all(self._topo, bytes_per_chip)

    def p2p(self, bytes_: float, hops: int = 1) -> float:
        """Seconds for a point-to-point transfer over ``hops`` links."""
        return self._model.p2p(bytes_, hops)


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------

class SliceSession:
    """Base session: registered with its slice, receives machine events."""

    def __init__(self, slice_: "Slice"):
        self.slice = slice_
        self.interruptions: List[SliceEvent] = []
        self.lost = False
        self.closed = False
        self._listeners: List[Any] = []
        slice_._sessions.append(self)

    def add_listener(self, fn) -> None:
        """Register ``fn(session, event)`` to run on every machine event this
        session sees — how a fleet replica reacts to a slice reconfiguring or
        dying without polling ``interruptions``."""
        self._listeners.append(fn)

    def _on_event(self, ev: SliceEvent) -> None:
        self.interruptions.append(ev)
        if ev.kind in ("lost", "free"):
            self.lost = ev.kind == "lost"
            self.closed = True
        for fn in list(self._listeners):
            fn(self, ev)

    def _check_live(self) -> None:
        if self.lost:
            raise SliceError("slice lost; session is dead")
        if self.closed:
            raise SliceError("session closed (slice freed?)")

    @property
    def stall_s(self) -> float:
        """Accumulated reconfiguration downtime seen by this session."""
        return sum(e.downtime_s for e in self.interruptions
                   if np.isfinite(e.downtime_s))

    def close(self) -> None:
        """Detach from the slice (no further events; idempotent)."""
        self.closed = True
        if self in self.slice._sessions:
            self.slice._sessions.remove(self)


class TrainSession(SliceSession):
    """A `Trainer` bound to a slice: checkpoints, fail/restore, metrics.

    ``run`` wires the supercomputer's scheduler and this slice's job id into
    the trainer, so an injected block failure exercises the real OCS
    swap-spare path and the event lands back here.

    Preemption is cooperative and rides the listener hooks: a ``"preempt"``
    `SliceEvent` (from `Supercomputer.request_preemption` or
    `Slice.request_preempt`) flips the trainer's stop flag — at the next
    step boundary the trainer checkpoints and returns early, after which
    `preempted` is True and the owner is expected to `free` the slice and
    later resume from the checkpoint on whatever slice it gets next (the
    checkpoint format is slice-shape-elastic, see `repro.train.checkpoint`).
    """

    def __init__(self, slice_: "Slice", trainer):
        super().__init__(slice_)
        self.trainer = trainer
        self.state = None

    def _on_event(self, ev: SliceEvent) -> None:
        if ev.kind == "preempt":
            self.trainer.request_preempt()
        super()._on_event(ev)

    @property
    def metrics_log(self) -> List[Dict[str, float]]:
        """Per-step metric dicts logged by the trainer (loss, wall_s, …)."""
        return self.trainer.metrics_log

    @property
    def params(self):
        """Current model parameters, or None before the first `run`."""
        return None if self.state is None else self.state.params

    @property
    def preempted(self) -> bool:
        """True when the last `run` stopped early on a preemption request
        (state checkpointed when the trainer has a ``ckpt_dir`` — give it
        one for any preemptible run, or keep the returned state yourself;
        the owner should then free the slice)."""
        return self.trainer.preempted

    def run(self, num_steps: int, *, fail_at: Optional[int] = None,
            log_every: int = 10, state=None, straggler=None):
        """Train to ``num_steps`` (absolute), resuming from ``state``, the
        session's previous state, or the latest checkpoint.

        Args:
          num_steps: target step count (training resumes at the restored
            step, so fewer steps actually execute after a restore).
          fail_at: inject a block failure at this step (the §2.3 drill).
          log_every: metric logging period in steps.
          state: explicit `TrainerState` to continue from.
          straggler: optional `cluster.straggler.StragglerDetector` —
            fed this slice's modeled per-block step times after every step;
            when it confirms a slow block and the payback check clears
            (time recovered over the remaining steps beats the ACOS
            reconfiguration blackout), the session swaps the block via
            `Slice.swap_straggler` and keeps training.

        Returns the final `TrainerState` (early if preempted — check
        `preempted`)."""
        self._check_live()
        sc = self.slice._sc

        on_step = None
        if straggler is not None:
            def on_step(step: int, step_s: float) -> None:
                if self.lost or self.slice.status != "active":
                    return
                blk = straggler.observe(self.slice.block_times(step_s))
                if blk is None:
                    return
                if not straggler.worth_swapping(
                        blk, step_s, self.slice.swap_cost_s(blk),
                        remaining_steps=max(0, num_steps - step)):
                    return
                if self.slice.swap_straggler(blk) is not None:
                    straggler.fired(blk)

        self.state = self.trainer.train(
            num_steps, state=state or self.state, fail_at=fail_at,
            scheduler=sc.scheduler, job_id=self.slice.job_id,
            log_every=log_every, on_step=on_step)
        return self.state


class ServeSession(SliceSession):
    """A `ServeEngine` bound to a slice.

    The engine's request API passes through; `run` stats are annotated with
    the interruptions and stall time the underlying slice saw while the
    session was live (a reconfigure costs the MEMS switch time, §2.2)."""

    def __init__(self, slice_: "Slice", engine: ServeEngine):
        super().__init__(slice_)
        self.engine = engine
        self.draining = False

    @property
    def spec(self) -> SliceSpec:
        """The engine's serving envelope."""
        return self.engine.spec

    def submit(self, prompt, max_new_tokens: int = 32):
        """Enqueue a prompt on the underlying engine (refused while
        draining or after the slice died)."""
        self._check_live()
        if self.draining:
            raise SliceError("session is draining; not accepting requests")
        return self.engine.submit(prompt, max_new_tokens=max_new_tokens)

    def step(self) -> int:
        """Advance one admission+decode step; returns tokens decoded."""
        return 0 if self.closed else self.engine.step()

    # -- fleet surface: drain + queue introspection ---------------------------

    def drain(self) -> None:
        """Stop accepting new requests; in-flight work keeps decoding.  The
        fleet autoscaler drains a replica to completion before freeing its
        slice, so scale-down never kills live requests."""
        self.draining = True

    def undrain(self) -> None:
        """Resume accepting requests (a drain cancelled before the free —
        cheaper than provisioning a fresh slice when load returns)."""
        self.draining = False

    @property
    def is_drained(self) -> bool:
        """True once a draining session owes no further work."""
        return self.draining and self.engine.depth == 0

    @property
    def depth(self) -> int:
        """Requests the engine still owes work to."""
        return self.engine.depth

    def tokens_owed(self) -> int:
        """Decode tokens still owed across active + pending requests."""
        return self.engine.tokens_owed()

    def chunk_time_ema(self, default: float = 0.05) -> float:
        """Measured per-chunk latency EMA (``default`` before any chunk)."""
        return self.engine.chunk_time_ema(default)

    def prefix_lookup(self, prompt) -> int:
        """Prompt-prefix tokens this session's engine already holds in its
        shared KV pool (0 when the engine is not pooled, or after the slice
        died) — the router's prefix-affinity score."""
        if self.closed:
            return 0
        return self.engine.prefix_lookup(prompt)

    def expected_ttft_s(self, default_chunk_s: float = 0.05, *,
                        chunk_time_s=None) -> float:
        """Queue-aware TTFT estimate; ``chunk_time_s`` overrides the
        measured latency EMA when the caller accounts time itself (the
        fleet's deterministic virtual clock)."""
        return self.engine.expected_ttft_s(default_chunk_s,
                                           chunk_time_s=chunk_time_s)

    def step_chunk(self) -> int:
        """Advance one admission + decode chunk (the fleet pacing quantum)."""
        return 0 if self.closed else self.engine.step_chunk()

    def export_inflight(self):
        """Pull every unfinished request off this session's engine (used by
        the fleet after the slice is lost — bypasses the live-check since the
        whole point is evacuating a dead session)."""
        return self.engine.export_inflight()

    def run(self, max_steps: int = 1000) -> Dict[str, float]:
        """Serve until the queue drains (or ``max_steps``); returns the
        engine's stats dict annotated with this session's interruption
        count and reconfiguration stall time."""
        if self.lost:
            # same key set as a normal run, so failure-path callers can
            # read standard stats without special-casing
            return {"aborted": True, "requests_done": 0, "tokens": 0,
                    "wall_s": 0.0, "tokens_per_s": 0.0, "mean_ttft_s": 0.0,
                    "p50_ttft_s": 0.0, "p95_ttft_s": 0.0,
                    "decode_steps": 0, "chunk": self.engine.spec.chunk,
                    "p50_chunk_s": 0.0, "p95_chunk_s": 0.0,
                    "interruptions": len(self.interruptions),
                    "reconfig_stall_s": self.stall_s}
        self._check_live()
        stats = dict(self.engine.run(max_steps))
        stats["aborted"] = False
        stats["interruptions"] = len(self.interruptions)
        stats["reconfig_stall_s"] = self.stall_s
        return stats


# ---------------------------------------------------------------------------
# The slice handle
# ---------------------------------------------------------------------------

class Slice:
    """Session handle for one allocated torus slice.

    Constructed by `Supercomputer.allocate` — not directly."""

    def __init__(self, sc: "Supercomputer", job):
        self._sc = sc
        self._job = job
        self.device = sc.device             # where the slice's compute runs
        self._sessions: List[SliceSession] = []
        self.status = "active"              # "active" | "lost" | "freed"
        self._obs_span = None               # lifecycle span (tracing only)
        self.events: List[SliceEvent] = [SliceEvent(
            "allocate", f"{job.dims_chips} twisted={job.twisted} "
                        f"blocks={job.blocks}")]

    # -- identity / geometry --------------------------------------------------

    @property
    def job_id(self) -> int:
        """Scheduler job id backing this slice."""
        return self._job.job_id

    @property
    def dims(self) -> Tuple[int, int, int]:
        """Chip geometry (a, b, c) of the slice."""
        return self._job.dims_chips

    @property
    def twisted(self) -> bool:
        """Whether the slice is currently programmed as a twisted torus."""
        return self._job.twisted

    @property
    def blocks(self) -> List[int]:
        """Machine block ids the slice occupies (copy; spare-swaps mutate
        the underlying job)."""
        return list(self._job.blocks)

    @property
    def num_chips(self) -> int:
        """Total chips in the slice (product of `dims`)."""
        a, b, c = self.dims
        return a * b * c

    @property
    def priority(self) -> int:
        """Scheduling priority this slice was allocated at (higher wins)."""
        return self._job.priority

    @property
    def topology(self) -> SliceTopology:
        """Link-level `SliceTopology` for the current geometry/twist."""
        return self._job.topology

    @property
    def cost(self) -> BoundCollectives:
        """Collective cost model bound to the current topology."""
        return BoundCollectives(self._sc.costs, self.topology)

    def describe(self) -> str:
        """Human-readable geometry string (e.g. "8x8x8", "4x4x16_T")."""
        return self.topology.describe()

    def __repr__(self):
        return (f"Slice(job{self.job_id}, {self.describe()}, "
                f"{self.status}, blocks={self.blocks})")

    # -- parallel context -----------------------------------------------------

    def parallel_context(self) -> ParallelContext:
        """The `ParallelContext` of compute on this slice: ``LOCAL`` (one
        device, no mesh)."""
        return LOCAL

    # -- guards ---------------------------------------------------------------

    def _check_active(self) -> None:
        if self.status != "active":
            raise SliceError(f"slice job{self.job_id} is {self.status}")

    # -- workloads ------------------------------------------------------------

    def train(self, run: RunConfig, num_steps: Optional[int] = None, *,
              ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
              fail_at: Optional[int] = None, log_every: int = 10,
              accum_steps: Optional[int] = None) -> TrainSession:
        """Train `run` on this slice.  With ``num_steps`` the session runs to
        completion before returning; without, call ``session.run`` yourself."""
        self._check_active()
        from repro_torch.train.trainer import Trainer
        trainer = Trainer(run, device=self.device, ckpt_dir=ckpt_dir,
                          ckpt_every=ckpt_every, accum_steps=accum_steps,
                          slice_dims=self.dims, obs=self._sc.obs,
                          obs_labels={"job": self.job_id})
        session = TrainSession(self, trainer)
        if num_steps is not None:
            session.run(num_steps, fail_at=fail_at, log_every=log_every)
        return session

    def serve(self, model_cfg: ModelConfig, params,
              spec: Optional[SliceSpec] = None) -> ServeSession:
        """Open a serving session on this slice's device."""
        self._check_active()
        engine = ServeEngine(model_cfg, params, spec or SliceSpec(),
                             device=self.device, obs=self._sc.obs,
                             obs_labels={"job": self.job_id})
        return ServeSession(self, engine)

    def dryrun(self, profile: ModelProfile,
               spec: Optional[ParallelSpec] = None, *,
               mfu: float = 0.55) -> Evaluation:
        """Analytic step time for `profile` on THIS slice's geometry.

        With ``spec`` the given partitioning is evaluated; without, the best
        partitioning for this geometry is searched (§4 restricted to the
        slice in hand)."""
        self._check_active()
        if spec is not None:
            ev = estimate_step_time(profile, self.dims, spec,
                                    hw=self._sc.hw, twisted=self.twisted,
                                    mfu=mfu)
            if ev is None:
                raise ValueError(
                    f"{spec.label()} does not map onto {self.dims}")
            return ev
        evs = search(profile, self.num_chips, hw=self._sc.hw,
                     geometries=[self.dims], twisted=self.twisted, top_k=1)
        if not evs:
            raise ValueError(f"no partitioning of {profile.name} maps onto "
                             f"{self.dims}")
        return evs[0]

    def autotopo(self, profile: ModelProfile, *, top_k: int = 5,
                 allow_twist: bool = True) -> List[Evaluation]:
        """Full §4 search over every geometry of this slice's chip count —
        'should I have asked for a different shape?'"""
        self._check_active()
        return search(profile, self.num_chips, hw=self._sc.hw,
                      top_k=top_k, allow_twist=allow_twist)

    # -- reconfiguration ------------------------------------------------------

    def retwist(self, twisted: bool) -> int:
        """(Un)twist in place — pure OCS reprogramming, §2.8.  Returns the
        number of circuits that moved."""
        self._check_active()
        if twisted and not is_twistable(self.dims):
            raise ValueError(f"{self.dims} is not twistable")
        if twisted == self.twisted:
            return 0
        new_cfg, changed = self._sc.fabric.retwist(self._job.config, twisted)
        self._job.config = new_cfg
        self._job.twisted = twisted
        self._notify(SliceEvent(
            "retwist", f"twisted={twisted}", circuits_moved=changed,
            downtime_s=reconfig_time(changed)))
        return changed

    def request_preempt(self, detail: str = "preemption requested") -> bool:
        """Ask this slice's tenant to vacate (cooperative preemption).

        Emits a ``"preempt"`` `SliceEvent` to every session, listener, and
        machine-level subscriber.  A cooperative tenant (e.g. an elastic
        training job) checkpoints and calls `free` from its handler — in
        that case this returns True.  Tenants that ignore the request keep
        running; nothing is killed."""
        if self.status != "active":
            return True                     # already gone: nothing to evict
        ev = SliceEvent("preempt", detail)
        self._notify(ev)
        self._sc._publish(self, ev)
        return self.status != "active"

    def shrink(self, new_dims: Tuple[int, int, int]) -> SliceEvent:
        """Hand blocks back WITHOUT vacating: re-carve this slice in place
        to the strictly-smaller ``new_dims`` (§2.5 partial shrink).  The
        scheduler keeps the fastest owned blocks, reprograms the OCS
        circuits to the smaller torus, and the surplus returns to the free
        pool — one reconfiguration blackout instead of a full
        preempt→checkpoint→resume cycle.  Sessions opened before the shrink
        see the ``"shrink"`` event but keep their (now stale) geometry;
        tenants that care (the elastic trainer) close and reopen their
        session on the new shape."""
        self._check_active()
        dims = tuple(new_dims)
        released, moved, secs = self._sc.scheduler.shrink(self.job_id, dims)
        ev = SliceEvent("shrink",
                        f"-> {dims}, released blocks {released}",
                        circuits_moved=moved, downtime_s=secs)
        self._notify(ev)
        self._sc._publish(self, ev)
        return ev

    def request_shrink(self, blocks_needed: int,
                       detail: str = "capacity requested") -> int:
        """Ask this slice's tenant to hand back ``blocks_needed`` blocks
        (cooperative, like `request_preempt` — but partial).  A shrink-aware
        tenant reacts to the ``"shrink_request"`` `SliceEvent` by
        checkpointing and calling `shrink` to a smaller geometry *during
        the notification*; a tenant may instead vacate entirely, or ignore
        the request.  Returns the number of blocks actually freed."""
        if self.status != "active":
            return 0
        before = len(self._job.blocks)
        ev = SliceEvent("shrink_request", detail,
                        blocks_needed=blocks_needed)
        self._notify(ev)
        self._sc._publish(self, ev)
        if self.status != "active":
            return before                   # tenant vacated entirely
        return before - len(self._job.blocks)

    def swap_straggler(self, slow_block: int) -> Optional[SliceEvent]:
        """Replace a slow-but-healthy block with the fastest spare (§2.3).
        Returns the emitted event, or None when the scheduler refused (no
        spare, or no spare faster than the block)."""
        self._check_active()
        res = self._sc.scheduler.swap_straggler(self.job_id, slow_block)
        if res is None:
            return None
        moved, secs = res
        ev = SliceEvent("straggler", f"block{slow_block} swapped out",
                        circuits_moved=moved, downtime_s=secs)
        self._notify(ev)
        return ev

    # -- straggler telemetry ---------------------------------------------------

    def slowdown_factor(self) -> float:
        """Step-time multiplier of the slice's SLOWEST block: a synchronous
        (data-parallel) step finishes when the last block does, so one
        straggler drags the whole slice to its pace."""
        sched = self._sc.scheduler
        return max((sched.slowdown_of(b) for b in self._job.blocks),
                   default=1.0)

    def block_times(self, base_s: float) -> Dict[int, float]:
        """Per-block step time under a nominal per-block cost of
        ``base_s``: what a per-block step timer would report this step —
        the straggler detector's input signal."""
        sched = self._sc.scheduler
        return {b: base_s * sched.slowdown_of(b) for b in self._job.blocks}

    def swap_cost_s(self, block: Optional[int] = None) -> float:
        """Predicted blackout of swapping ``block`` (any owned block by
        default — circuit counts are uniform) for a spare, through the
        ACOS-style `CollectiveCostModel.reconfig_time`.  The payback side
        of the repair decision: swap only if the steady-state gain
        amortizes this."""
        if block is None:
            block = self._job.blocks[0]
        moved = sum(1 for c in self._job.config.circuits
                    if block in (c.block_plus, c.block_minus))
        return self._sc.costs.reconfig_time(moved)

    # -- lifecycle ------------------------------------------------------------

    def _notify(self, ev: SliceEvent) -> None:
        self.events.append(ev)
        self._sc._obs_slice_event(self, ev)
        for s in list(self._sessions):
            s._on_event(ev)

    def free(self) -> None:
        """Release blocks and OCS ports back to the machine."""
        if self.status == "active":
            self._sc._release(self)

    def __enter__(self) -> "Slice":
        return self

    def __exit__(self, *exc) -> None:
        self.free()
