"""One serve replica: a `Slice` + `ServeSession` + virtual-time accounting.

The fleet models one 4096-chip machine carved into many serving slices.
Each replica's compute is REAL (`ServeEngine.step_chunk` runs the engine's
fast path on the machine's device and decodes actual tokens); its *time* is
virtual: a chunk costs its measured wall latency (or a fixed ``chunk_s`` in
deterministic mode), and replicas overlap on the fleet clock because they
are independent slices of the machine — one device merely serializes what
the hardware would run in parallel.  Reconfiguration downtime
(`SliceEvent.downtime_s` from a spare-swap) is charged to the replica's
clock the next time it steps.

Lifecycle::

    provisioning --ready_at--> active --drain--> draining --empty--> freed
                                  \\--fail_block, no spare--> dead

A dead replica's unfinished requests are evacuated (`evacuate`) and
re-routed by the service; a draining replica keeps decoding but accepts no
new work, and is only freed once it owes nothing — `free` enforces that
invariant with a hard error rather than trusting the caller.

Port of ``repro/fleet/replica.py`` over the port's `ServeSession`.  A
measured chunk (``chunk_s=None``) is timed with ``time.perf_counter``
around ``session.step_chunk()``, which ends with the host copy of the
chunk's tokens: the time is the card's plus the host's.  A retired
replica also closes its session, which takes it out of its slice's list:
the slice and the session refer to each other, and that cycle would keep
a retired engine's KV cache on the device until a garbage collection.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cluster.slices import ServeSession, Slice, SliceEvent
from repro_torch.cluster.straggler import StragglerDetector
from repro_torch.fleet.traffic import FleetRequest
from repro_torch.obs import NOOP_TRACER

PROVISIONING = "provisioning"
ACTIVE = "active"
DRAINING = "draining"
DEAD = "dead"
FREED = "freed"


class ReplicaError(RuntimeError):
    """Illegal replica lifecycle operation (e.g. freeing with work owed)."""


class ServeReplica:
    def __init__(self, rep_id: int, slice_: Slice, session: ServeSession, *,
                 now: float, provision_s: float = 0.0,
                 chunk_s: Optional[float] = None,
                 straggler: Optional[StragglerDetector] = None,
                 tracer=NOOP_TRACER,
                 speed: float = 1.0, watts: float = 0.0,
                 dollars_per_h: float = 0.0, gen: str = "",
                 drain_rank: float = 0.0):
        self.rep_id = rep_id
        self.slice = slice_
        self.session = session
        self.tracer = tracer                # fleet tracer (virtual time)
        self.track = f"replica:{rep_id}"
        self.state = PROVISIONING if provision_s > 0 else ACTIVE
        self.ready_at = now + provision_s
        self.busy_until = self.ready_at
        self.chunk_s = chunk_s              # None = measure real wall time
        self.straggler = straggler          # per-replica detector (optional)
        self.straggler_swaps = 0
        # generation economics (heterogeneous fleet): chunk latency divides
        # by ``speed`` (fig12 perf factor relative to the service's
        # reference machine; 1.0 = homogeneous fleet, bitwise-unchanged),
        # ``watts``/``dollars_per_h`` price the slice's allocated lifetime,
        # and ``drain_rank`` orders scale-down victims (worst perf/Watt
        # drains first; 0.0 everywhere preserves the legacy ordering)
        self.speed = speed
        self.watts = watts
        self.dollars_per_h = dollars_per_h
        self.gen = gen
        self.drain_rank = drain_rank
        self.t_alloc = now
        self.t_end: Optional[float] = None  # stamped at free/death
        # engine rid -> (fleet request, out_tokens length at dispatch,
        #               engine request)
        self._assigned: Dict[int, Tuple[FleetRequest, int, object]] = {}
        self._stall_seen = 0.0
        self.tokens_served = 0
        self.chunks_run = 0
        self.busy_s = 0.0
        self.truncated_migrations = 0
        self._final_stats: Optional[Dict[str, object]] = None
        session.add_listener(self._on_event)

    def __repr__(self):
        return (f"ServeReplica({self.rep_id}, {self.state}, "
                f"depth={self.depth}, job{self.slice.job_id})")

    # -- event propagation (the SliceEvent path from `fail_block`) ------------

    def _on_event(self, _session, ev: SliceEvent) -> None:
        if ev.kind == "lost":
            self.state = DEAD
        # "reconfigure" downtime lands via the session's stall_s accumulator,
        # charged to the virtual clock on the next step.

    # -- routing surface ------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self.state in (PROVISIONING, ACTIVE, DRAINING)

    @property
    def accepting(self) -> bool:
        """Can the router send new work here?  Provisioning replicas accept
        (requests queue while the slice warms); draining/dead ones do not."""
        return self.state in (PROVISIONING, ACTIVE)

    @property
    def depth(self) -> int:
        """Requests this replica still owes tokens to."""
        return self.session.depth if self.alive else len(self._assigned)

    @property
    def inflight(self) -> int:
        return sum(1 for fr, _, _ in self._assigned.values()
                   if fr.status == "queued")

    def tokens_owed(self) -> int:
        return self.session.tokens_owed()

    def eta_s(self, now: float, default_chunk_s: float = 0.05) -> float:
        """Expected TTFT for the next request routed here: the engine's
        queue-aware estimate, plus any remaining provisioning delay and the
        tail of the chunk currently in flight.  In deterministic mode the
        fixed virtual chunk cost prices the estimate — the engine's real
        (wall-clock) latencies would be inconsistent with the fleet clock."""
        start_delay = max(0.0, self.ready_at - now, self.busy_until - now)
        return start_delay + self.session.expected_ttft_s(
            default_chunk_s / self.speed, chunk_time_s=self.virtual_chunk_s)

    @property
    def virtual_chunk_s(self) -> Optional[float]:
        """Deterministic-mode chunk cost on THIS replica's generation (the
        fleet-wide ``chunk_s`` divided by the generation speed factor)."""
        return None if self.chunk_s is None else self.chunk_s / self.speed

    def energy_wh(self, now: float) -> float:
        """Energy charged to this replica: allocated-lifetime Wh (a held
        slice burns power whether busy or idle — that is why perf/Watt
        placement matters)."""
        end = self.t_end if self.t_end is not None else now
        return self.watts * max(0.0, end - self.t_alloc) / 3600.0

    def cost_usd(self, now: float) -> float:
        """Dollar cost of this replica's allocated lifetime."""
        end = self.t_end if self.t_end is not None else now
        return self.dollars_per_h * max(0.0, end - self.t_alloc) / 3600.0

    # -- dispatch / step ------------------------------------------------------

    def dispatch(self, req: FleetRequest) -> None:
        """Hand one fleet request to this replica's engine.  A migrated
        request re-prefills its original prompt *plus* every token already
        decoded elsewhere, and only owes the remainder.

        The engine's prefill window is ``spec.prompt_len`` wide, so the
        continuation is conditioned on the last ``prompt_len`` tokens of
        (prompt + decoded) — bitwise-lossless whenever the combined context
        fits the window (size ``prompt_len`` generously for that), a
        sliding-window re-prefill otherwise (counted in
        ``truncated_migrations``)."""
        if not self.accepting:
            raise ReplicaError(f"replica {self.rep_id} is {self.state}")
        prompt = req.prompt
        if req.out_tokens:
            prompt = np.concatenate(
                [req.prompt, np.asarray(req.out_tokens, np.int32)])
            if len(prompt) > self.session.spec.prompt_len:
                self.truncated_migrations += 1
        er = self.session.submit(prompt,
                                 max_new_tokens=req.remaining_tokens)
        self._assigned[er.rid] = (req, len(req.out_tokens), er)
        req.status = "queued"
        req.replicas.append(self.rep_id)

    def runnable(self, now: float) -> bool:
        """Ready to start a chunk at virtual time `now`?"""
        return (self.state in (ACTIVE, DRAINING)
                and self.ready_at <= now and self.busy_until <= now
                and self.session.depth > 0)

    def next_start(self) -> Optional[float]:
        """Earliest virtual time this replica could start its next chunk,
        or None if it has nothing to run."""
        if self.state not in (ACTIVE, DRAINING, PROVISIONING):
            return None
        if self.session.depth == 0:
            return None
        return max(self.ready_at, self.busy_until)

    def step(self, now: float) -> List[FleetRequest]:
        """Run ONE real admission+decode chunk; charge its latency (measured
        or fixed, dragged by the slice's slowest block — a synchronous step
        finishes when the last block does) plus any pending reconfiguration
        stall to the virtual clock.  Returns the fleet requests that
        completed in this chunk, stamped with virtual times."""
        t0 = time.perf_counter()
        # the chunk ends with the host copy of its tokens (a sync): a
        # measured chunk is the card's time plus the host's
        self.session.step_chunk()
        base = (time.perf_counter() - t0 if self.chunk_s is None
                else self.chunk_s) / self.speed
        lat = base * self.slice.slowdown_factor()
        self._maybe_swap_straggler(base)
        stall = self.session.stall_s - self._stall_seen
        self._stall_seen = self.session.stall_s
        end = now + lat + stall
        self.busy_until = end
        self.busy_s += lat + stall
        self.chunks_run += 1
        if self.tracer.enabled:
            # the chunk's virtual interval, known only after the fact —
            # the explicit-timestamp form exists for exactly this
            self.tracer.complete("replica.chunk", now, end, cat="serve",
                                 track=self.track, stall_s=stall)
        return self._harvest(end)

    def _maybe_swap_straggler(self, base_s: float) -> None:
        """Feed this chunk's modeled per-block times to the detector; when
        it confirms a straggler AND the recovered time pays for the
        reconfiguration blackout, swap the block.  The `SliceEvent`'s
        downtime lands in the session's stall clock and is charged on this
        very step."""
        det = self.straggler
        if det is None or self.state not in (ACTIVE, DRAINING):
            return
        blk = det.observe(self.slice.block_times(base_s))
        if blk is None:
            return
        if not det.worth_swapping(blk, base_s, self.slice.swap_cost_s(blk)):
            return
        if self.slice.swap_straggler(blk) is not None:
            det.fired(blk)
            self.straggler_swaps += 1

    def _harvest(self, t: float) -> List[FleetRequest]:
        """Sync engine progress into the fleet requests after a chunk."""
        finished: List[FleetRequest] = []
        for rid in list(self._assigned):
            req, base, er = self._assigned[rid]
            if len(er.out_tokens) > len(req.out_tokens) - base:
                new = er.out_tokens[len(req.out_tokens) - base:]
                req.out_tokens.extend(int(x) for x in new)
                self.tokens_served += len(new)
            if req.t_first is None and er.out_tokens:
                req.t_first = t
            if er.done:
                req.status = "done"
                req.t_done = t
                if self.tracer.enabled:
                    self.tracer.complete(
                        "req.lifetime", req.t_arrival, t, cat="request",
                        track=self.track, fid=req.fid,
                        migrations=req.migrations)
                finished.append(req)
                del self._assigned[rid]
        return finished

    # -- drain / death / free -------------------------------------------------

    def drain(self) -> None:
        if self.state in (PROVISIONING, ACTIVE):
            self.state = DRAINING
            self.session.drain()

    def undrain(self) -> None:
        """Cancel a drain (the autoscaler reuses a draining replica instead
        of paying a fresh provision when load returns)."""
        if self.state == DRAINING:
            self.state = ACTIVE
            self.session.undrain()

    @property
    def drained(self) -> bool:
        return self.state == DRAINING and self.session.is_drained

    def evacuate(self) -> List[FleetRequest]:
        """Pull every unfinished request off this replica (after its slice
        died): engine state is exported, fleet bookkeeping is synced, and the
        requests go back to the router with their decoded-so-far tokens as
        re-prefill context."""
        exported = self.session.export_inflight()
        exported_rids = {er.rid for er in exported}
        orphans: List[FleetRequest] = []
        for rid in list(self._assigned):
            req, base, er = self._assigned[rid]
            if rid not in exported_rids:
                continue
            # tokens decoded before death are kept — the survivor re-prefills
            # them instead of re-serving them
            got = len(req.out_tokens) - base
            if len(er.out_tokens) > got:
                req.out_tokens.extend(
                    int(x) for x in er.out_tokens[got:])
            req.status = "pending"
            req.migrations += 1
            orphans.append(req)
            del self._assigned[rid]
        return orphans

    def free(self) -> None:
        """Release the slice back to the machine.  Refuses while any request
        is still owed tokens — the autoscaler must drain first."""
        if self._assigned or (self.alive and self.session.depth):
            raise ReplicaError(
                f"replica {self.rep_id} still owes work "
                f"({len(self._assigned)} assigned); drain before free")
        if self.state != DEAD:
            self.slice.free()
        self.state = FREED

    def retire(self) -> None:
        """Drop the session/slice/engine references once this replica is
        FREED or DEAD: a long-lived service keeps retired replicas for
        their stats only, and must not pin each one's device KV cache."""
        assert self.state in (FREED, DEAD), self.state
        assert not self._assigned, "retire() before evacuation/drain"
        self._final_stats = self.stats()
        self.session.close()
        self.session = None
        self.slice = None

    def stats(self) -> Dict[str, object]:
        if self._final_stats is not None:
            return self._final_stats
        end = self.t_end if self.t_end is not None else self.t_alloc
        out = {
            "rep_id": self.rep_id,
            "state": self.state,
            "tokens_served": self.tokens_served,
            "chunks_run": self.chunks_run,
            "busy_s": round(self.busy_s, 4),
            "truncated_migrations": self.truncated_migrations,
            "straggler_swaps": self.straggler_swaps,
            "gen": self.gen,
            "speed": round(self.speed, 4),
            "watts": round(self.watts, 2),
            "energy_wh": round(self.energy_wh(end), 6),
            "cost_usd": round(self.cost_usd(end), 8),
        }
        eng = getattr(self.session, "engine", None)
        kv = eng.kv_stats() if eng is not None and hasattr(eng, "kv_stats") \
            else {}
        if kv:
            out.update({
                "prefill_flops_proxy": kv["prefill_flops_proxy"],
                "kv_prompt_tokens": kv["kv_prompt_tokens"],
                "kv_shared_tokens": kv["kv_shared_tokens"],
                "kv_migrated_shared_blocks": kv["kv_migrated_shared_blocks"],
                "kv_migrated_suffix_blocks": kv["kv_migrated_suffix_blocks"],
            })
        return out
