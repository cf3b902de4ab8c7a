"""SLO-aware request routing over the replica pool.

Policies (pick with ``RouterConfig.policy``):

  * ``least_loaded`` — send to the replica owing the fewest decode tokens
    (ties broken toward fewer queued requests, then lower id).  Cheap and
    close to optimal under uniform request shapes.
  * ``least_eta`` — shortest-expected-TTFT: rank replicas by the engine's
    queue-aware TTFT estimate plus any provisioning delay and in-flight
    chunk tail (`ServeReplica.eta_s`).  Better under mixed lengths, since a
    short queue of long requests can be worse than a long queue of short
    ones.
  * ``round_robin`` — the classic strawman, kept for comparisons.
  * ``prefix_affinity`` — score each eligible replica by how many of the
    request's leading prompt tokens its shared KV pool already holds
    (`ServeSession.prefix_lookup`, a peek into the engine's prefix trie)
    and keep only the best scorers; ties — including the no-hit-anywhere
    case — fall back to ``least_eta`` ordering.  Steering same-header
    requests (per-tier system prompts, few-shot preambles) to the replica
    that already prefilled the header turns the kv-pool's block sharing
    into a fleet-level win: the suffix-only prefill happens where the
    prefix lives.
  * ``slo_tiered`` — generation-aware tiering for heterogeneous fleets:
    batch-tier requests (TTFT deadline above ``slo_fast_ttft_s``) prefer a
    strictly-slower pool when one exists (old silicon earns its power bill
    on deadline-insensitive work, and the fast pool keeps headroom for the
    latency tier); tight-SLO requests consider every replica but the
    speed-aware ``least_eta`` ranking pulls them onto the fastest silicon
    whenever it has headroom.  On a homogeneous fleet every replica is the
    same speed and the policy degenerates to ``least_eta``.

Admission backpressure: a replica whose engine already holds
``max_queue_per_replica`` unfinished requests is not eligible; when no
replica is eligible the router returns None and the service parks the
request in its bounded wait queue (beyond that, requests are *dropped* and
reported — open-loop traffic does not magically slow down because the fleet
is full).

Port of ``repro/fleet/router.py``: the same policies, the ``fleet.*``
counters on the port's `obs.Telemetry`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.fleet.replica import ServeReplica
from repro_torch.fleet.traffic import FleetRequest
from repro_torch.obs import Telemetry

POLICIES = ("least_loaded", "least_eta", "round_robin", "prefix_affinity",
            "slo_tiered")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    policy: str = "least_loaded"
    max_queue_per_replica: int = 16     # unfinished requests per engine
    default_chunk_s: float = 0.05       # ETA prior before latency samples
    # slo_tiered: requests with a TTFT SLO above this bound are batch-tier
    # and prefer the slower/cheaper pool when one exists; at or under it
    # they ride the speed-aware least-ETA ranking (fast silicon first)
    slo_fast_ttft_s: float = 1.0

    def __post_init__(self):
        assert self.policy in POLICIES, self.policy
        assert self.max_queue_per_replica >= 1


class Router:
    """Dispatch fleet requests into replica engines under one policy
    (`least_loaded` by owed tokens, `least_eta` by queue-aware expected
    TTFT, or `round_robin`), with per-replica queue bounds as the
    backpressure surface."""

    def __init__(self, cfg: Optional[RouterConfig] = None,
                 obs: Optional[Telemetry] = None):
        self.cfg = cfg or RouterConfig()
        # routing counters live in the metrics registry; the old attribute
        # names (routed/rerouted/prefix_hits/prefix_misses) are property
        # views below, so existing readers are unchanged
        self.obs = obs if obs is not None else Telemetry()
        reg = self.obs.metrics
        self._c_routed = reg.counter("fleet.routed")
        self._c_rerouted = reg.counter("fleet.rerouted")
        self._c_hits = reg.counter("fleet.prefix_lookups", outcome="hit")
        self._c_misses = reg.counter("fleet.prefix_lookups", outcome="miss")
        self._rr = 0

    @property
    def routed(self) -> int:
        return self._c_routed.value

    @property
    def rerouted(self) -> int:
        """Migration re-dispatches."""
        return self._c_rerouted.value

    @property
    def prefix_hits(self) -> int:
        """Routed to a replica already holding a shared prefix."""
        return self._c_hits.value

    @property
    def prefix_misses(self) -> int:
        """No replica held any of the request's prefix."""
        return self._c_misses.value

    def eligible(self, replicas: List[ServeReplica]) -> List[ServeReplica]:
        """Replicas that may accept new work (accepting state and below
        the per-replica queue bound)."""
        return [r for r in replicas
                if r.accepting and r.depth < self.cfg.max_queue_per_replica]

    def pick(self, replicas: List[ServeReplica], now: float,
             req: Optional[FleetRequest] = None) -> Optional[ServeReplica]:
        """Choose a replica for the next request, or None (backpressure)."""
        cands = self.eligible(replicas)
        if not cands:
            return None
        if self.cfg.policy == "round_robin":
            chosen = cands[self._rr % len(cands)]
            self._rr += 1
            return chosen
        if self.cfg.policy == "prefix_affinity" and req is not None:
            # peek every candidate's prefix trie; a strict-positive best
            # score narrows the field to the replicas already holding the
            # longest shared prefix, then ETA ordering breaks ties
            scores = [getattr(r.session, "prefix_lookup",
                              lambda _p: 0)(req.prompt) for r in cands]
            best = max(scores)
            if best > 0:
                self._c_hits.inc()
                cands = [r for r, s in zip(cands, scores) if s == best]
            else:
                self._c_misses.inc()
        if self.cfg.policy == "slo_tiered" and req is not None \
                and req.ttft_slo_s > self.cfg.slo_fast_ttft_s:
            # batch-tier traffic yields the fast silicon: prefer a strictly
            # slower pool when one exists, so old machines earn their power
            # bill on deadline-insensitive work and the fast pool keeps
            # headroom for the latency tier.  Tight-SLO requests are NOT
            # hard-pinned to the fastest generation — the ETA ranking below
            # already divides by replica speed, so they gravitate to fast
            # silicon when it has headroom but can overflow to slower
            # replicas instead of queueing behind each other at peak.
            speeds = [getattr(r, "speed", 1.0) for r in cands]
            slow = [r for r, s in zip(cands, speeds) if s < max(speeds)]
            if slow:
                cands = slow
        if self.cfg.policy in ("least_eta", "prefix_affinity", "slo_tiered"):
            # price fresh replicas with the fleet-wide observed chunk cost,
            # not the static prior — otherwise a cold (sample-free) replica
            # can rank worse than a warm loaded one by prior mismatch alone
            emas = [e for e in (r.session.chunk_time_ema(0.0)
                                for r in cands if r.alive) if e > 0.0]
            prior = (sum(emas) / len(emas)) if emas \
                else self.cfg.default_chunk_s
            return min(cands, key=lambda r: (r.eta_s(now, prior), r.rep_id))
        return min(cands, key=lambda r: (
            r.tokens_owed(), r.depth, r.rep_id))

    def route(self, req: FleetRequest, replicas: List[ServeReplica],
              now: float) -> Optional[ServeReplica]:
        """Dispatch `req` to the chosen replica; None means backpressure."""
        chosen = self.pick(replicas, now, req)
        if chosen is None:
            return None
        chosen.dispatch(req)
        self._c_routed.inc()
        if req.migrations:
            self._c_rerouted.inc()
        tr = self.obs.tracer
        if tr.enabled:
            tr.event("req.route", cat="request",
                     track=f"replica:{chosen.rep_id}", t=now,
                     fid=req.fid, migrations=req.migrations)
        return chosen
