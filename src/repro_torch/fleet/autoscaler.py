"""Elastic multi-slice autoscaling: right-size the replica pool on demand.

The paper's §2 claim is that OCS reconfiguration lets one machine carve out
right-sized slices in seconds; this controller exercises exactly that —
watching queue backlog and the observed p95 TTFT, allocating a new slice
through `Supercomputer.allocate` when the fleet falls behind and *draining*
a replica (serve out its work, then `Slice.free`) when capacity idles.

Decisions are deliberately boring: per-live-replica backlog watermarks with
a cooldown, plus an optional p95-TTFT target.  ``scale_to_zero`` lets the
pool drain entirely between bursts (min_replicas=0), paying the provisioning
latency on the next arrival — the classic serverless trade.

**Predictive pre-provisioning** (`ForecastConfig`): production fleets serve
diurnal traffic whose peaks are *known* — reacting after the backlog builds
means every burst edge eats one provisioning latency of degraded TTFT.  The
`RateForecaster` bins the observed arrival stream and extrapolates the rate
one provisioning lead ahead (periodic fold when the diurnal period is
known, persistence otherwise); the controller converts that to a replica
target via the fleet's *measured* per-replica service rate and provisions
ahead of the rise, bypassing the reactive cooldown (a scheduled ramp is not
flapping).  The same forecast suppresses scale-downs into a predicted peak.
When the forecast abstains (cold start) or underpredicts (traffic deviates
from pattern), the reactive watermarks still fire — prediction only ever
*adds* capacity earlier, so a wrong forecast degrades to the reactive
controller, never below it.

Port of ``repro/fleet/autoscaler.py``: pure policy on virtual time, the
reference's decisions for the same observations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.fleet.replica import (ACTIVE, DRAINING, PROVISIONING,
                                       ServeReplica)


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    """Knobs of the arrival-rate forecaster.

    ``period_s`` is the operator's knowledge ("our traffic is daily"): with
    it, the forecaster folds history modulo the period and predicts from
    the same phase of past cycles — after one full period it sees every
    peak coming.  Without it, the forecast is persistence (recent windowed
    rate), which still pre-provisions into sustained ramps but cannot
    anticipate a phase change."""
    bin_s: float = 0.25             # arrival-history bin width (virtual s)
    period_s: Optional[float] = None    # known traffic period (None = no fold)
    lead_s: Optional[float] = None  # look-ahead; None = provision_s + tick_s
    safety: float = 1.15            # over-provision factor on predicted rate
    min_history_s: float = 1.0      # abstain (reactive only) before this
    recent_window_s: float = 1.0    # persistence-forecast averaging window

    def __post_init__(self):
        assert self.bin_s > 0 and self.safety > 0
        assert self.period_s is None or self.period_s > self.bin_s


class RateForecaster:
    """Binned arrival-rate history + short-horizon extrapolation.

    `observe` is O(1) per arrival (a counter bump into the bin of the
    arrival's virtual time); `forecast_peak` returns the predicted PEAK
    arrival rate over a look-ahead window, or None when history is too
    short to say anything — the caller treats None as "fall back to the
    reactive watermarks"."""

    def __init__(self, cfg: Optional[ForecastConfig] = None):
        self.cfg = cfg or ForecastConfig()
        self._bins: List[int] = []
        self._t_last = 0.0

    def observe(self, t: float) -> None:
        """Record one arrival at virtual time ``t``."""
        i = int(t / self.cfg.bin_s)
        if i >= len(self._bins):
            self._bins.extend([0] * (i + 1 - len(self._bins)))
        self._bins[i] += 1
        self._t_last = max(self._t_last, t)

    def _rate(self, i: int) -> float:
        if 0 <= i < len(self._bins):
            return self._bins[i] / self.cfg.bin_s
        return 0.0

    def _mean_rate(self, t0: float, t1: float) -> float:
        b = self.cfg.bin_s
        i0, i1 = int(t0 / b), max(int(t0 / b), int(math.ceil(t1 / b)) - 1)
        rates = [self._rate(i) for i in range(i0, i1 + 1)]
        return sum(rates) / max(1, len(rates))

    def forecast_peak(self, now: float, t0: float, t1: float
                      ) -> Optional[float]:
        """Predicted peak arrival rate over virtual window ``[t0, t1]``.

        With a known ``period_s`` and at least one full period of history,
        each future bin is predicted as the average of the SAME phase in
        every complete past cycle, and the window's max is returned (peaks
        matter for capacity; means under-provision the edge).  Otherwise a
        persistence forecast: the mean rate over the trailing
        ``recent_window_s`` (excluding the partially-filled current bin)."""
        cfg = self.cfg
        if now < cfg.min_history_s:
            return None
        if cfg.period_s is not None and now >= cfg.period_s:
            peak = 0.0
            b = cfg.bin_s
            n_bins = max(1, int(math.ceil((t1 - t0) / b)))
            for j in range(n_bins):
                c = t0 + (j + 0.5) * b
                vals = []
                back = c - cfg.period_s
                while back >= 0.0:
                    # only completed past bins vote (the bin containing
                    # `now` is still filling and would bias the phase low)
                    if back < now - b:
                        vals.append(self._rate(int(back / b)))
                    back -= cfg.period_s
                if vals:
                    peak = max(peak, sum(vals) / len(vals))
            return peak if peak > 0.0 else None
        cut = int(now / cfg.bin_s) * cfg.bin_s   # start of the current bin
        return self._mean_rate(max(0.0, cut - cfg.recent_window_s), cut)


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    tick_s: float = 0.25                # virtual seconds between decisions
    cooldown_s: float = 1.0             # between scaling actions
    scale_up_backlog: float = 4.0       # queued requests per live replica
    scale_down_backlog: float = 0.75
    target_p95_ttft_s: Optional[float] = None   # scale up when breached
    provision_s: float = 0.25           # virtual slice bring-up latency
    scale_to_zero: bool = False

    def __post_init__(self):
        assert 0 <= self.min_replicas <= self.max_replicas
        assert self.scale_down_backlog < self.scale_up_backlog


class Autoscaler:
    """Backlog/p95-watermark controller deciding scale-ups and drains,
    optionally fronted by a `RateForecaster` for predictive
    pre-provisioning.  Pure policy: `decide` returns an action, the
    `FleetService` executes it (allocation, drain bookkeeping, cooldown
    recording)."""

    def __init__(self, cfg: Optional[AutoscalerConfig] = None,
                 forecast: Optional[ForecastConfig] = None):
        self.cfg = cfg or AutoscalerConfig()
        self.forecaster = RateForecaster(forecast) if forecast else None
        self.last_action_t = float("-inf")
        self.scale_ups = 0
        self.scale_downs = 0
        self.predictive_ups = 0
        self.predicted_rate: Optional[float] = None   # last forecast (rps)
        self._pending_predictive = False

    def observe_arrival(self, t: float) -> None:
        """Feed one arrival into the forecaster (no-op when reactive)."""
        if self.forecaster is not None:
            self.forecaster.observe(t)

    def _replica_target(self, now: float, capacity_rps: Optional[float],
                        floor: int) -> Optional[int]:
        """Forecast-implied pool size: predicted peak rate over the next
        provisioning lead, with safety margin, divided by the measured
        per-replica service rate.  None = no forecast (cold start /
        reactive mode / no throughput measurement yet)."""
        if self.forecaster is None or not capacity_rps:
            return None
        fcfg = self.forecaster.cfg
        lead = (fcfg.lead_s if fcfg.lead_s is not None
                else self.cfg.provision_s + self.cfg.tick_s)
        pred = self.forecaster.forecast_peak(now, now, now + lead)
        self.predicted_rate = pred
        if pred is None:
            return None
        want = int(math.ceil(pred * fcfg.safety / capacity_rps))
        return max(floor, min(self.cfg.max_replicas, want))

    def decide(self, now: float, replicas: List[ServeReplica],
               wait_len: int, p95_ttft_s: Optional[float], *,
               capacity_rps: Optional[float] = None
               ) -> Tuple[str, Optional[ServeReplica]]:
        """One control tick.  Returns ("up", None), ("down", replica-to-
        drain), or ("hold", None).  The service executes the action (it owns
        the Supercomputer and the drain bookkeeping).

        ``capacity_rps`` is the service's measured per-replica request
        service rate — the unit that converts a forecast (requests/s) into
        a pool size.  Without it prediction abstains."""
        cfg = self.cfg
        live = [r for r in replicas if r.state in (PROVISIONING, ACTIVE)]
        backlog = wait_len + sum(r.depth for r in live)

        # the pool floor: with scale_to_zero the down-rule may empty the
        # pool, so the grow rule must use the SAME floor — otherwise the
        # two rules oscillate allocate/free forever on an idle fleet
        floor = 0 if cfg.scale_to_zero else cfg.min_replicas
        # below the floor (or scale-from-zero with work waiting): grow
        # unconditionally — cooldown must not wedge an empty pool
        if len(live) < floor or (not live and backlog > 0):
            return "up", None

        want = self._replica_target(now, capacity_rps, floor)
        if want is not None and len(live) < want:
            # predictive pre-provision: a scheduled ramp toward a known
            # peak bypasses the reactive cooldown (one replica per tick)
            self._pending_predictive = True
            return "up", None

        in_cooldown = now - self.last_action_t < cfg.cooldown_s
        per = backlog / max(1, len(live))
        breached = (cfg.target_p95_ttft_s is not None
                    and p95_ttft_s is not None
                    and p95_ttft_s > cfg.target_p95_ttft_s)
        if ((per > cfg.scale_up_backlog or breached)
                and len(live) < cfg.max_replicas and not in_cooldown):
            return "up", None

        if (len(live) > floor and not in_cooldown and not breached
                and per < cfg.scale_down_backlog
                and (want is None or len(live) > want)):
            # the `want` clause holds capacity through a predicted peak:
            # an idle pool is not surplus if the forecast says the rate is
            # about to need it
            idle = [r for r in live if r.state == ACTIVE]
            if idle:
                # generation-aware drain: among equally-idle replicas, shed
                # the worst perf/Watt silicon first (`drain_rank` is the
                # replica's generation perf/Watt; 0.0 everywhere — the
                # homogeneous fleet — leaves the legacy rep_id ordering)
                victim = min(idle, key=lambda r: (
                    r.depth, r.tokens_owed(),
                    getattr(r, "drain_rank", 0.0), r.rep_id))
                return "down", victim
        return "hold", None

    def record(self, action: str, now: float) -> None:
        """Note an executed action (starts the cooldown, bumps counters)."""
        self.last_action_t = now
        if action == "up":
            self.scale_ups += 1
            if self._pending_predictive:
                self.predictive_ups += 1
        elif action == "down":
            self.scale_downs += 1
        self._pending_predictive = False
