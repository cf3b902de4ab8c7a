"""Automatic straggler detection with hysteresis (paper §2.3, §6).

TPU v4's availability story treats *stragglers* — healthy blocks running
slow (thermals, failing HBM, noisy hosts) — as first-class failures: the
OCS can swap a slow block for a spare in milliseconds, but something has to
NOTICE the slow block first.  This module is that something.

`StragglerDetector` consumes per-block step times (one observation per
synchronous step — `Slice.block_times` models them from the scheduler's
slowdown state) and flags a block only when its step-time ratio to the
slice median stays over threshold for `patience` CONSECUTIVE steps (an
EMA of the ratio grades severity, but the streak is instantaneous).  One
noisy step — however large — bumps the streak to 1 and the next normal
step resets it to 0: no flapping.  After
a swap fires, `cooldown_steps` of quiet follow before the next candidate
can fire, so back-to-back reconfigurations cannot cascade while the fabric
settles.

The swap itself is a *decision*, not a reflex: `worth_swapping` compares
the per-step time recovered against the ACOS-style reconfiguration blackout
(`Slice.swap_cost_s`) over the caller's remaining horizon — a straggler
near the end of a job is cheaper to tolerate than to fix.

Wiring: `ServeReplica` (fleet) and `TrainSession.run` (cluster) feed the
detector each step and call `Slice.swap_straggler` when it fires; the
resulting `SliceEvent` charges the blackout to the session's stall clock,
closing the detect → swap → recover loop end-to-end.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    """Knobs of the detector's hysteresis and the swap economics."""
    threshold: float = 1.25         # EMA step-time ratio vs slice median
    ema_alpha: float = 0.4          # per-step EMA weight of the new ratio
    patience: int = 3               # consecutive over-threshold steps to fire
    cooldown_steps: int = 8         # quiet steps after a swap
    horizon_steps: int = 200        # payback window for `worth_swapping`

    def __post_init__(self):
        assert self.threshold > 1.0
        assert 0.0 < self.ema_alpha <= 1.0
        assert self.patience >= 1 and self.cooldown_steps >= 0


class StragglerDetector:
    """Per-block step-time jitter tracker with hysteresis.

    Feed `observe` one ``{block: step_seconds}`` dict per synchronous step;
    it returns the block to swap (worst confirmed straggler) or None.  The
    caller performs the swap and reports it back via `fired` (which starts
    the cooldown and resets the block's history)."""

    def __init__(self, cfg: Optional[StragglerConfig] = None):
        self.cfg = cfg or StragglerConfig()
        self._ema: Dict[int, float] = {}
        self._streak: Dict[int, int] = {}
        self._cooldown = 0
        self.steps_seen = 0
        self.fired_log: List[Tuple[int, int]] = []   # (step, block)

    def observe(self, block_times: Dict[int, float]) -> Optional[int]:
        """One step of per-block times.  Returns a confirmed straggler to
        swap, or None (below threshold, within patience, or cooling down).
        """
        self.steps_seen += 1
        if len(block_times) < 2:
            return None         # a 1-block slice has no peers to lag behind
        times = sorted(block_times.values())
        mid = len(times) // 2
        median = (times[mid] if len(times) % 2
                  else 0.5 * (times[mid - 1] + times[mid]))
        if median <= 0.0:
            return None
        a = self.cfg.ema_alpha
        for blk, t in block_times.items():
            ratio = t / median
            prev = self._ema.get(blk, ratio)
            self._ema[blk] = a * ratio + (1.0 - a) * prev
            # the streak counts INSTANTANEOUS over-threshold steps — one
            # normal step resets it, so a single noisy outlier (however
            # large) can never fire; the EMA only grades severity
            if ratio > self.cfg.threshold:
                self._streak[blk] = self._streak.get(blk, 0) + 1
            else:
                self._streak[blk] = 0
        # forget blocks that left the slice (post-swap geometry change)
        for blk in list(self._ema):
            if blk not in block_times:
                self._ema.pop(blk)
                self._streak.pop(blk, None)
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        confirmed = [b for b, s in self._streak.items()
                     if s >= self.cfg.patience]
        if not confirmed:
            return None
        return max(confirmed, key=lambda b: (self._ema[b], b))

    def fired(self, block: int) -> None:
        """Record that the caller swapped ``block``: starts the cooldown
        and drops the block's history (its replacement starts clean)."""
        self._cooldown = self.cfg.cooldown_steps
        self._ema.pop(block, None)
        self._streak.pop(block, None)
        self.fired_log.append((self.steps_seen, block))

    def slowdown_estimate(self, block: int) -> float:
        """Detector's current estimate of the block's step-time ratio."""
        return self._ema.get(block, 1.0)

    def worth_swapping(self, block: int, base_step_s: float,
                       blackout_s: float,
                       remaining_steps: Optional[int] = None) -> bool:
        """Payback check: does the time recovered over the remaining
        horizon beat the reconfiguration blackout?  ``remaining_steps``
        defaults to the configured horizon (serving has no natural end).
        """
        horizon = (self.cfg.horizon_steps if remaining_steps is None
                   else remaining_steps)
        gain_per_step = (self.slowdown_estimate(block) - 1.0) * base_step_s
        return gain_per_step * horizon > blackout_s
