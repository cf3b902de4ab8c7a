"""Failure flight recorder: a bounded ring of recent telemetry.

A copy of ``repro/obs/flight.py`` (no JAX in it): the port imports nothing
of the JAX package, so it keeps its own.

Always on.  Every span/event flowing through a `Telemetry` lands here as
one small dict appended to a `collections.deque(maxlen=N)` — negligible
cost, so the recorder never needs a disable switch.  When something bad
happens (a slice goes LOST, a train session is preempted, a request is
dropped) the instrumented layer calls `postmortem(...)`, which snapshots
the last N records *leading up to* the trigger into a retained report.
That turns "a failed drill requires print-debugging through virtual
time" into "read the postmortem": the record of what happened right
before the incident is already captured by the time the incident fires.
"""
from __future__ import annotations

import collections
import itertools
import json
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 512


class FlightRecorder:
    """Bounded ring buffer of telemetry records plus retained postmortems.

    Args:
      capacity: ring depth (records beyond it age out oldest-first).
      max_postmortems: retained incident snapshots; further triggers
        still count in ``postmortems_dropped`` so a flood of incidents
        can't eat unbounded memory but is never silently miscounted.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 max_postmortems: int = 32):
        self.capacity = capacity
        self.ring: collections.deque = collections.deque(maxlen=capacity)
        self.total_records = 0
        self.postmortems: List[Dict[str, Any]] = []
        self.max_postmortems = max_postmortems
        self.postmortems_dropped = 0
        self._seq = itertools.count()

    # -- write side ------------------------------------------------------------

    def record(self, kind: str, name: str, t: Optional[float],
               **fields) -> None:
        """Append one record; O(1), drops the oldest when full."""
        rec = {"seq": next(self._seq), "kind": kind, "name": name, "t": t}
        if fields:
            rec.update(fields)
        self.ring.append(rec)
        self.total_records += 1

    def postmortem(self, reason: str, t: Optional[float] = None,
                   **detail) -> Optional[Dict[str, Any]]:
        """Snapshot the ring into a retained incident report."""
        if len(self.postmortems) >= self.max_postmortems:
            self.postmortems_dropped += 1
            return None
        pm = {
            "reason": reason,
            "t": t,
            "detail": dict(detail),
            "window": list(self.ring),       # copy: the ring keeps moving
            "records_seen": self.total_records,
        }
        self.postmortems.append(pm)
        return pm

    # -- read side -------------------------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """The current ring contents, oldest first."""
        return list(self.ring)

    def last(self, n: int) -> List[Dict[str, Any]]:
        """The most recent ``n`` records, oldest first."""
        if n <= 0:
            return []
        return list(self.ring)[-n:]

    def dump_postmortems(self, path: str) -> None:
        """Write retained postmortems as a JSON file."""
        with open(path, "w") as f:
            json.dump({
                "postmortems": self.postmortems,
                "postmortems_dropped": self.postmortems_dropped,
                "capacity": self.capacity,
                "records_seen": self.total_records,
            }, f, indent=1, default=str)
