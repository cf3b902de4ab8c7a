"""Unified telemetry: span tracing, metrics, Perfetto export, flight recorder.

A copy of ``repro/obs/__init__.py`` (no JAX in it): the port imports nothing
of the JAX package, so it keeps its own.

One `Telemetry` object is the handle every subsystem takes:

    obs = Telemetry(tracing=True, clock=VirtualClock())
    with obs.span("serve.decode", track="replica:0"):
        ...
    obs.metrics.counter("fleet.drops", reason="stranded").inc()
    obs.event("machine.fail", cat="failure", block=3)
    obs.postmortem("slice_lost", job="train-0")

Cost model:

  * **tracing** is opt-in (`tracing=False` default → the shared
    `NOOP_TRACER`; `obs.span(...)` returns one reusable null context,
    `complete`/`begin`/`end` are no-ops) — zero-cost when disabled;
  * **metrics** and the **flight recorder** are always on — an `inc` is
    one int add, a flight record one deque append — cheap enough that
    drop accounting and postmortems never depend on a debug flag.

`Telemetry.event` feeds the flight ring unconditionally and forwards to
the tracer only when tracing is enabled, so the last-N window behind a
postmortem is populated even in the default configuration.

`NULL_OBS` is a module-level default Telemetry (wall clock, tracing off)
for code paths constructed without an explicit handle.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

from .flight import DEFAULT_CAPACITY, FlightRecorder
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, Series)
from .perfetto import from_chrome_trace, to_chrome_trace, write_chrome_trace
from .trace import (DEFAULT_TRACK, NOOP_TRACER, Event, NoopTracer, Span,
                    Tracer, VirtualClock)

__all__ = [
    "Telemetry", "NULL_OBS",
    "Tracer", "NoopTracer", "NOOP_TRACER", "Span", "Event", "VirtualClock",
    "DEFAULT_TRACK",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Series",
    "FlightRecorder",
    "to_chrome_trace", "write_chrome_trace", "from_chrome_trace",
]


class Telemetry:
    """The one handle: tracer + metrics registry + flight recorder.

    Args:
      tracing: record spans/events in a real `Tracer` (else the shared
        no-op tracer — the zero-cost default).
      clock: injectable time source for the tracer and flight records; a
        `VirtualClock` for fleet virtual time, or wall
        `time.perf_counter` when None.
      flight_capacity: depth of the always-on flight ring.
    """

    def __init__(self, tracing: bool = False, clock=None,
                 flight_capacity: int = DEFAULT_CAPACITY):
        self.clock = clock if clock is not None else time.perf_counter
        self.metrics = MetricsRegistry()
        self.recorder = FlightRecorder(capacity=flight_capacity)
        if tracing:
            # the tracer mirrors finished spans/events into the flight ring
            self.tracer: NoopTracer = Tracer(self.clock,
                                             recorder=self.recorder)
        else:
            self.tracer = NOOP_TRACER

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    # -- recording (delegates; hot paths may grab .tracer/.metrics direct) -----

    def span(self, name: str, cat: str = "", track: Optional[str] = None,
             **args):
        return self.tracer.span(name, cat, track, **args)

    def complete(self, name: str, t0: float, t1: float, cat: str = "",
                 track: Optional[str] = None, **args):
        return self.tracer.complete(name, t0, t1, cat, track, **args)

    def event(self, name: str, cat: str = "", track: Optional[str] = None,
              t: Optional[float] = None, **args) -> None:
        """Instant mark: always into the flight ring, into the tracer
        only when tracing — incidents are recorded even when disabled.
        (The enabled tracer mirrors into the ring itself, so each event
        lands there exactly once either way.)"""
        if t is None:
            t = self.clock()
        if self.tracer.enabled:
            self.tracer.event(name, cat, track, t=t, **args)
        else:
            self.recorder.record("event", name, t,
                                 track=track or DEFAULT_TRACK, **args)

    def postmortem(self, reason: str, t: Optional[float] = None,
                   **detail) -> Optional[Dict[str, Any]]:
        if t is None:
            t = self.clock()
        return self.recorder.postmortem(reason, t=t, **detail)

    # -- export ----------------------------------------------------------------

    def chrome_trace(self, *, process_name: str = "repro") -> Dict[str, Any]:
        return to_chrome_trace(self.tracer, process_name=process_name,
                               metrics=self.metrics.dump())

    def write_trace(self, path: str, *, process_name: str = "repro") -> None:
        write_chrome_trace(self.tracer, path, process_name=process_name,
                           metrics=self.metrics.dump())

    def dump_metrics(self) -> Dict[str, Any]:
        return self.metrics.dump()


NULL_OBS = Telemetry(tracing=False)
