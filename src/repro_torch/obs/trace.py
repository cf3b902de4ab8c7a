"""Span tracer with an injectable clock.

A copy of ``repro/obs/trace.py`` (no JAX in it): the port imports nothing of
the JAX package, so it keeps its own.

One `Tracer` records nested `Span`s (duration) and instant events onto
named *tracks* (one lane per replica/slice/subsystem in the Perfetto
export).  Three recording styles cover every call site:

  * ``with tracer.span("serve.decode", track="replica:0"):`` — scoped
    work timed by the tracer's clock (nesting tracked per-track via a
    span stack, so children carry their parent's id);
  * ``tracer.begin(...)`` / ``tracer.end(handle)`` — long-lived
    lifecycles that don't fit a ``with`` block (a slice's
    allocate→free span lives across many calls);
  * ``tracer.complete(name, t0, t1, ...)`` — fully explicit timestamps,
    the natural form for virtual-time event loops that know exactly when
    a chunk started and ended on the fleet clock.

The clock is *injected*: wall time by default, or a `VirtualClock` the
fleet event loop advances — so fleet virtual time and wall time both
trace deterministically through the same API.

`NoopTracer` (module singleton `NOOP_TRACER`) is the zero-cost default:
``span`` returns one shared reusable null context, ``event`` is a pass —
no allocation, no clock read, no branch beyond the method dispatch.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

DEFAULT_TRACK = "main"


class VirtualClock:
    """A clock somebody else advances (the fleet event loop): reading it
    costs one attribute load, advancing it is monotonic by construction."""

    __slots__ = ("now",)

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def advance(self, t: float) -> None:
        """Move the clock forward to ``t`` (backward moves are ignored —
        a virtual clock never rewinds)."""
        if t > self.now:
            self.now = t

    def __call__(self) -> float:
        return self.now


@dataclasses.dataclass
class Span:
    """One completed (or still-open) traced operation."""
    sid: int
    name: str
    cat: str
    track: str
    t0: float
    t1: Optional[float] = None          # None while open
    parent: Optional[int] = None        # sid of the enclosing span
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def dur(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0


@dataclasses.dataclass
class Event:
    """One instant mark (a failure, a swap, a scale decision)."""
    name: str
    cat: str
    track: str
    t: float
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


class _SpanCtx:
    """Reusable-ish context manager returned by `Tracer.span`."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, *exc) -> None:
        self._tracer.end(self._span)


class _NullCtx:
    """Shared no-op context (reentrant, reusable)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL_CTX = _NullCtx()


class NoopTracer:
    """The disabled tracer: every method is a constant-cost no-op, so
    instrumented code pays nothing when tracing is off (the bitwise
    non-interference contract tests/test_observability.py pins)."""

    enabled = False
    spans: List[Span] = []              # class-level: always empty
    events: List[Event] = []
    dropped_spans = 0
    dropped_events = 0

    def span(self, name, cat="", track=None, **args):
        return _NULL_CTX

    def begin(self, name, cat="", track=None, t=None, **args):
        return None

    def end(self, span, t=None) -> None:
        return None

    def complete(self, name, t0, t1, cat="", track=None, **args):
        return None

    def event(self, name, cat="", track=None, t=None, **args):
        return None


NOOP_TRACER = NoopTracer()


class Tracer(NoopTracer):
    """Recording tracer.

    Args:
      clock: zero-arg callable returning the current time in seconds
        (wall `time.perf_counter` by default, or a `VirtualClock`).
      recorder: optional `obs.flight.FlightRecorder`; finished spans and
        instant events are mirrored into its ring.
      max_spans / max_events: retention bounds.  Past them, *new* records
        are counted in ``dropped_spans``/``dropped_events`` instead of
        stored — the exporter surfaces the counts, so a truncated trace
        never silently poses as complete.
    """

    enabled = True

    def __init__(self, clock=None, *, recorder=None,
                 max_spans: int = 200_000, max_events: int = 200_000):
        self.clock = clock if clock is not None else time.perf_counter
        self.recorder = recorder
        self.max_spans = max_spans
        self.max_events = max_events
        self.spans: List[Span] = []
        self.events: List[Event] = []
        self.dropped_spans = 0
        self.dropped_events = 0
        self._ids = itertools.count()
        self._open: Dict[str, List[Span]] = {}    # track -> span stack

    # -- spans -----------------------------------------------------------------

    def begin(self, name: str, cat: str = "", track: Optional[str] = None,
              t: Optional[float] = None, **args) -> Span:
        track = track or DEFAULT_TRACK
        stack = self._open.setdefault(track, [])
        span = Span(sid=next(self._ids), name=name, cat=cat, track=track,
                    t0=self.clock() if t is None else t,
                    parent=stack[-1].sid if stack else None, args=args)
        stack.append(span)
        return span

    def end(self, span: Optional[Span], t: Optional[float] = None) -> None:
        if span is None:
            return
        span.t1 = self.clock() if t is None else t
        stack = self._open.get(span.track, [])
        if span in stack:
            # close any children left open (crash / early return inside)
            while stack and stack[-1] is not span:
                dangling = stack.pop()
                dangling.t1 = span.t1
                self._store(dangling)
            stack.pop()
        self._store(span)

    def span(self, name: str, cat: str = "", track: Optional[str] = None,
             **args) -> _SpanCtx:
        return _SpanCtx(self, self.begin(name, cat, track, **args))

    def complete(self, name: str, t0: float, t1: float, cat: str = "",
                 track: Optional[str] = None, **args) -> Span:
        """Record an already-finished span with explicit timestamps (no
        stack interaction — virtual-time loops emit these out of order)."""
        span = Span(sid=next(self._ids), name=name, cat=cat,
                    track=track or DEFAULT_TRACK, t0=t0, t1=t1, args=args)
        self._store(span)
        return span

    def _store(self, span: Span) -> None:
        if len(self.spans) >= self.max_spans:
            self.dropped_spans += 1
            return
        self.spans.append(span)
        if self.recorder is not None:
            self.recorder.record("span", span.name, span.t1,
                                 track=span.track, dur=span.dur,
                                 **span.args)

    # -- instants --------------------------------------------------------------

    def event(self, name: str, cat: str = "", track: Optional[str] = None,
              t: Optional[float] = None, **args) -> Optional[Event]:
        ev = Event(name=name, cat=cat, track=track or DEFAULT_TRACK,
                   t=self.clock() if t is None else t, args=args)
        if len(self.events) >= self.max_events:
            self.dropped_events += 1
            return None
        self.events.append(ev)
        if self.recorder is not None:
            self.recorder.record("event", ev.name, ev.t, track=ev.track,
                                 **ev.args)
        return ev

    # -- read side -------------------------------------------------------------

    def open_spans(self) -> List[Span]:
        """Spans begun but not yet ended (live lifecycles)."""
        return [s for stack in self._open.values() for s in stack]

    def find(self, name: str) -> List[Span]:
        """Finished spans with this exact name, in record order."""
        return [s for s in self.spans if s.name == name]

    def find_events(self, name: Optional[str] = None,
                    cat: Optional[str] = None) -> List[Event]:
        """Instant events filtered by name and/or category, time-ordered."""
        evs = [e for e in self.events
               if (name is None or e.name == name)
               and (cat is None or e.cat == cat)]
        return sorted(evs, key=lambda e: e.t)
