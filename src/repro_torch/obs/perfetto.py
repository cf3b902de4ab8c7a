"""Chrome-trace / Perfetto JSON export (and re-import).

A copy of ``repro/obs/perfetto.py`` (no JAX in it): the port imports nothing
of the JAX package, so it keeps its own.

Emits the Trace Event Format that both ``chrome://tracing`` and
https://ui.perfetto.dev open directly:

  * one *lane* per tracer track (``pid`` is the process label, each
    track becomes a ``tid`` named via ``"M"`` metadata events);
  * finished spans → ``"X"`` complete events (``ts``/``dur`` in µs);
  * instant marks (failures, swaps, preemptions, scale decisions) →
    ``"i"`` instant events with thread scope.

Timestamps are seconds in the tracer (virtual or wall) and microseconds
on the wire, per the format spec.  `from_chrome_trace` parses an
exported file back into plain span/event dicts — the schema round-trip
tests pin that nothing is lost in translation.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

_S_TO_US = 1e6


def _track_order(tracks) -> Dict[str, int]:
    """Stable track → tid assignment: sorted names, tid from 1."""
    return {name: i + 1 for i, name in enumerate(sorted(tracks))}


def to_chrome_trace(tracer, *, process_name: str = "repro",
                    metrics: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Render a `Tracer`'s spans/events as a Chrome-trace JSON object."""
    pid = 1
    tracks = {s.track for s in tracer.spans} | {e.track for e in tracer.events}
    tids = _track_order(tracks)

    te: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid,
        "args": {"name": process_name},
    }]
    for track, tid in tids.items():
        te.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                   "args": {"name": track}})

    for s in tracer.spans:
        te.append({
            "name": s.name, "cat": s.cat or "span", "ph": "X",
            "pid": pid, "tid": tids[s.track],
            "ts": s.t0 * _S_TO_US, "dur": max(0.0, s.dur) * _S_TO_US,
            "args": dict(s.args),
        })
    for e in tracer.events:
        te.append({
            "name": e.name, "cat": e.cat or "event", "ph": "i", "s": "t",
            "pid": pid, "tid": tids[e.track],
            "ts": e.t * _S_TO_US,
            "args": dict(e.args),
        })

    out: Dict[str, Any] = {
        "traceEvents": te,
        "displayTimeUnit": "ms",
        "otherData": {
            "dropped_spans": tracer.dropped_spans,
            "dropped_events": tracer.dropped_events,
        },
    }
    if metrics is not None:
        out["otherData"]["metrics"] = metrics
    return out


def write_chrome_trace(tracer, path: str, **kw) -> None:
    """`to_chrome_trace` straight to a file Perfetto can open."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer, **kw), f, default=str)


def from_chrome_trace(obj) -> Dict[str, Any]:
    """Parse Chrome-trace JSON (object, JSON text, or file path) back to
    ``{"spans": [...], "events": [...], "tracks": {tid: name}, ...}``
    with timestamps restored to seconds."""
    if isinstance(obj, str):
        if obj.lstrip().startswith(("{", "[")):
            obj = json.loads(obj)
        else:
            with open(obj) as f:
                obj = json.load(f)
    te = obj["traceEvents"] if isinstance(obj, dict) else obj

    tracks: Dict[int, str] = {}
    spans: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    for ev in te:
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "thread_name":
                tracks[ev.get("tid", 0)] = ev["args"]["name"]
            continue
        rec = {
            "name": ev["name"], "cat": ev.get("cat", ""),
            "tid": ev.get("tid", 0),
            "t0": ev["ts"] / _S_TO_US,
            "args": ev.get("args", {}),
        }
        if ph == "X":
            rec["dur"] = ev.get("dur", 0.0) / _S_TO_US
            spans.append(rec)
        elif ph == "i":
            events.append(rec)
    for rec in spans + events:
        rec["track"] = tracks.get(rec.pop("tid"), "main")

    out = {"spans": spans, "events": events,
           "tracks": {str(k): v for k, v in tracks.items()}}
    if isinstance(obj, dict):
        out["otherData"] = obj.get("otherData", {})
    return out
