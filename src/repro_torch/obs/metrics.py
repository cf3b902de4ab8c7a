"""Metrics registry: one API every subsystem reports through.

A copy of ``repro/obs/metrics.py`` (no JAX in it): the port imports nothing
of the JAX package, so it keeps its own.

Four metric kinds, all label-aware and always cheap enough to leave on:

  * `Counter`   — monotonically increasing int (``inc``), e.g. drops.
  * `Gauge`     — last-written float (``set``), e.g. block slowdown.
  * `Histogram` — bounded-reservoir distribution (``observe``), e.g.
    per-chunk latency; summarises to count/sum/min/max/percentiles.
  * `Series`    — append-only list of sample dicts (``append``), the
    structured per-step log surface `Trainer.metrics_log` is a view of.

A `MetricsRegistry` hands metrics out get-or-create keyed on
``(name, sorted(labels))``, so two callers asking for the same labelled
metric share one instrument, and `dump()` flattens everything into the
``{"name{k=v,...}": value}`` dict the exporters and
`scripts/render_results.py` consume.

Instruments are plain Python (an ``inc`` is one int add) — the registry
is *always on*; only span tracing (`obs.trace`) has a no-op mode.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_name(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter.  ``inc`` is the only mutator."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-value-wins float."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Distribution with exact count/sum/min/max and a bounded reservoir
    for percentiles (the first ``reservoir`` observations are kept; a
    long-lived serving process must not grow a per-chunk latency list
    without bound).  ``saturated`` flags when percentiles became a
    prefix-sample rather than the full population — no silent truncation.
    """

    __slots__ = ("count", "total", "min", "max", "_values", "_cap")

    def __init__(self, reservoir: int = 4096):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._values: List[float] = []
        self._cap = reservoir

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._values) < self._cap:
            self._values.append(v)

    def percentile(self, q: float) -> float:
        if not self._values:
            return 0.0
        return float(np.percentile(np.asarray(self._values), q))

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "saturated": False}
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "saturated": self.count > len(self._values),
        }


class Series:
    """Append-only sample log (list of dicts), optionally bounded.

    The thin-view surface: `Trainer.metrics_log` and friends stay plain
    Python lists to their readers while the data lives in the registry.
    """

    __slots__ = ("samples", "_cap", "dropped")

    def __init__(self, cap: Optional[int] = None):
        self.samples: List[Dict[str, Any]] = []
        self._cap = cap
        self.dropped = 0

    def append(self, sample: Dict[str, Any]) -> None:
        if self._cap is not None and len(self.samples) >= self._cap:
            # drop the OLDEST half in one move (amortised O(1)); the
            # dropped counter keeps the truncation visible
            keep = self._cap // 2
            self.dropped += len(self.samples) - keep
            del self.samples[:len(self.samples) - keep]
        self.samples.append(sample)

    def __len__(self) -> int:
        return len(self.samples)

    def __iter__(self):
        return iter(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class MetricsRegistry:
    """Get-or-create registry of labelled metrics.

        reg = MetricsRegistry()
        reg.counter("fleet.drops", reason="wait_queue_full").inc()
        reg.gauge("machine.block_slowdown", block=3).set(2.0)
        reg.histogram("serve.chunk_s").observe(0.011)
        reg.dump()   # {"fleet.drops{reason=wait_queue_full}": 1, ...}
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, str, LabelKey], Any] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, Any], factory):
        key = (kind, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = factory()
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, reservoir: int = 4096,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(reservoir))

    def series(self, name: str, cap: Optional[int] = None,
               **labels) -> Series:
        return self._get("series", name, labels, lambda: Series(cap))

    # -- read side -------------------------------------------------------------

    def value(self, name: str, **labels) -> Any:
        """Current value of a counter/gauge by (name, labels); 0 when the
        metric was never created (reading must not create instruments)."""
        for kind in ("counter", "gauge"):
            m = self._metrics.get((kind, name, _label_key(labels)))
            if m is not None:
                return m.value
        return 0

    def sum(self, name: str) -> float:
        """Sum of a counter/gauge across ALL label sets of ``name``."""
        total = 0.0
        for (kind, n, _), m in self._metrics.items():
            if n == name and kind in ("counter", "gauge"):
                total += m.value
        return total

    def labels_of(self, name: str) -> List[Dict[str, str]]:
        """Every label set ``name`` has been created with."""
        return [dict(key) for (kind, n, key) in self._metrics
                if n == name]

    def items(self) -> Iterable[Tuple[str, str, LabelKey, Any]]:
        for (kind, name, key), m in sorted(self._metrics.items()):
            yield kind, name, key, m

    def dump(self) -> Dict[str, Any]:
        """Flat ``{rendered_name: value}`` dict — counters/gauges as
        scalars, histograms as summary dicts, series as sample counts
        (the samples themselves stay behind the instrument; a flat dump
        must stay flat)."""
        out: Dict[str, Any] = {}
        for kind, name, key, m in self.items():
            rname = _render_name(name, key)
            if kind in ("counter", "gauge"):
                out[rname] = m.value
            elif kind == "histogram":
                out[rname] = m.summary()
            else:                               # series
                out[rname] = {"samples": len(m), "dropped": m.dropped}
        return out
