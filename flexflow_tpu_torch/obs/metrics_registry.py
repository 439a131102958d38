"""Process-wide metrics registry with Prometheus text exposition.

The port of ``flexflow_tpu/obs/metrics_registry.py``, unchanged (plain
Python): every metric name, help string and bucket set is the JAX
package's, and the exposition text is byte for byte the same.

Counters, gauges, and histograms — the serving/executor metrics the
``/metrics`` endpoint scrapes (Prometheus text format 0.0.4, the same
surface Triton's metrics endpoint speaks). Unlike ``obs.events`` this is
always on: the metrics are plain in-process numbers whose update cost is
a dict write under a lock, and serving wants them regardless of whether
span tracing is enabled.

Labels are supported as keyword arguments::

    REGISTRY.counter("ff_requests_total", "Requests").inc(model="bert")
    REGISTRY.histogram("ff_request_latency_seconds",
                       "Latency").observe(0.012, model="bert")

Point-in-time values (queue depths, instance counts) are gauges SET at
scrape time by the ``/metrics`` route handler
(``serving.http_server.render_prometheus``) rather than on every update.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

#: default histogram buckets (seconds) — tuned for request latencies
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: µs–ms-tuned buckets (seconds) for per-token decode-step and prefill
#: latencies: the request-latency defaults start at 1 ms, so µs-scale
#: decode steps all collapse into the first bucket.  Every registration
#: site of ``ff_decode_step_seconds`` / ``ff_prefill_seconds`` must pass
#: this same set (the registry rejects mismatched explicit buckets).
DECODE_STEP_BUCKETS = (1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5,
                       1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                       0.01, 0.025, 0.05, 0.1, 0.25)


def _labelkey(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey, extra: Sequence[Tuple[str, str]] = ()
                ) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _escape(v: str) -> str:
    """Escape a label VALUE per the exposition format: backslash first
    (escaping the escapes we are about to add), then quote, then
    newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """Escape HELP text: only backslash and newline (quotes are legal
    verbatim in HELP lines, unlike in label values)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    # total over floats: a NaN/Inf landing in a metric must render as
    # Prometheus spells them, not raise and kill every future scrape
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    def __init__(self, name: str, help_: str, kind: str, lock):
        self.name = name
        self.help = help_
        self.kind = kind
        self._lock = lock


class Counter(_Metric):
    def __init__(self, name, help_, lock):
        super().__init__(name, help_, "counter", lock)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labelkey(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_labelkey(labels), 0.0)

    def _render(self) -> List[str]:
        # lock held per metric: a scrape racing a first-seen-label inc
        # must not observe the dict mid-insert
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}"
                for k, v in items]


class Gauge(_Metric):
    def __init__(self, name, help_, lock):
        super().__init__(name, help_, "gauge", lock)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_labelkey(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labelkey(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_all(self, rows) -> None:
        """Atomically REPLACE every label row with ``rows`` (iterable of
        ``(labels_dict, value)``) — for gauges re-sampled from live
        state at scrape time (per-model queue depth): rows for unloaded
        models disappear, and a concurrent scrape sees the old or the
        new complete set, never a half-cleared one."""
        new = {_labelkey(lb): float(v) for lb, v in rows}
        with self._lock:
            self._values = new

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_labelkey(labels), 0.0)

    def _render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}"
                for k, v in items]


class Histogram(_Metric):
    def __init__(self, name, help_, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, "histogram", lock)
        self.buckets = tuple(sorted(buckets))
        # labelkey -> [per-bucket counts..., +Inf count, sum]
        self._values: Dict[LabelKey, List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = _labelkey(labels)
        with self._lock:
            row = self._values.get(key)
            if row is None:
                row = self._values[key] = [0.0] * (len(self.buckets) + 2)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    row[i] += 1
            row[-2] += 1            # +Inf / total count
            row[-1] += value        # sum

    def count(self, **labels) -> float:
        with self._lock:
            row = self._values.get(_labelkey(labels))
            return row[-2] if row else 0.0

    def sum(self, **labels) -> float:
        with self._lock:
            row = self._values.get(_labelkey(labels))
            return row[-1] if row else 0.0

    def _render(self) -> List[str]:
        out: List[str] = []
        with self._lock:
            # rows snapshot: an observe() racing the scrape must not
            # mutate a row (or insert a label key) mid-iteration
            items = [(k, list(row))
                     for k, row in sorted(self._values.items())]
        for k, row in items:
            for i, b in enumerate(self.buckets):
                out.append(f"{self.name}_bucket"
                           f"{_fmt_labels(k, [('le', _fmt_value(b))])}"
                           f" {_fmt_value(row[i])}")
            out.append(f"{self.name}_bucket"
                       f"{_fmt_labels(k, [('le', '+Inf')])}"
                       f" {_fmt_value(row[-2])}")
            out.append(f"{self.name}_sum{_fmt_labels(k)} "
                       f"{_fmt_value(row[-1])}")
            out.append(f"{self.name}_count{_fmt_labels(k)} "
                       f"{_fmt_value(row[-2])}")
        return out


class MetricsRegistry:
    """Named metrics, rendered in creation order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, name: str, kind: str, factory) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, "counter",
                         lambda: Counter(name, help_, self._lock))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, "gauge",
                         lambda: Gauge(name, help_, self._lock))

    def histogram(self, name: str, help_: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """``buckets=None`` means "don't care" (DEFAULT_BUCKETS on first
        creation); explicitly passed buckets must MATCH an existing
        registration — silently dropping a mismatched bucket set would
        land observations on wrong boundaries."""
        m = self._get(name, "histogram",
                      lambda: Histogram(name, help_, self._lock,
                                        buckets or DEFAULT_BUCKETS))
        if buckets is not None and tuple(sorted(buckets)) != m.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{m.buckets}, requested {tuple(sorted(buckets))}")
        return m

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m._render())
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every metric (tests)."""
        with self._lock:
            self._metrics.clear()


#: process-wide default registry (what ``/metrics`` serves)
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
