"""Span/counter event recorder — the host-side half of the telemetry
layer.

The port of ``flexflow_tpu/obs/events.py``. The device-side half is
``torch.profiler`` via ``utils/profiling.profile_region``; the two
compose — a ``span`` brackets host phases, the profiler's trace shows
what the card did inside it. PyTorch runs eagerly: a span times the
host's enqueue of the work inside it, not the device's execution,
unless the code inside synchronizes (``FF_TRACE_SYNC=1`` makes the
executor's step spans do so).

Design constraints:

  - **near-zero cost when disabled**: every public entry point is one
    module-global flag check; ``span`` is a ``__slots__`` class-based
    context manager (no generator machinery), so a disabled span costs
    two attribute reads and a branch;
  - **thread-safe**: the executor and serving record concurrently
    (one lock around the ring + counters; the enabled check is a benign
    race — an event straddling enable/disable may be dropped, never
    corrupted);
  - **bounded**: completed spans land in a ring buffer of ``capacity``
    events — the newest N survive, wraparound drops the oldest (a
    long-running server cannot grow without bound).

Enabling: ``FF_TRACE=1`` in the environment (read at import), or
``FFConfig.trace = "true"`` (applied by ``FFModel.compile`` via
:func:`configure`), or :func:`enable` directly.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 65536

_lock = threading.Lock()
_enabled = False
_capacity = DEFAULT_CAPACITY
_ring: List[Dict[str, Any]] = []
_head = 0                         # index of the OLDEST event once full
_dropped = 0                      # events overwritten by wraparound
_counters: Dict[str, float] = {}


def _env_on(val: Optional[str]) -> bool:
    return (val or "").lower() in ("1", "true", "yes", "on")


def enabled() -> bool:
    """Fast global check — the only cost telemetry pays when off."""
    # benign race by design (module docstring): a single-flag read with
    # no invariant tied to other state; locking here would put a lock
    # on every op_cost call of the search
    return _enabled  # ffcheck: ok(guarded-field)


def enable(capacity: Optional[int] = None) -> None:
    global _enabled, _capacity
    with _lock:
        if capacity is not None and capacity > 0 \
                and capacity != _capacity:
            _capacity = capacity
            _reset_locked()
        _enabled = True


def disable() -> None:
    global _enabled
    with _lock:
        _enabled = False


def _reset_locked() -> None:
    global _head, _dropped
    _ring.clear()
    _head = 0
    _dropped = 0
    _counters.clear()


def clear() -> None:
    """Drop every recorded event and counter (capacity/enabled kept)."""
    with _lock:
        _reset_locked()


def attribution_enabled(cfg=None) -> bool:
    """The JAX package's opt-in rule for step-time attribution: config
    "true"/"false" wins; "auto" (and no config at all) honors the
    FF_ATTRIB env var."""
    mode = str(getattr(cfg, "attribution", "auto") or "auto").lower()
    if mode in ("true", "on", "1", "yes"):
        return True
    if mode in ("false", "off", "0", "no"):
        return False
    return _env_on(os.environ.get("FF_ATTRIB"))


def refuse_attribution(cfg=None) -> None:
    """Raise where step-time attribution is asked for: its harness
    (``obs/attribution.py``) is not ported yet (ROADMAP queue 1, item 6,
    with serving's telemetry)."""
    if attribution_enabled(cfg):
        raise NotImplementedError(
            "step-time attribution (FF_ATTRIB / FFConfig.attribution) is "
            "not ported yet: obs/attribution.py comes with ROADMAP queue "
            "1, item 6; unset FF_ATTRIB or set attribution='false'")


def configure(cfg) -> None:
    """Apply an ``FFConfig``: ``trace`` "true"/"false" forces the
    PROCESS-WIDE recorder state — there is one recorder per process, so
    compiling a model with ``trace="false"`` switches tracing off for
    everything else in the process too (that is what ``--no-trace``
    means; use the default "auto" to leave other models' tracing alone);
    "auto" (the default) leaves the FF_TRACE / explicit-enable decision
    untouched — except that a non-empty ``trace_export_file`` implies
    tracing (requesting an export of an empty trace is never what the
    caller meant; the ``--trace-export`` flag applies the same rule).
    An attribution request (``FF_ATTRIB`` / ``FFConfig.attribution``)
    raises :class:`NotImplementedError`: see :func:`refuse_attribution`."""
    refuse_attribution(cfg)
    mode = str(getattr(cfg, "trace", "auto") or "auto").lower()
    if mode in ("false", "off", "0", "no"):
        disable()
        return
    if _env_on(mode) or mode == "true" \
            or getattr(cfg, "trace_export_file", ""):
        enable()


def counter(name: str, n: float = 1) -> None:
    """Increment a named counter (no-op when disabled)."""
    # benign race: disabled fast path (see enabled())
    if not _enabled:  # ffcheck: ok(guarded-field)
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


_drop_counter = None


def _count_drop() -> None:
    """Mirror ring-wraparound drops into the always-on Prometheus
    registry (``ff_trace_events_dropped_total``): overflow used to be
    silent — invisible unless someone compared ``dropped()`` by hand.
    Only runs when an event is actually overwritten, so the disabled
    path and the non-full ring pay nothing."""
    global _drop_counter
    if _drop_counter is None:
        from .metrics_registry import REGISTRY
        _drop_counter = REGISTRY.counter(
            "ff_trace_events_dropped_total",
            "Trace events lost to ring-buffer wraparound")
    _drop_counter.inc()


def _record(ev: Dict[str, Any]) -> None:
    global _head, _dropped
    with _lock:
        if len(_ring) < _capacity:
            _ring.append(ev)
        else:
            _ring[_head] = ev
            _head = (_head + 1) % _capacity
            _dropped += 1
            _count_drop()


def record_span(name: str, t0: float, dur: float, **attrs) -> None:
    """Record one completed span explicitly (``t0`` from
    ``time.perf_counter()``). Used where a ``with`` block would force
    reindenting a long phase — e.g. ``FFModel.compile``."""
    # benign race: disabled fast path (see enabled())
    if not _enabled:  # ffcheck: ok(guarded-field)
        return
    _record({"name": name, "kind": "span", "ts": t0, "dur": dur,
             "tid": threading.get_ident(),
             "attrs": attrs or None})


def instant(name: str, **attrs) -> None:
    """Record a point-in-time event (e.g. a recompile trigger)."""
    # benign race: disabled fast path (see enabled())
    if not _enabled:  # ffcheck: ok(guarded-field)
        return
    _record({"name": name, "kind": "instant",
             "ts": time.perf_counter(), "dur": 0.0,
             "tid": threading.get_ident(),
             "attrs": attrs or None})


class span:
    """``with span("unity.dp", depth=2): ...`` — records one completed
    span on exit. Nesting is recovered from timing containment (the
    Chrome trace viewer does this natively for same-thread 'X' events).
    Disabled cost: one flag check on enter and one on exit."""

    __slots__ = ("name", "attrs", "_t0")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "span":
        # benign race: disabled fast path (see enabled())
        self._t0 = time.perf_counter() if _enabled else None  # ffcheck: ok(guarded-field)
        return self

    def set(self, **attrs) -> "span":
        """Attach attributes discovered mid-span (e.g. the batch size a
        request was assembled into, known only after the body ran)."""
        self.attrs.update(attrs)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t0 = self._t0
        # benign race: a span straddling enable/disable may be dropped,
        # never corrupted (module docstring)
        if t0 is not None and _enabled:  # ffcheck: ok(guarded-field)
            record_span(self.name, t0, time.perf_counter() - t0,
                        **self.attrs)
        return False


def events() -> List[Dict[str, Any]]:
    """Snapshot of recorded events, oldest first."""
    with _lock:
        return _ring[_head:] + _ring[:_head]


def dropped() -> int:
    """Events lost to ring wraparound since the last clear()."""
    with _lock:
        return _dropped


def snapshot(max_events: Optional[int] = None) -> Dict[str, Any]:
    """One consistent view of the recorder — events (newest
    ``max_events`` when bounded), counters, and the drop count — for
    the per-rank trace dumps and the flight recorder."""
    with _lock:
        evts = _ring[_head:] + _ring[:_head]
        ctrs = dict(_counters)
        drops = _dropped
    if max_events is not None and max_events >= 0:
        # NOT evts[-max_events:]: a 0 bound means "no spans", while
        # [-0:] would return the ENTIRE ring
        evts = evts[-max_events:] if max_events else []
    return {"events": evts, "counters": ctrs, "dropped": drops}


# FF_TRACE honored at import so serving entry points (which never see an
# FFConfig) are covered too
if _env_on(os.environ.get("FF_TRACE")):
    _enabled = True
