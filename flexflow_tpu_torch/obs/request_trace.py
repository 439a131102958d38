"""Per-request lifecycle tracing for the serving path.

The port of ``flexflow_tpu/obs/request_trace.py``, unchanged (plain
Python). ``FFModel.generate`` tags its prefill and decode spans with
:func:`current_id`; the HTTP fronts that start traces come with the
serving port.

Every serving request gets a trace id — propagated from the
``x-ff-trace-id`` HTTP header when the client supplies one, generated
otherwise — and each lifecycle stage (admission, queue wait, batch
assembly, prefill, per-segment decode, response) is emitted as a span in
the ``obs.events`` ring carrying a ``trace=<id>`` attribute.  Spans from
different scheduler threads thus link into one logical request in the
Chrome trace (``obs.trace_export`` emits flow events between them), and
the response span records the request's terminal outcome:

    ok | expired | deadline-rejected | breaker | rejected |
    invalid | failed

Cost discipline matches ``obs.events``: when tracing is disabled
(``FF_TRACE`` unset) ``start()``/``from_headers()`` return ``None`` and
every call site is a single ``is None`` check — no ids are generated,
no spans recorded.

The *ambient* trace (``activate``/``current``) is a thread-local: the
HTTP front activates the request's trace for the duration of the route
handler so deep layers (``model._generate_kv``'s prefill/decode spans,
``serving.session``'s segmented decode) can tag their spans with the
trace id without threading a handle through every signature.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, Optional

from . import events as obs_events

__all__ = ["TRACE_HEADER", "RequestTrace", "start", "from_headers",
           "new_trace_id", "activate", "current", "current_id"]

#: request/response header carrying the trace id (lowercase: both HTTP
#: fronts normalize header names before routing)
TRACE_HEADER = "x-ff-trace-id"

#: terminal outcomes a request.response span may carry
OUTCOMES = ("ok", "expired", "deadline-rejected", "breaker", "rejected",
            "invalid", "failed")

_local = threading.local()


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class RequestTrace:
    """Handle for one request's linked span chain.

    ``stage()`` records an intermediate lifecycle span; ``finish()``
    records the terminal ``request.response`` span exactly once — the
    first caller's outcome wins, so the scheduler's precise verdict
    (set before the waiter wakes) beats the HTTP layer's coarse
    status-code mapping.
    """

    __slots__ = ("trace_id", "model", "t0", "_finished")

    def __init__(self, trace_id: str, model: str = ""):
        self.trace_id = trace_id
        self.model = model
        self.t0 = time.perf_counter()
        # one-shot latch; written without a lock: finishers are ordered
        # by the request event (scheduler sets outcome before event.set,
        # the HTTP thread finishes after event.wait returns) and a
        # double-record on a true race is a duplicate span, not
        # corruption
        self._finished = False

    def stage(self, name: str, t0: float, dur: Optional[float] = None,
              **attrs) -> None:
        """Record lifecycle span ``request.<name>`` for this trace."""
        if dur is None:
            dur = time.perf_counter() - t0
        obs_events.record_span("request." + name, t0, dur,
                               trace=self.trace_id, model=self.model,
                               **attrs)

    def finish(self, outcome: str, t0: Optional[float] = None,
               **attrs) -> None:
        """Record the terminal response span (idempotent)."""
        if self._finished:
            return
        self._finished = True
        start_ = self.t0 if t0 is None else t0
        obs_events.record_span("request.response", start_,
                               time.perf_counter() - start_,
                               trace=self.trace_id, model=self.model,
                               outcome=outcome, **attrs)

    def __repr__(self) -> str:
        return f"RequestTrace({self.trace_id!r}, model={self.model!r})"


def start(model: str = "",
          trace_id: Optional[str] = None) -> Optional[RequestTrace]:
    """New trace handle, or ``None`` when tracing is disabled."""
    if not obs_events.enabled():
        return None
    return RequestTrace(trace_id or new_trace_id(), model)


def from_headers(headers: Optional[Dict[str, str]],
                 model: str = "") -> Optional[RequestTrace]:
    """Trace handle honoring a client-supplied ``x-ff-trace-id``.

    ``headers`` keys must already be lowercased (both HTTP fronts
    normalize before routing).  A blank/absent header generates an id.
    """
    if not obs_events.enabled():
        return None
    tid = (headers or {}).get(TRACE_HEADER, "").strip()
    # bound the id: a hostile client must not bloat every span's attrs
    if tid and len(tid) > 64:
        tid = tid[:64]
    return RequestTrace(tid or new_trace_id(), model)


class activate:
    """Context manager installing ``trace`` as the thread's ambient
    trace for the duration (``trace=None`` is a no-op, so call sites
    don't branch on the disabled path)."""

    __slots__ = ("_trace", "_prev")

    def __init__(self, trace: Optional[RequestTrace]):
        self._trace = trace
        self._prev = None

    def __enter__(self):
        if self._trace is not None:
            self._prev = getattr(_local, "trace", None)
            _local.trace = self._trace
        return self._trace

    def __exit__(self, *exc):
        if self._trace is not None:
            _local.trace = self._prev
        return False


def current() -> Optional[RequestTrace]:
    """The thread's ambient trace (``None`` outside ``activate``)."""
    return getattr(_local, "trace", None)


def current_id() -> Optional[str]:
    """Ambient trace id, for tagging spans recorded by deep layers."""
    t = getattr(_local, "trace", None)
    return t.trace_id if t is not None else None
