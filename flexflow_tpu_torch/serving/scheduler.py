"""Dynamic micro-batching for inference requests.

The port of ``flexflow_tpu/serving/scheduler.py`` (plain Python and
numpy; the device batch is one ``InferenceSession.infer`` call). Triton's
dynamic batcher (``preferred_batch_size`` +
``max_queue_delay_microseconds``): requests queue up; per-instance
workers drain up to ``max_batch`` of them (or whatever arrived within
``max_delay_ms``), stack them on the host into one device batch, and fan
the result back out per request.

Triton-scope hardening (reference ``triton/src/instance.cc``,
``backend.cc``):
  - **bounded queue + backpressure**: the queue holds at most
    ``max_queue`` requests; beyond that ``infer`` raises
    :class:`QueueFullError` (HTTP 503) instead of growing without bound;
  - **request deadlines**: every request may carry a deadline
    (``x-ff-timeout-ms`` header or the scheduler default); a request
    whose deadline passes while queued — or whose client timed out and
    abandoned it — is failed at dequeue time and NEVER consumes a
    device step;
  - **admission control**: when the estimated queue wait (EWMA of
    recent batch latency x backlog) already exceeds a request's
    deadline, ``infer`` fast-fails with :class:`DeadlineRejectedError`
    (HTTP 503 + ``Retry-After``) instead of queueing doomed work;
  - **circuit breaker**: K consecutive session failures open the
    per-model circuit — requests fast-fail 503 until a cooldown
    elapses, then ONE half-open probe is admitted; its success closes
    the circuit, its failure re-opens it (Triton's model-health
    isolation);
  - **batch-poison isolation**: inputs are validated against the
    session signature at admission (:class:`InvalidInputError`, HTTP
    400, for the malformed request only); if a batch execution still
    fails, each member is retried individually once so good co-batched
    requests succeed anyway;
  - **graceful drain**: :meth:`BatchScheduler.drain` stops admitting
    (:class:`DrainingError`, HTTP 503 + ``Retry-After``), finishes
    everything in flight within a drain deadline, then closes;
  - **N concurrent instances**: one worker thread per model instance
    (Triton's ``instance_group { count: N }``), all draining the shared
    queue;
  - **metrics**: per-model counters + streaming quantile sketches
    (``obs.sketch``) feeding the ``/v2/metrics`` endpoint
    (p50/p90/p99/p99.9 overall and per batch bucket, queue depth, batch
    sizes), plus expired / deadline-rejected / breaker-open / SLO-
    violation counters and the circuit state in the Prometheus registry;
  - **request lifecycle tracing**: when ``obs.events`` is enabled each
    request carries a :class:`~..obs.request_trace.RequestTrace` through
    admission -> queue -> batch -> response, every stage a linked span
    tagged with the trace id, batch bucket, and terminal outcome.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import request_trace
from ..obs.metrics_registry import DEFAULT_BUCKETS, REGISTRY
from ..obs.sketch import QuantileSketch

#: request-latency histogram buckets (seconds): the registry default
#: extended upward for slow generate calls
LATENCY_BUCKETS = DEFAULT_BUCKETS + (30.0,)

#: numeric encoding of circuit states for the ``ff_circuit_state`` gauge
CIRCUIT_STATE_NUM = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


class RequestRejected(RuntimeError):
    """Base of all load-shedding rejections (HTTP 503).

    ``retry_after_s`` is the server's estimate of when retrying could
    succeed — surfaced to HTTP clients as the ``Retry-After`` header."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class QueueFullError(RequestRejected):
    """Raised by ``infer`` when the bounded request queue is full —
    callers should shed load (HTTP 503)."""


class DeadlineRejectedError(RequestRejected):
    """Admission control: the estimated queue wait already exceeds the
    request's deadline, so queueing it would only waste a device step
    (HTTP 503 + ``Retry-After``)."""


class CircuitOpenError(RequestRejected):
    """The per-model circuit breaker is open after repeated session
    failures; requests fast-fail until the cooldown's half-open probe
    succeeds (HTTP 503 + ``Retry-After``)."""


class DrainingError(RequestRejected):
    """The scheduler is draining for shutdown and admits no new work
    (HTTP 503 + ``Retry-After``)."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before a result was produced —
    either while queued (the request never reached a device step) or
    while the client was waiting (HTTP 504)."""


class InvalidInputError(ValueError):
    """Request inputs do not match the session signature (missing or
    unknown names, wrong feature shape/dtype, ragged rows) — a client
    error for THIS request only (HTTP 400), caught at admission so it
    can never poison a co-batched device step."""


class CircuitBreaker:
    """Per-model circuit breaker (Triton model-health isolation analog).

    closed --(K consecutive session failures)--> open --(cooldown
    elapses)--> half_open: ONE probe request is admitted; its success
    closes the circuit, its failure re-opens it. ``allow()`` is the
    admission gate; request outcomes feed back via
    ``on_success``/``on_failure``. Thread-safe."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 5.0,
                 on_open=None):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._on_open = on_open
        self._lock = threading.Lock()
        self.state = "closed"
        self.opens = 0
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    def allow(self) -> Tuple[bool, float, bool]:
        """Admission gate: ``(admitted, retry_after_s, is_probe)``.
        ``is_probe`` marks the single half-open probe admission; its
        holder MUST end in on_success/on_failure — or release_probe if
        it dies before reaching the session — or the slot would wedge
        the model in half-open forever."""
        with self._lock:
            if self.state == "closed":
                return True, 0.0, False
            if self.state == "open":
                remaining = (self._opened_at + self.cooldown_s
                             - time.perf_counter())
                if remaining > 0:
                    return False, remaining, False
                self.state = "half_open"
                self._probe_inflight = False
            # half_open: admit exactly one probe at a time
            if self._probe_inflight:
                return False, self.cooldown_s, False
            self._probe_inflight = True
            return True, 0.0, True

    def release_probe(self) -> None:
        """Give the half-open probe slot back: the admitted probe was
        shed before execution (queue full, admission rejection) or
        expired in the queue, so its outcome says nothing about model
        health — let the next request probe instead."""
        with self._lock:
            if self.state == "half_open":
                self._probe_inflight = False

    def on_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self.state == "half_open":
                self.state = "closed"
                self._probe_inflight = False

    def on_failure(self) -> None:
        opened = False
        with self._lock:
            self._failures += 1
            if self.state == "half_open" or (
                    self.state == "closed"
                    and self._failures >= self.threshold):
                self.state = "open"
                self._opened_at = time.perf_counter()
                self._failures = 0
                self._probe_inflight = False
                self.opens += 1
                opened = True
        if opened and self._on_open is not None:
            self._on_open()


class SchedulerMetrics:
    """Thread-safe counters + streaming latency quantiles for one
    scheduler.

    Latency lands in mergeable :class:`~..obs.sketch.QuantileSketch`
    instances — one overall, one per batch bucket — instead of the old
    bounded reservoir: memory stays fixed no matter how many requests
    flow through, quantile error is a bounded *relative* 1%, and
    per-bucket sketches merge exactly into fleet aggregates.

    Doubles as the bridge into the process-wide Prometheus registry
    (``obs/metrics_registry.py``): every completion lands in the
    ``ff_request_latency_seconds`` histogram and the per-model request
    counters, labeled by model name — what ``GET /metrics`` serves.
    Deadline violations additionally feed the SLO burn-rate counter
    ``ff_slo_violations_total{model,bucket}`` (completed-late, expired
    with a deadline, and deadline-rejected requests all count; failures
    without a deadline breach do not — they burn the error budget via
    ``ff_requests_failed_total`` instead).

    Counter semantics (disjoint: every admitted-or-rejected request
    lands in exactly one of completed/failed/expired/rejected/
    deadline_rejected):
      - ``rejected``: shed at admission (queue full, circuit open,
        draining);
      - ``deadline_rejected``: shed at admission because the estimated
        queue wait exceeded the request deadline;
      - ``expired``: admitted but the client never got a result and no
        device step was spent ON ITS BEHALF (deadline passed or client
        abandoned at dequeue time, swept at close/unload, or dropped
        from a failed batch's individual-retry pass because the client
        was already gone — that last case rode a failed batch attempt,
        but got no step of its own);
      - ``failed``: executed (or retried) and errored;
      - ``completed``: executed successfully."""

    #: quantiles exposed on /healthz, /v2/metrics, and the
    #: ``ff_request_latency_quantile`` gauge
    QUANTILES = ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"),
                 (0.999, "p99.9"))

    def __init__(self, window: int = 2048, name: str = ""):
        # ``window`` is legacy (the old reservoir size) — kept in the
        # signature for callers; the sketches are memory-bounded by
        # construction
        del window
        self._lock = threading.Lock()
        self.name = name or "default"
        self.requests = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.expired = 0
        self.deadline_rejected = 0
        self.breaker_opens = 0
        self.slo_violations = 0
        self.batches = 0
        self.batched_rows = 0
        # device calls of the batch-poison retry pass (one per member
        # retried alone): with ``batches`` they count every forward the
        # workers ran
        self.individual_retries = 0
        self._sketch = QuantileSketch()
        self._sketch_by_bucket: Dict[str, QuantileSketch] = {}
        # registry handles resolved ONCE — the hot path below must not
        # take the registry lock for a name lookup per request
        self._m_requests = REGISTRY.counter(
            "ff_requests_total",
            "Inference requests accepted into the queue")
        self._m_rejected = REGISTRY.counter(
            "ff_requests_rejected_total",
            "Requests shed at admission (queue full, circuit open, "
            "draining)")
        self._m_failed = REGISTRY.counter(
            "ff_requests_failed_total",
            "Requests completed with an error")
        self._m_expired = REGISTRY.counter(
            "ff_requests_expired_total",
            "Requests whose deadline passed (or whose client abandoned "
            "them) before producing a result — failed at dequeue, swept "
            "at close/unload, or skipped in a failed batch's retry pass; "
            "no device step was spent on their behalf alone")
        self._m_deadline_rejected = REGISTRY.counter(
            "ff_requests_deadline_rejected_total",
            "Requests shed at admission: estimated queue wait exceeded "
            "the request deadline")
        self._m_breaker_opens = REGISTRY.counter(
            "ff_breaker_opens_total",
            "Circuit-breaker open transitions (consecutive session "
            "failures reached the threshold)")
        self._m_latency = REGISTRY.histogram(
            "ff_request_latency_seconds",
            "End-to-end request latency (queue + batch assembly + "
            "device step)", buckets=LATENCY_BUCKETS)
        self._m_slo = REGISTRY.counter(
            "ff_slo_violations_total",
            "Requests that violated their deadline SLO, by model and "
            "batch bucket: completed past the deadline, expired in the "
            "queue with a deadline set, or deadline-rejected at "
            "admission")

    def record_submitted(self):
        with self._lock:
            self.requests += 1
        self._m_requests.inc(model=self.name)

    def record_rejected(self):
        with self._lock:
            self.rejected += 1
        self._m_rejected.inc(model=self.name)

    def record_deadline_rejected(self, bucket: Optional[str] = None):
        # always an SLO violation: the request carried a deadline the
        # server declined to attempt
        with self._lock:
            self.deadline_rejected += 1
            self.slo_violations += 1
        self._m_deadline_rejected.inc(model=self.name)
        self._m_slo.inc(model=self.name, bucket=bucket or "all")

    def record_expired(self, bucket: Optional[str] = None,
                       deadline_missed: bool = False):
        with self._lock:
            self.expired += 1
            if deadline_missed:
                self.slo_violations += 1
        self._m_expired.inc(model=self.name)
        if deadline_missed:
            self._m_slo.inc(model=self.name, bucket=bucket or "all")

    def record_slo(self, bucket: Optional[str] = None):
        """SLO accounting for the direct (non-scheduler) verb paths:
        a deadline-carrying ``generate`` that completed past its
        deadline is a violation even though the scheduler never saw
        it. Counting it HERE is what lets a fleet router dedupe — the
        replica that carried the remaining deadline owns the count,
        the fleet layer only counts requests no replica attempted."""
        with self._lock:
            self.slo_violations += 1
        self._m_slo.inc(model=self.name, bucket=bucket or "all")

    def record_breaker_open(self):
        with self._lock:
            self.breaker_opens += 1
        self._m_breaker_opens.inc(model=self.name)

    def record_done(self, latency_s: float, ok: bool,
                    bucket: Optional[str] = None,
                    deadline_missed: bool = False):
        with self._lock:
            self.completed += ok
            self.failed += (not ok)
            self._sketch.add(latency_s)
            if bucket is not None:
                sk = self._sketch_by_bucket.get(bucket)
                if sk is None:
                    sk = self._sketch_by_bucket[bucket] = QuantileSketch()
                sk.add(latency_s)
            if deadline_missed:
                self.slo_violations += 1
        self._m_latency.observe(latency_s, model=self.name)
        if deadline_missed:
            self._m_slo.inc(model=self.name, bucket=bucket or "all")
        if not ok:
            self._m_failed.inc(model=self.name)

    @classmethod
    def _quantiles_ms(cls, sk: QuantileSketch) -> Dict:
        """One sketch's quantile row (ms, rounded) for JSON surfaces."""
        if not sk.count:
            return {"count": 0}
        out: Dict = {"count": sk.count}
        for q, label in cls.QUANTILES:
            out[label] = round(sk.quantile(q) * 1e3, 3)
        return out

    def latency_quantiles(self) -> Dict:
        """p50/p90/p99/p99.9 (ms) overall and per batch bucket — the
        ``/healthz`` latency block and the ``/v2/metrics`` detail."""
        with self._lock:
            out = {"all": self._quantiles_ms(self._sketch)}
            for b in sorted(self._sketch_by_bucket):
                out[b] = self._quantiles_ms(self._sketch_by_bucket[b])
        return out

    def quantile_rows(self) -> List[Tuple[Dict, float]]:
        """``(labels, seconds)`` rows for the
        ``ff_request_latency_quantile`` gauge — sampled at scrape time
        by ``render_prometheus`` (set_all semantics: rows for unloaded
        models disappear with their scheduler)."""
        rows: List[Tuple[Dict, float]] = []
        with self._lock:
            sketches = [("all", self._sketch)] \
                + sorted(self._sketch_by_bucket.items())
            for b, sk in sketches:
                if not sk.count:
                    continue
                for q, _ in self.QUANTILES:
                    rows.append(({"model": self.name, "bucket": b,
                                  "quantile": str(q)}, sk.quantile(q)))
        return rows

    def slo_total(self) -> int:
        """Cheap read of the SLO-violation count — the ``/healthz``
        field the fleet autoscaler differentiates per poll."""
        with self._lock:
            return self.slo_violations

    def sketch_docs(self) -> Dict[str, Dict]:
        """Serialized latency sketches (``QuantileSketch.to_dict``),
        overall + per batch bucket — the ``/v2/metrics`` field a fleet
        front scrapes and ``merge``s so fleet quantiles are computed
        over the union stream, not averaged per replica (averaging
        percentiles is the classic observability bug)."""
        with self._lock:
            out = {"all": self._sketch.to_dict()}
            for b, sk in sorted(self._sketch_by_bucket.items()):
                out[b] = sk.to_dict()
        return out

    def snapshot(self, queue_depth: int) -> Dict:
        with self._lock:
            sk = self._sketch
            # empty sketch reports 0.0 (NaN would poison JSON surfaces
            # and the pre-traffic /healthz probe)
            q = {label: (sk.quantile(p) if sk.count else 0.0)
                 for p, label in self.QUANTILES}
            by_bucket = {
                b: self._quantiles_ms(s)
                for b, s in sorted(self._sketch_by_bucket.items())}
            return {
                "requests": self.requests,
                "completed": self.completed,
                "failed": self.failed,
                "rejected": self.rejected,
                "expired": self.expired,
                "deadline_rejected": self.deadline_rejected,
                "breaker_opens": self.breaker_opens,
                "slo_violations": self.slo_violations,
                "batches": self.batches,
                "individual_retries": self.individual_retries,
                "mean_batch_rows": (self.batched_rows
                                    / max(self.batches, 1)),
                "queue_depth": queue_depth,
                "latency_p50_ms": round(q["p50"] * 1e3, 3),
                "latency_p90_ms": round(q["p90"] * 1e3, 3),
                "latency_p99_ms": round(q["p99"] * 1e3, 3),
                "latency_p999_ms": round(q["p99.9"] * 1e3, 3),
                "latency_by_bucket_ms": by_bucket,
            }


class _Request:
    __slots__ = ("inputs", "rows", "deadline", "abandoned", "probe",
                 "event", "result", "error", "t0", "trace", "bucket")

    def __init__(self, inputs, rows: int = 0,
                 deadline: Optional[float] = None, probe: bool = False,
                 trace=None, bucket: Optional[str] = None):
        self.inputs = inputs
        self.rows = rows or int(next(iter(inputs.values())).shape[0])
        self.deadline = deadline      # absolute perf_counter time
        self.abandoned = False        # client gave up waiting
        self.probe = probe            # holds the half-open probe slot
        self.trace = trace            # RequestTrace or None (disabled)
        self.bucket = bucket          # batch-bucket label for metrics
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        self.t0 = time.perf_counter()


class BatchScheduler:
    """Bounded queue + N instance workers around
    :class:`InferenceSession` replicas.

    ``sessions`` may be one session or a list (one per concurrent
    instance — Triton's instance group); each gets its own worker
    thread draining the shared queue.

    ``default_deadline_ms`` applies to requests that carry no explicit
    deadline; ``breaker_threshold``/``breaker_cooldown_s`` configure
    the per-model circuit breaker; ``est_batch_latency_s`` seeds the
    admission-control EWMA before the first measured batch (cold-start
    estimates and tests).

    ``admission_estimate`` picks what the deadline gate compares:
    ``"wait"`` (default) sheds when the estimated QUEUE wait exceeds
    the deadline; ``"completion"`` adds one batch's service EWMA on
    top — a request whose queue wait just fits but whose own service
    time predictably lands past the deadline is shed at the door
    instead of burning a device step on a guaranteed SLO violation.
    Replicas under a deadline-routing fleet front run ``"completion"``
    (see ``fleet/replica.py``)."""

    def __init__(self, sessions, max_batch: int = 64,
                 max_delay_ms: float = 2.0, max_queue: int = 256,
                 name: str = "", default_deadline_ms: Optional[float] = None,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 5.0,
                 est_batch_latency_s: Optional[float] = None,
                 admission_estimate: str = "wait"):
        if admission_estimate not in ("wait", "completion"):
            raise ValueError(
                f"admission_estimate must be 'wait' or 'completion', "
                f"got {admission_estimate!r}")
        self.admission_estimate = admission_estimate
        if not isinstance(sessions, (list, tuple)):
            sessions = [sessions]
        if not sessions:
            raise ValueError("need at least one session instance")
        self.sessions: List = list(sessions)
        self.session = self.sessions[0]    # back-compat alias
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self.default_deadline_ms = default_deadline_ms
        self.metrics = SchedulerMetrics(name=name)
        self.breaker = CircuitBreaker(
            breaker_threshold, breaker_cooldown_s,
            on_open=self.metrics.record_breaker_open)
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._draining = False
        # admission-control state: EWMA of measured batch latency plus
        # the current backlog (queued + executing rows), under one lock
        self._stat_lock = threading.Lock()
        self._ewma_batch_s = (float(est_batch_latency_s)
                              if est_batch_latency_s is not None
                              else None)
        self._queued_rows = 0
        self._active_rows = 0
        self._active = 0              # requests popped but not finished
        # admitted but not yet resolved (queued, in a worker's hand
        # between pop and the _active bump, or executing): drain()'s
        # idle check — _active alone has a pop-vs-bump TOCTOU window
        # in which a mid-execution request looks idle
        self._pending = 0
        self._workers = [
            threading.Thread(target=self._run, args=(s,), daemon=True)
            for s in self.sessions]
        for w in self._workers:
            w.start()

    @property
    def num_instances(self) -> int:
        return len(self.sessions)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _validate(self, inputs) -> Tuple[Dict[str, np.ndarray], int]:
        """Admission-time schema check against the session signature:
        missing names, ragged row counts, wrong feature shapes/dtypes
        raise :class:`InvalidInputError` (HTTP 400) for THIS request
        only, before it can poison a co-batched device step."""
        names = self.session.input_names
        missing = [n for n in names if n not in inputs]
        if missing:
            raise InvalidInputError(
                f"missing inputs: {missing} (expected {names})")
        unknown = [k for k in inputs if k not in names]
        if unknown:
            # a typo'd optional tensor silently dropped would return a
            # 200 computed without data the client thought it sent
            raise InvalidInputError(
                f"unknown inputs: {unknown} (expected {names})")
        sig = getattr(self.session, "input_signature", None) or {}
        arrs: Dict[str, np.ndarray] = {}
        rows = None
        for n in names:
            arr = np.asarray(inputs[n])
            if arr.ndim < 1:
                raise InvalidInputError(
                    f"input {n!r} must have a leading batch dimension")
            if rows is None:
                rows = int(arr.shape[0])
            elif int(arr.shape[0]) != rows:
                raise InvalidInputError(
                    f"ragged batch: {n!r} has {arr.shape[0]} rows, "
                    f"other inputs have {rows}")
            if n in sig:
                shape, dtype = sig[n]
                if tuple(arr.shape[1:]) != tuple(shape[1:]):
                    raise InvalidInputError(
                        f"input {n!r} feature shape {tuple(arr.shape[1:])}"
                        f" does not match the model's {tuple(shape[1:])}")
                if not np.can_cast(arr.dtype, dtype, casting="same_kind"):
                    raise InvalidInputError(
                        f"input {n!r} dtype {arr.dtype} is not "
                        f"compatible with the model's {dtype}")
                if arr.dtype != dtype:
                    # normalize compatible dtypes HERE so one request
                    # sending f64 cannot force a per-dtype recompile of
                    # the warm executable (and cannot poison a batch
                    # concat with a surprise promotion)
                    arr = arr.astype(dtype, copy=False)
            arrs[n] = arr
        if not rows:
            raise InvalidInputError("empty batch (0 rows)")
        return arrs, rows

    def estimated_wait_s(self) -> float:
        """Admission-control estimate: EWMA of recent batch latency x
        the backlog in batches, split across instances. 0.0 until a
        first batch has been measured (or a seed was given)."""
        with self._stat_lock:
            ewma = self._ewma_batch_s
            backlog = self._queued_rows + self._active_rows
        if ewma is None or backlog <= 0:
            return 0.0
        batches = backlog / float(max(1, self.max_batch))
        return ewma * batches / max(1, self.num_instances)

    def _bucket_label(self, rows: int) -> str:
        """Batch-bucket label for metrics/traces: the smallest serving
        bucket that fits ``rows`` (the padding target the session will
        actually run), or the raw row count for bucketless sessions
        (bounded: rows <= max_batch)."""
        session = self.session
        buckets = getattr(session, "buckets", None) \
            or getattr(session, "batch_buckets", None)
        if buckets:
            for b in sorted(buckets):
                if rows <= b:
                    return str(b)
            return str(sorted(buckets)[-1])
        return str(rows)

    def infer(self, inputs: Dict[str, np.ndarray],
              timeout: float = 30.0,
              deadline_ms: Optional[float] = None,
              trace=None) -> np.ndarray:
        """Blocking single-request API (each row batch is one request).

        ``deadline_ms`` (or the scheduler's ``default_deadline_ms``)
        bounds the request end-to-end: admission control fast-fails
        when the admission estimate (queue wait, plus one batch's
        service EWMA under ``admission_estimate="completion"``)
        already exceeds it
        (:class:`DeadlineRejectedError`), a queued request whose
        deadline passes is failed without a device step, and a timed-out
        wait marks the request abandoned so it cannot be batched later.
        Raises :class:`QueueFullError` / :class:`CircuitOpenError` /
        :class:`DrainingError` for the shedding cases (HTTP 503) and
        :class:`InvalidInputError` for malformed inputs (HTTP 400).

        ``trace`` is the request's lifecycle
        :class:`~..obs.request_trace.RequestTrace` (the HTTP fronts
        pass one carrying the client's ``x-ff-trace-id``); when tracing
        is enabled and none is given the scheduler starts its own, so
        direct API callers get linked spans too. Every terminal path
        records the outcome on the trace's response span."""
        if trace is None:
            trace = request_trace.start(model=self.metrics.name)
        with self._stat_lock:
            draining = self._draining
        if draining:
            self.metrics.record_rejected()
            if trace is not None:
                trace.finish("rejected", reason="draining")
            raise DrainingError(
                f"model {self.metrics.name!r} is draining for shutdown",
                retry_after_s=5.0)
        try:
            arrs, rows = self._validate(inputs)
        except InvalidInputError:
            if trace is not None:
                trace.finish("invalid")
            raise
        bucket = self._bucket_label(rows)
        admitted, retry_after, probe = self.breaker.allow()
        if not admitted:
            self.metrics.record_rejected()
            if trace is not None:
                trace.finish("breaker", bucket=bucket)
            raise CircuitOpenError(
                f"circuit open for model {self.metrics.name!r} after "
                f"repeated session failures; retry in {retry_after:.1f}s",
                retry_after_s=max(retry_after, 0.05))
        dl_ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        deadline = None
        if dl_ms is not None and dl_ms > 0:
            deadline = time.perf_counter() + dl_ms / 1e3
            est = self.estimated_wait_s()
            if self.admission_estimate == "completion":
                # shed on predicted COMPLETION, not queue entry: a
                # request admitted with the queue wait just under its
                # deadline still pays its own batch's service time and
                # would predictably complete late (burning a device
                # step the deadline turns into a 504/SLO violation)
                with self._stat_lock:
                    svc = self._ewma_batch_s or 0.0
                est += svc / max(1, self.num_instances)
            if est > dl_ms / 1e3:
                if probe:
                    # the probe dies before execution: its outcome says
                    # nothing about model health, so the slot must not
                    # stay held or half-open would wedge forever
                    self.breaker.release_probe()
                self.metrics.record_deadline_rejected(bucket=bucket)
                if trace is not None:
                    trace.finish("deadline-rejected", bucket=bucket,
                                 estimated_wait_ms=round(est * 1e3, 3))
                what = ("estimated completion"
                        if self.admission_estimate == "completion"
                        else "estimated queue wait")
                raise DeadlineRejectedError(
                    f"{what} {est * 1e3:.0f} ms exceeds "
                    f"the request deadline {dl_ms:.0f} ms",
                    retry_after_s=max(est - dl_ms / 1e3, 0.1))
        r = _Request(arrs, rows, deadline, probe=probe, trace=trace,
                     bucket=bucket)
        # count the rows BEFORE the put: a worker popping the request
        # immediately would otherwise decrement first and drive the
        # admission backlog transiently negative under load
        with self._stat_lock:
            self._queued_rows += rows
            self._pending += 1
        try:
            self._q.put_nowait(r)
        except queue.Full:
            with self._stat_lock:
                self._queued_rows -= rows
                self._pending -= 1
            if probe:
                self.breaker.release_probe()
            self.metrics.record_rejected()
            if trace is not None:
                trace.finish("rejected", reason="queue-full",
                             bucket=bucket)
            raise QueueFullError(
                f"request queue full ({self._q.maxsize}); retry later")
        self.metrics.record_submitted()
        if self._stop.is_set():
            # raced close(): its sweep may already have passed this
            # request, leaving it on a queue no worker reads — re-run
            # the sweep so the client fails promptly, not at timeout
            self._fail_queued()
        wait_s = timeout
        if deadline is not None:
            wait_s = min(timeout,
                         max(deadline - time.perf_counter(), 0.0))
        # a huge or inf timeout/deadline (API callers) must not
        # OverflowError out of Event.wait with the request enqueued —
        # the orphan would still consume a device step
        wait_s = min(wait_s, threading.TIMEOUT_MAX)
        if not r.event.wait(wait_s):
            # mark abandoned so the workers skip it at dequeue time —
            # a timed-out client must never consume a device step
            r.abandoned = True
            if deadline is not None \
                    and time.perf_counter() >= deadline:
                if trace is not None:
                    trace.finish("expired", r.t0, bucket=bucket,
                                 reason="deadline")
                raise DeadlineExceededError(
                    f"request deadline ({dl_ms:.0f} ms) exceeded")
            if trace is not None:
                trace.finish("expired", r.t0, bucket=bucket,
                             reason="client-timeout")
            raise TimeoutError("inference request timed out")
        if r.error is not None:
            raise r.error
        return r.result

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        """Scheduler snapshot + circuit/drain state (the per-model row
        of ``GET /v2/metrics`` and the ``/healthz`` serving block)."""
        s = self.metrics.snapshot(self._q.qsize())
        s["instances"] = self.num_instances
        # routing signal + mergeable sketches for a fleet front: wait
        # BEFORE _stat_lock below (estimated_wait_s acquires it; the
        # queue lock is not reentrant)
        s["estimated_wait_s"] = self.estimated_wait_s()
        s["sketches"] = self.metrics.sketch_docs()
        # benign: atomic read of the state string for a health probe —
        # /healthz must stay cheap and a probe racing a breaker
        # transition just reports the old state for one scrape
        s["circuit"] = self.breaker.state
        with self._stat_lock:
            s["draining"] = self._draining
        return s

    def drain(self, deadline_s: float = 10.0) -> bool:
        """Graceful drain: stop admitting (``infer`` raises
        :class:`DrainingError` -> HTTP 503 + ``Retry-After``), finish
        everything queued or executing within ``deadline_s``, then
        close. Returns True when nothing was left behind."""
        # under the stat lock: the admission read in infer() must see
        # either pre-drain or drain, never a torn intermediate with the
        # backlog counters (the drain-vs-unload snapshot race)
        with self._stat_lock:
            self._draining = True
        end = time.perf_counter() + max(0.0, deadline_s)
        while time.perf_counter() < end:
            with self._stat_lock:
                idle = self._pending == 0
            if idle:
                break
            time.sleep(0.005)
        with self._stat_lock:
            clean = self._pending == 0
        self.close()
        return clean

    def hot_swap(self, sessions, deadline_s: float = 10.0) -> bool:
        """Replace the serving instances in place under the graceful-
        drain protocol: admission pauses (``infer`` sheds with 503 +
        ``Retry-After``), the admitted backlog flushes on the OLD
        instances within ``deadline_s``, the workers restart on the new
        ones, and admission resumes. The adoption point for a
        re-searched serving plan (``ModelRepository.hot_swap``): no
        admitted request is dropped, late arrivals are shed exactly as
        during a drain. Returns True when the backlog flushed clean."""
        if not isinstance(sessions, (list, tuple)):
            sessions = [sessions]
        if not sessions:
            raise ValueError("need at least one session instance")
        with self._stat_lock:
            self._draining = True
        end = time.perf_counter() + max(0.0, deadline_s)
        while time.perf_counter() < end:
            with self._stat_lock:
                if self._pending == 0:
                    break
            time.sleep(0.005)
        with self._stat_lock:
            clean = self._pending == 0
        # stop the old workers (the queue is empty or past-deadline:
        # anything still queued re-queues onto the new workers' event)
        self._stop.set()
        for w in self._workers:
            w.join(timeout=5)
        self._stop = threading.Event()
        self.sessions = list(sessions)
        self.session = self.sessions[0]
        self._workers = [
            threading.Thread(target=self._run, args=(s,), daemon=True)
            for s in self.sessions]
        for w in self._workers:
            w.start()
        with self._stat_lock:
            self._draining = False
        return clean

    def close(self):
        """Stop the workers and promptly fail anything still queued —
        an unload must not leave clients blocked until their timeout."""
        self._stop.set()
        for w in self._workers:
            w.join(timeout=5)
        self._fail_queued()

    def _fail_queued(self):
        """Fail everything still queued (no worker will ever pop it):
        close()'s sweep, re-run by any ``infer`` whose enqueue raced
        past it."""
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            with self._stat_lock:
                self._queued_rows -= r.rows
                self._pending -= 1
            if r.probe:
                self.breaker.release_probe()
            # a shed, not a client error: RequestRejected maps to 503 +
            # Retry-After so retry-aware clients try another replica.
            # Counted as expired (never consumed a device step), NOT
            # failed — ff_requests_failed_total is a model-health
            # signal and must not fire on routine unload/shutdown
            r.error = RequestRejected(
                "scheduler closed (model unloaded or shut down); "
                "retry against another replica", retry_after_s=5.0)
            self.metrics.record_expired(bucket=r.bucket)
            if r.trace is not None:
                r.trace.finish("expired", r.t0, bucket=r.bucket,
                               reason="closed")
            r.event.set()

    # ------------------------------------------------------------------
    # worker side
    # ------------------------------------------------------------------
    def _expire(self, r: _Request, active: bool = False):
        """Fail a request without running it (deadline passed or client
        abandoned) — it never consumes a device step. ``active`` marks
        requests already counted in flight (the individual-retry path);
        an expired probe gives its half-open slot back."""
        with self._stat_lock:
            self._pending -= 1
            if active:
                self._active -= 1
                self._active_rows -= r.rows
        if r.probe:
            self.breaker.release_probe()
        r.error = DeadlineExceededError(
            "request expired in queue before reaching a device step")
        # an expired request with a deadline missed its SLO; a merely
        # abandoned one (client timeout shorter than any deadline) did
        # not breach a deadline the server agreed to
        missed = (r.deadline is not None
                  and time.perf_counter() >= r.deadline)
        self.metrics.record_expired(bucket=r.bucket,
                                    deadline_missed=missed)
        if r.trace is not None:
            r.trace.finish("expired", r.t0, bucket=r.bucket,
                           reason="queue-expired")
        r.event.set()

    def _take(self, timeout: float) -> Optional[_Request]:
        """Pop the next LIVE request; expired/abandoned ones are failed
        on the spot and skipped. None on timeout."""
        end = time.perf_counter() + timeout
        while True:
            remaining = end - time.perf_counter()
            if remaining <= 0:
                return None
            try:
                r = self._q.get(timeout=remaining)
            except queue.Empty:
                return None
            with self._stat_lock:
                self._queued_rows -= r.rows
            if r.trace is not None:
                # queue-wait span for live AND expired requests: the
                # expired trace must still show where the time went
                r.trace.stage("queue", r.t0, bucket=r.bucket,
                              rows=r.rows)
            if r.abandoned or (r.deadline is not None
                               and time.perf_counter() >= r.deadline):
                self._expire(r)
                continue
            with self._stat_lock:
                self._active += 1
                self._active_rows += r.rows
            return r

    def _drain(self) -> List[_Request]:
        """Block for one live request, then batch whatever arrives
        within the delay window (up to max_batch rows)."""
        first = self._take(0.1)
        if first is None:
            return []
        batch = [first]
        rows = first.rows
        deadline = self.max_delay_s
        t0 = time.perf_counter()
        while rows < self.max_batch:
            remaining = deadline - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            r = self._take(remaining)
            if r is None:
                break
            batch.append(r)
            rows += r.rows
        return batch

    def _finish_ok(self, r: _Request, now: float):
        with self._stat_lock:
            self._pending -= 1
            self._active -= 1
            self._active_rows -= r.rows
        missed = r.deadline is not None and now > r.deadline
        self.metrics.record_done(now - r.t0, ok=True, bucket=r.bucket,
                                 deadline_missed=missed)
        if r.trace is not None:
            # finish BEFORE event.set: the waiter (or the HTTP layer
            # above it) sees the latch already taken and cannot record
            # a second, less precise outcome
            if missed:
                r.trace.finish("ok", r.t0, bucket=r.bucket,
                               deadline_missed=True)
            else:
                r.trace.finish("ok", r.t0, bucket=r.bucket)
        r.event.set()

    def _finish_error(self, r: _Request, e: Exception):
        with self._stat_lock:
            self._pending -= 1
            self._active -= 1
            self._active_rows -= r.rows
        r.error = e
        self.metrics.record_done(time.perf_counter() - r.t0, ok=False,
                                 bucket=r.bucket)
        if r.trace is not None:
            r.trace.finish("failed", r.t0, bucket=r.bucket,
                           error=type(e).__name__)
        r.event.set()

    def _observe_batch_latency(self, dt: float):
        with self._stat_lock:
            if self._ewma_batch_s is None:
                self._ewma_batch_s = dt
            else:
                self._ewma_batch_s = 0.7 * self._ewma_batch_s + 0.3 * dt

    def _retry_individually(self, session, batch: List[_Request]):
        """A failed batch may contain ONE poisoned member: retry each
        request alone once so good co-batched requests still succeed
        (request-level fault isolation); only the bad member fails.
        Members whose client is gone (deadline passed or abandoned
        during the failed batch attempt) are expired instead of
        retried — no device step for work nobody is waiting on, and no
        spurious breaker feedback from it."""
        for r in batch:
            if r.abandoned or (r.deadline is not None
                               and time.perf_counter() >= r.deadline):
                self._expire(r, active=True)
                continue
            with self.metrics._lock:
                self.metrics.individual_retries += 1
            try:
                out = session.infer(r.inputs)
            except Exception as e:  # noqa: BLE001 — isolate per request
                # breaker BEFORE the event: a client retrying the
                # instant the K-th failure surfaces must hit the open
                # circuit, not race past the threshold
                self.breaker.on_failure()
                self._finish_error(r, e)
            else:
                r.result = out
                self.breaker.on_success()
                self._finish_ok(r, time.perf_counter())

    def _run(self, session):
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            brows = sum(r.rows for r in batch)
            with self.metrics._lock:
                self.metrics.batches += 1
                self.metrics.batched_rows += brows
            t_exec = time.perf_counter()
            try:
                names = session.input_names
                stacked = {
                    n: np.concatenate([r.inputs[n] for r in batch], axis=0)
                    for n in names}
                out = session.infer(stacked)
            except Exception as e:  # noqa: BLE001 — fan the error out
                if len(batch) > 1:
                    self._retry_individually(session, batch)
                else:
                    # breaker BEFORE the event (see _retry_individually)
                    self.breaker.on_failure()
                    self._finish_error(batch[0], e)
                continue
            self._observe_batch_latency(time.perf_counter() - t_exec)
            self.breaker.on_success()
            off = 0
            now = time.perf_counter()
            for r in batch:
                r.result = out[off:off + r.rows]
                off += r.rows
                if r.trace is not None:
                    # batch-assembly + device-step span, one per member
                    # so each request's trace shows the batch it rode
                    r.trace.stage("batch", t_exec, now - t_exec,
                                  bucket=r.bucket, batch_rows=brows,
                                  batch_requests=len(batch))
                self._finish_ok(r, now)
