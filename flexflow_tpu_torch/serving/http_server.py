"""Dependency-free HTTP front speaking the Triton KServe-style API.

The port of ``flexflow_tpu/serving/http_server.py`` (stdlib
``http.server``, plain Python): the same routes, status codes, headers
and bodies, shared by the threaded front here and the asyncio front
(``async_server.py``).

Endpoints (JSON bodies, shapes row-major):
  - ``GET  /v2/health/ready``            -> 200 when serving, 503 while
    draining (k8s readiness semantics)
  - ``GET  /healthz``                    -> 200 {"status": "ok"} (probe
    alias — what k8s-style liveness checks expect); carries the
    resilience block AND a per-model serving block (circuit-breaker
    state, queue depth, draining)
  - ``GET  /v2/models``                  -> {"models": [names]}
  - ``GET  /v2/metrics``                 -> per-model scheduler counters
    (requests/completed/rejected/expired/deadline-rejected, queue
    depth, circuit state, mean batch rows, sketch latency quantiles
    p50/p90/p99/p99.9 ms overall and per batch bucket, SLO violations,
    instances)
  - ``GET  /metrics``                    -> Prometheus text exposition
    (request-latency histograms, queue-depth + circuit-state gauges,
    request counters — the ``obs/metrics_registry.py`` registry;
    scrape-ready)
  - ``POST /v2/models/<name>/infer``     -> {"outputs": [{"data", "shape"}]}
    body: {"inputs": [{"name": ..., "shape": [...], "data": [flat]}]};
    optional ``x-ff-timeout-ms`` header sets the request deadline.
    Load shedding (bounded queue, admission control, circuit open,
    draining) -> 503 + ``Retry-After``; a missed deadline -> 504;
    malformed inputs -> 400
  - ``POST /v2/models/<name>/generate``  -> {"outputs": [{"name":
    "output_ids", ...}]} — causal-LM decode; body adds
    {"parameters": {"prompt_len", "max_new_tokens", "temperature", "top_k", "top_p",
    "seed", "eos_token_id"}}
  - ``POST /v2/repository/models/<name>/unload`` -> remove a model

Deadline, admission, breaker and drain semantics are the scheduler's
(``scheduler.py``).

Request tracing: when ``obs.events`` is enabled every inference POST
carries a trace id — the client's ``x-ff-trace-id`` header or a
generated one, echoed back on the response — and its lifecycle
(admission -> queue -> batch -> prefill -> decode -> response) lands as
linked spans in the trace ring (``obs.events``).
"""
from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..obs import events as obs_events
from ..obs import request_trace
from ..obs.metrics_registry import REGISTRY
from .scheduler import (CIRCUIT_STATE_NUM, InvalidInputError,
                        RequestRejected)


class ServingState:
    """Shared per-server lifecycle state (one per front): ``draining``
    flips readiness to 503 and rejects new inference work with 503 +
    ``Retry-After`` while in-flight requests finish. The in-flight
    counter tracks HTTP requests between parse and response-written so
    a drain can wait for the RESPONSES to flush, not just for the
    schedulers to go idle (the asyncio front's write happens after the
    scheduler completes — stopping the loop in that window would reset
    the client of an already-successful request)."""

    def __init__(self, default_deadline_ms: Optional[float] = None):
        self.draining = False
        # the front's configured default deadline: the batching
        # scheduler applies its own copy, but the uncancellable paths
        # (generate, batching=False) need it for the post-hoc 504
        self.default_deadline_ms = default_deadline_ms
        self._inflight = 0
        self._lock = threading.Lock()

    def enter_request(self):
        with self._lock:
            self._inflight += 1

    def exit_request(self):
        with self._lock:
            self._inflight -= 1

    def inflight(self) -> int:
        with self._lock:
            return self._inflight


def drain_frontend(schedulers, state: ServingState,
                   deadline_s: float) -> bool:
    """Shared drain policy for both fronts: stop admitting (readiness
    -> 503, new inference work -> 503 + ``Retry-After``), drain every
    scheduler, then wait for the in-flight RESPONSES to flush — the
    schedulers going idle is not the end of a request; killing the
    process before the handler writes the response would reset the
    client of already-successful work. Returns True when nothing was
    abandoned."""
    state.draining = True
    end = time.perf_counter() + max(0.0, deadline_s)
    clean = True
    # snapshot: a concurrent unload request pops from the live dict
    for s in list(schedulers.values()):
        clean &= s.drain(max(0.0, end - time.perf_counter()))
    # one observation of 0 is enough: admitted work has flushed, and
    # anything arriving after the draining flip is shed — re-reading
    # the counter at the end would let a late shed 503 (counted only
    # until its response is written) spuriously report work abandoned
    while time.perf_counter() < end:
        if state.inflight() == 0:
            return clean
        time.sleep(0.005)
    return clean and state.inflight() == 0


def render_body(obj):
    """Encode a route result body: dict -> JSON, str -> pre-rendered
    plain text (the Prometheus exposition). Returns ``(bytes, ctype)``;
    shared by the threading and asyncio front-ends so the content-type
    policy cannot drift between them."""
    if isinstance(obj, str):
        return obj.encode(), "text/plain; version=0.0.4; charset=utf-8"
    return json.dumps(obj).encode(), "application/json"


def _retry_after(e: RequestRejected) -> Dict[str, str]:
    """Retry-After header for a shedding rejection: integer seconds
    (HTTP spec), at least 1."""
    return {"Retry-After": str(max(1, math.ceil(e.retry_after_s)))}


def _past_deadline(t0: float, timeout_ms: Optional[float]):
    """Post-hoc deadline check for the two UNCANCELLABLE paths
    (generate, batching=False): the work already ran, but a completion
    past the declared deadline must be a 504, not a misleadingly-late
    200. Returns the 504 response tuple, or None within budget."""
    if timeout_ms is not None and \
            (time.perf_counter() - t0) * 1e3 > timeout_ms:
        return 504, {"error": "request deadline "
                              f"({timeout_ms:.0f} ms) exceeded"}, {}
    return None


def render_prometheus(schedulers) -> str:
    """Prometheus text for ``GET /metrics``: the process-wide registry
    plus point-in-time gauges (queue depth, instances, circuit state)
    sampled at scrape time from the live schedulers.

    The registry is process-wide by design (all fronts' request
    counters/histograms merge into one namespace); the point-in-time
    gauges reflect the schedulers of the server front that was scraped,
    so a process running MULTIPLE fronts should scrape one of them —
    the standard one-server-per-process deployment is unaffected."""
    live = list(schedulers.items())
    # atomic re-sample from live state: rows for models unloaded since
    # the last scrape disappear, and a concurrent scrape never observes
    # a half-populated row set
    REGISTRY.gauge("ff_queue_depth",
                   "Requests waiting in the bounded queue").set_all(
        ({"model": name}, sched._q.qsize()) for name, sched in live)
    REGISTRY.gauge("ff_scheduler_instances",
                   "Model instances draining the queue").set_all(
        ({"model": name}, sched.num_instances) for name, sched in live)
    REGISTRY.gauge("ff_circuit_state",
                   "Per-model circuit-breaker state: 0 closed, "
                   "1 half-open, 2 open").set_all(
        ({"model": name},
         CIRCUIT_STATE_NUM.get(sched.breaker.state, 0.0))
        for name, sched in live)
    qrows = []
    for name, sched in live:
        qrows.extend(sched.metrics.quantile_rows())
    REGISTRY.gauge(
        "ff_request_latency_quantile",
        "Streaming-sketch request latency quantiles (seconds) by "
        "model, batch bucket ('all' = every bucket), and quantile"
    ).set_all(qrows)
    return REGISTRY.render()


def get_route(path: str, repo, schedulers, state: Optional[ServingState]
              = None):
    """Route one GET; returns ``(status, obj, extra_headers)`` where
    ``obj`` is a JSON document (dict) or pre-rendered plain text (str —
    the Prometheus exposition). Shared by the threading and asyncio
    front-ends (the request counter lives here for the same reason: one
    counting policy, both fronts)."""
    obs_events.counter("serving.http_requests")
    if path in ("/v2/health/ready", "/healthz"):
        # resilience block (resilience/status.py): restart/fault/
        # checkpoint facts + checkpoint age, so a probe can alert on
        # "restarting in a loop" or "checkpoints stale" — both
        # invisible to a bare 200. The serving block adds per-model
        # circuit-breaker and drain state for the same reason.
        from ..resilience import status as resilience_status
        draining = bool(state is not None and state.draining)
        serving = {}
        # cheap fields only — probes fire every few seconds; the
        # latency block is a sketch walk (O(bins), no sort, bounded
        # bins), unlike the full stats() snapshot
        for name, sched in list(schedulers.items()):
            serving[name] = {"circuit": sched.breaker.state,
                             "queue_depth": sched._q.qsize(),
                             "draining": sched._draining,
                             # routing/scaling signals for a fleet
                             # front: the admission-control EWMA and
                             # the SLO counter it differentiates
                             "estimated_wait_s":
                                 sched.estimated_wait_s(),
                             "slo_violations":
                                 sched.metrics.slo_total(),
                             "latency_ms":
                                 sched.metrics.latency_quantiles()}
            # KV-decode fallback state (satellite of the serving-plan
            # work): a model quietly riding the O(L)-per-token
            # re-forward path is a live perf regression a probe should
            # see — count + the exact (batch, seq) shapes that failed
            try:
                ff = repo.get(name).ff
                ex = getattr(ff, "executor", None)
                shapes = sorted(getattr(ex, "_kv_failed_shapes", ())
                                or ())
                serving[name]["kv_fallback"] = {
                    "count": int(getattr(ff, "_kv_fallback_count", 0)),
                    "failed_shapes": [list(s) for s in shapes]}
            except Exception:  # noqa: BLE001 — non-FF session (tests)
                pass
        body = {"status": "draining" if draining else "ok",
                "ready": not draining,
                "resilience": resilience_status.health_fields(),
                "serving": serving,
                # trace-recorder health: silent ring overflow was
                # invisible before — a probe can now alert on a dropping
                # recorder; the flight-record pointer rides in the
                # resilience block (last_flight_record)
                "trace": {"enabled": obs_events.enabled(),
                          "events_dropped": obs_events.dropped()}}
        # READINESS flips to 503 while draining (stop routing here);
        # LIVENESS (/healthz) must stay 200 — the process is alive and
        # finishing work, and a k8s liveness kill would abort exactly
        # the in-flight requests the drain protects
        code = 503 if draining and path == "/v2/health/ready" else 200
        return code, body, {}
    if path == "/metrics":
        return 200, render_prometheus(schedulers), {}
    if path == "/v2/models":
        return 200, {"models": repo.names()}, {}
    if path == "/v2/metrics":
        # per-model scheduler counters + latency percentiles
        # (Triton's /metrics endpoint, prometheus-lite as JSON)
        out = {}
        # snapshot: a concurrent unload may pop from schedulers
        for name, sched in list(schedulers.items()):
            out[name] = sched.stats()
        return 200, {"models": out}, {}
    return 404, {"error": f"no route {path}"}, {}


#: HTTP status -> trace outcome, the COARSE fallback mapping for the
#: direct (non-scheduler) paths; the scheduler's precise outcome is
#: latched first and wins (RequestTrace.finish is idempotent)
_OUTCOME_BY_STATUS = {200: "ok", 400: "invalid", 404: "invalid",
                      503: "rejected", 504: "expired"}


def post_route(path: str, body: bytes, repo, schedulers,
               headers: Optional[Dict[str, str]] = None,
               state: Optional[ServingState] = None):
    """Route one POST (BLOCKING — the batching scheduler's ``infer``
    waits for the result; the asyncio front runs this in a thread
    pool). Returns ``(status, json_obj, extra_headers)``.

    Inference routes get a lifecycle trace (``obs.request_trace``) when
    tracing is enabled: the client's ``x-ff-trace-id`` is honored (and
    echoed on the response), the terminal outcome lands on the trace's
    response span, and the trace is the thread's ambient one for the
    duration so deep layers (generate's prefill/decode spans) link into
    it."""
    obs_events.counter("serving.http_requests")
    parts = path.strip("/").split("/")
    # v2/repository/models/<name>/unload (Triton repository API)
    if len(parts) == 5 and parts[:3] == ["v2", "repository", "models"] \
            and parts[4] == "unload":
        try:
            repo.unload(parts[3])
            sched = schedulers.pop(parts[3], None)
            if sched is not None:
                sched.close()
            return 200, {"unloaded": parts[3]}, {}
        except KeyError as e:
            return 404, {"error": str(e)}, {}
    # v2/models/<name>/{infer,generate}
    if len(parts) != 4 or parts[:2] != ["v2", "models"] \
            or parts[3] not in ("infer", "generate"):
        return 404, {"error": f"no route {path}"}, {}
    name, verb = parts[2], parts[3]
    hdrs = {str(k).lower(): v for k, v in (headers or {}).items()}
    trace = request_trace.from_headers(hdrs, model=name)
    status, obj, extra = _model_route(verb, name, body, repo,
                                      schedulers, hdrs, state, trace)
    if trace is not None:
        # fallback finish for paths that never reached the scheduler
        # (generate, direct infer, parse errors) — a no-op when the
        # scheduler already latched the precise outcome
        trace.finish(_OUTCOME_BY_STATUS.get(status, "failed"),
                     status=status)
        extra = dict(extra)
        extra[request_trace.TRACE_HEADER] = trace.trace_id
    return status, obj, extra


def _model_route(verb: str, name: str, body: bytes, repo, schedulers,
                 hdrs: Dict[str, str], state: Optional[ServingState],
                 trace):
    """The infer/generate route body behind :func:`post_route`'s trace
    bracketing."""
    if state is not None and state.draining:
        # graceful drain: readiness already flipped; in-flight work
        # finishes but nothing new is admitted
        return 503, {"error": "server draining; retry against another "
                              "replica"}, {"Retry-After": "5"}
    timeout_ms = None
    if "x-ff-timeout-ms" in hdrs:
        try:
            timeout_ms = float(hdrs["x-ff-timeout-ms"])
        except ValueError:
            return 400, {"error": "bad x-ff-timeout-ms header: "
                                  f"{hdrs['x-ff-timeout-ms']!r}"}, {}
        if not (timeout_ms > 0 and math.isfinite(timeout_ms)):
            # inf passes a bare '> 0' check and would overflow the
            # scheduler's Event.wait; nan fails every comparison
            return 400, {"error": "x-ff-timeout-ms must be a finite "
                                  f"positive number, got {timeout_ms}"}, {}
    # effective deadline + start reference for the direct
    # (non-scheduler) paths, where the work cannot be shed or
    # preempted — only 504'd after the fact; the front's configured
    # default applies to headerless requests there too
    eff_ms = timeout_ms
    if eff_ms is None and state is not None:
        eff_ms = state.default_deadline_ms
    t0 = time.perf_counter()
    # ambient-trace bracket around the whole verb body — manual
    # enter/exit so the long-standing try/except chain below keeps its
    # indentation; the finally below is the matching exit
    _ambient = request_trace.activate(trace)
    _ambient.__enter__()
    try:
        doc = json.loads(body)
        inputs = {}
        for rec in doc["inputs"]:
            arr = np.asarray(rec["data"], dtype=np.dtype(
                rec.get("datatype", "float32").lower()
                .replace("fp", "float")))
            inputs[rec["name"]] = arr.reshape(rec["shape"])
        if trace is not None:
            # admission span: JSON parse + tensor assembly + (for
            # generate) parameter validation happen between t0 and the
            # dispatch into the scheduler/session
            trace.stage("admission", t0, verb=verb,
                        rows=(int(next(iter(inputs.values())).shape[0])
                              if inputs else 0))
        if verb == "generate":
            sess = repo.get(name)      # unknown model -> 404
            p = doc.get("parameters", {})
            missing = [k for k in ("prompt_len",
                                   "max_new_tokens") if k not in p]
            if missing or "input_ids" not in inputs:
                return 400, {
                    "error": "generate needs inputs.input_ids "
                             f"and parameters {missing or ''}"}, {}
            eos = p.get("eos_token_id")
            top_k = int(p.get("top_k", 0))
            top_p = float(p.get("top_p", 1.0))
            temp = float(p.get("temperature", 0.0))
            num_beams = int(p.get("num_beams", 1))
            if not (0.0 < top_p <= 1.0) or top_k < 0 \
                    or temp < 0.0 or num_beams < 1:
                return 400, {
                    "error": "need 0 < top_p <= 1, top_k >= 0, "
                             "temperature >= 0, num_beams >= 1"}, {}
            pl = p["prompt_len"]
            out = sess.generate(
                inputs["input_ids"],
                prompt_len=(np.asarray(pl, np.int32)
                            if isinstance(pl, list) else int(pl)),
                max_new_tokens=int(p["max_new_tokens"]),
                temperature=temp,
                seed=int(p.get("seed", 0)),
                eos_token_id=None if eos is None else int(eos),
                top_k=top_k, top_p=top_p, num_beams=num_beams)
            late = _past_deadline(t0, eff_ms)
            if late is not None:
                # late completion on the uncancellable generate path:
                # count the SLO violation on THIS replica's counter —
                # a fleet router forwarding remaining deadlines relies
                # on the replica owning this count (it only accounts
                # requests no replica attempt ever carried)
                sched = schedulers.get(name)
                if sched is not None:
                    sched.metrics.record_slo()
                return late
            return 200, {"outputs": [{
                "name": "output_ids", "shape": list(out.shape),
                "data": np.asarray(out, np.int32).ravel().tolist()}]}, {}
        sched = schedulers.get(name)
        if sched is not None:
            # a deadline BEYOND the default 30 s blocking timeout —
            # header-declared or the scheduler's configured default —
            # must extend the wait, or a 60 s deadline 504s at 30 s
            # with half its budget left
            dl_ms = timeout_ms if timeout_ms is not None \
                else sched.default_deadline_ms
            wait_s = 30.0 if dl_ms is None else max(30.0, dl_ms / 1e3)
            out = sched.infer(inputs, timeout=wait_s,
                              deadline_ms=timeout_ms, trace=trace)
        else:
            out = repo.get(name).infer(inputs)
            late = _past_deadline(t0, eff_ms)
            if late is not None:
                return late
        return 200, {"outputs": [{
            "name": "output0", "shape": list(out.shape),
            "data": np.asarray(out, np.float32).ravel().tolist()}]}, {}
    except KeyError as e:
        return 404, {"error": str(e)}, {}
    except InvalidInputError as e:
        # malformed request (schema mismatch): a client error for THIS
        # request only — co-batched requests are unaffected
        return 400, {"error": str(e)}, {}
    except RequestRejected as e:
        # load shedding (queue full, admission control, circuit open,
        # draining): explicit 503 with a retry hint
        return 503, {"error": str(e)}, _retry_after(e)
    except TimeoutError as e:
        # deadline exceeded (queued too long or executed too late)
        return 504, {"error": f"{type(e).__name__}: {e}"}, {}
    except Exception as e:  # noqa: BLE001 — report, don't die
        return 400, {"error": f"{type(e).__name__}: {e}"}, {}
    finally:
        _ambient.__exit__(None, None, None)


def _make_handler(repo, schedulers, state):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, obj, extra: Optional[Dict] = None):
            body, ctype = render_body(obj)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        # POSTs bracket the RESPONSE write in the in-flight counter:
        # handler threads are daemons the server never joins
        # (socketserver._Threads skips daemon threads), so drain()
        # must count them itself or a process exit right after
        # drain() kills a thread mid-write. GETs (health probes,
        # metrics scrapes) are NOT counted — losing one mid-write is
        # harmless, and counting them would let monitoring traffic
        # flake a clean drain

        def do_GET(self):
            self._send(*get_route(self.path, repo, schedulers, state))

        def do_POST(self):
            state.enter_request()
            try:
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                except (ValueError, OSError) as e:
                    return self._send(400,
                                      {"error": f"bad request: {e}"})
                self._send(*post_route(self.path, body, repo,
                                       schedulers,
                                       dict(self.headers.items()),
                                       state))
            finally:
                state.exit_request()

    return Handler


class HttpServerHandle(tuple):
    """The ``(server, thread, schedulers)`` triple ``serve_http`` has
    always returned (tuple unpacking keeps working), plus lifecycle
    methods: ``drain()`` for graceful shutdown, ``stop()`` for an
    immediate one."""

    def __new__(cls, srv, thread, schedulers, state):
        self = super().__new__(cls, (srv, thread, schedulers))
        self.state = state
        return self

    @property
    def server(self):
        return self[0]

    @property
    def thread(self):
        return self[1]

    @property
    def schedulers(self):
        return self[2]

    def drain(self, deadline_s: float = 10.0) -> bool:
        """Graceful drain: flip ``/v2/health/ready`` to 503, reject new
        inference work with 503 + ``Retry-After``, finish in-flight
        requests (responses written included) within ``deadline_s``,
        then close the schedulers and the listener. Returns True when
        nothing was abandoned."""
        clean = drain_frontend(self[2], self.state, deadline_s)
        self[0].shutdown()
        self[0].server_close()     # refuse (not hang) new connections
        return clean

    def stop(self):
        """Immediate shutdown: close the listener, fail queued work."""
        self[0].shutdown()
        self[0].server_close()
        for s in list(self[2].values()):
            s.close()


def serve_http(repo, host: str = "127.0.0.1", port: int = 8000,
               batching: bool = True, block: bool = True,
               max_batch: int = 64, max_delay_ms: float = 2.0,
               max_queue: int = 256,
               default_deadline_ms: Optional[float] = None,
               breaker_threshold: int = 5,
               breaker_cooldown_s: float = 5.0,
               admission_estimate: str = "wait"):
    """Serve a :class:`ModelRepository`. ``block=False`` returns an
    :class:`HttpServerHandle` (unpacks as the ``(server, thread,
    schedulers)`` triple for in-process testing; adds ``drain()``/
    ``stop()``). Each model's scheduler drains a bounded queue
    (``max_queue``; overflow = HTTP 503) with one worker per registered
    instance; ``default_deadline_ms`` applies to requests without an
    ``x-ff-timeout-ms`` header, and ``breaker_threshold``/
    ``breaker_cooldown_s`` configure the per-model circuit breaker.
    ``admission_estimate`` is forwarded to each
    :class:`~flexflow_tpu.serving.scheduler.BatchScheduler` — fleet
    replicas pass ``"completion"`` so deadline shedding predicts the
    full request latency, not just the queue wait."""
    from .scheduler import BatchScheduler
    schedulers = {}
    state = ServingState(default_deadline_ms=default_deadline_ms)
    if batching:
        for name in repo.names():
            schedulers[name] = BatchScheduler(
                repo.get_instances(name), max_batch=max_batch,
                max_delay_ms=max_delay_ms, max_queue=max_queue,
                name=name, default_deadline_ms=default_deadline_ms,
                breaker_threshold=breaker_threshold,
                breaker_cooldown_s=breaker_cooldown_s,
                admission_estimate=admission_estimate)
    srv = ThreadingHTTPServer((host, port),
                              _make_handler(repo, schedulers, state))
    if block:
        try:
            srv.serve_forever()
        finally:
            for s in schedulers.values():
                s.close()
        return None
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return HttpServerHandle(srv, t, schedulers, state)
