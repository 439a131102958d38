"""Multi-replica routing front: least-estimated-wait, deadline-true.

The port of ``flexflow_tpu/serving/fleet/router.py``, unchanged (plain
Python, stdlib HTTP). One ``BatchScheduler`` process caps goodput at
one device and makes every restart a full outage. The router puts N replica serving
processes (each its own scheduler + HTTP front, spawned by
:mod:`.replica` or adopted by URL) behind one endpoint:

* **Routing signal**: each replica's own admission-control EWMA —
  ``estimated_wait_s`` polled from ``/healthz`` — plus its circuit
  state. Requests go to the live, non-draining replica with the least
  estimated wait; breaker-open replicas are skipped entirely (their
  503s are *predictable*, so routing around them is free).
* **Failover**: a dead replica (transport error, hard crash, a reply
  cut short after its headers) or a 503 shed fails over to the next
  candidate while deadline budget remains.
* **Deadline truth**: the hop forwards the *remaining* budget
  (``x-ff-timeout-ms`` minus elapsed) — a router hop must never extend
  a request's deadline. SLO accounting stays deduplicated: a replica
  that received the remaining deadline counts its own violation
  (completed-late / expired / deadline-rejected), so the fleet layer
  counts ``ff_fleet_slo_violations_total`` ONLY for requests no
  replica attempt ever carried — expired in the router or dead on
  every transport. Fleet violations = Σ replica counters + the fleet
  counter, each violation counted exactly once.
* **Traces**: ``x-ff-trace-id`` propagates across the hop (minting one
  if the client sent none), so replica-side lifecycle traces link into
  the same fleet request.

Fleet ``/v2/metrics`` scrapes every replica and merges their latency
sketches with ``QuantileSketch.merge`` — fleet p99 is computed over
the union stream, never averaged across replicas.
"""
from __future__ import annotations

import http.client
import json
import os
import socket
import subprocess
import threading
import time
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

from ...obs.metrics_registry import REGISTRY
from ...obs.request_trace import TRACE_HEADER
from ...obs.sketch import QuantileSketch

#: consecutive failed health polls after which a replica is routed
#: around (and eligible for autoscaler replacement)
DEAD_AFTER = 3

_ROUTED = REGISTRY.counter(
    "ff_fleet_requests_total", "requests routed, by replica")
_FAILOVERS = REGISTRY.counter(
    "ff_fleet_failovers_total",
    "requests re-dispatched after a replica transport failure or shed")
_FLEET_SLO = REGISTRY.counter(
    "ff_fleet_slo_violations_total",
    "deadline violations accounted at the FLEET layer: requests that "
    "expired before any replica attempt carried the remaining "
    "deadline, or whose every transport died. Disjoint from the "
    "replicas' own ff_slo_violations_total by construction")
_REPLICAS_G = REGISTRY.gauge(
    "ff_fleet_replicas", "replicas known to the router, by state")
_TTR = REGISTRY.gauge(
    "ff_replica_time_to_ready_seconds",
    "spawn -> first passing health poll, by replica (warm compile "
    "cache is what keeps this flat as the fleet scales)")


class NoReplicaAvailableError(RuntimeError):
    """No live, non-draining, breaker-closed replica to route to."""


def free_port() -> int:
    """An OS-assigned free TCP port (the standard bind-0 probe; the
    tiny race with another binder is acceptable for tests/smokes)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


class Replica:
    """One serving process behind the router: its URL, the child
    process when the router spawned it (adopted replicas have none),
    and the router's latest view of its health.

    Health fields are guarded by the owning router's lock — the
    poller writes them, ``pick``/``healthz`` read them."""

    def __init__(self, name: str, url: str,
                 proc: Optional[subprocess.Popen] = None):
        self.name = name
        self.url = url.rstrip("/")
        self.proc = proc
        self.spawned_at = time.monotonic()
        # guarded by FleetRouter._lock:
        self.health: Optional[Dict] = None
        self.consecutive_errors = 0
        self.ready_at: Optional[float] = None
        self.draining = False
        self.retired = False

    def alive_locked(self) -> bool:
        if self.proc is not None and self.proc.poll() is not None:
            return False
        return self.consecutive_errors < DEAD_AFTER \
            and self.health is not None


class FleetRouter:
    """Routes requests across replicas; owns the health-poll loop and
    (optionally) the replica child processes.

    ``spawn_argv`` is the replica launch template — a list of argv
    strings where the literal ``"{port}"`` and ``"{name}"`` are
    substituted per spawn (see :mod:`.replica` for the worker CLI).
    ``spawn_env`` overlays ``os.environ`` for every spawned child;
    ``spawn`` accepts a per-replica ``extra_env`` on top (the fault
    plan that kills exactly one replica in the chaos smoke)."""

    def __init__(self, spawn_argv: Optional[Sequence[str]] = None,
                 spawn_env: Optional[Dict[str, str]] = None,
                 poll_interval_s: float = 0.25,
                 connect_timeout_s: float = 3.0,
                 request_timeout_s: float = 120.0,
                 startup_grace_s: float = 180.0,
                 default_deadline_ms: Optional[float] = None):
        self.spawn_argv = list(spawn_argv) if spawn_argv else None
        self.spawn_env = dict(spawn_env or {})
        self.poll_interval_s = float(poll_interval_s)
        # connect_timeout_s bounds the cheap-by-contract control-plane
        # GETs (/healthz, /v2/metrics); request_timeout_s bounds a
        # forwarded request that carries NO deadline — generate can
        # legitimately run long (first-call compiles, long decodes)
        self.connect_timeout_s = float(connect_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        # how long a spawned replica may fail health polls before its
        # cold start is declared wedged (see retire_dead)
        self.startup_grace_s = float(startup_grace_s)
        self.default_deadline_ms = default_deadline_ms
        self._lock = threading.Lock()
        # guarded by _lock:
        self._replicas: List[Replica] = []
        self._seq = 0
        self._rr = 0  # round-robin cursor for tied-wait candidates
        self._stats = {"routed": 0, "failovers": 0,
                       "fleet_slo_violations": 0, "no_replica": 0}
        self._stop = threading.Event()
        self._poller = threading.Thread(
            target=self._poll_loop, name="ff-fleet-health", daemon=True)
        self._poller.start()

    # -- replica lifecycle -----------------------------------------

    def adopt(self, url: str, name: Optional[str] = None) -> Replica:
        """Route to an already-running serving process by URL (no
        child handle: the router cannot drain or replace it)."""
        with self._lock:
            self._seq += 1
            r = Replica(name or f"replica-{self._seq}", url)
            self._replicas.append(r)
        self.poll_once(r)
        return r

    def spawn(self, name: Optional[str] = None,
              extra_env: Optional[Dict[str, str]] = None,
              port: Optional[int] = None) -> Replica:
        """Launch one replica child from ``spawn_argv`` and start
        routing to it once its first health poll passes."""
        if not self.spawn_argv:
            raise NoReplicaAvailableError(
                "router has no spawn_argv template; adopt() replicas "
                "or construct with spawn_argv")
        with self._lock:
            self._seq += 1
            rname = name or f"replica-{self._seq}"
        rport = port if port is not None else free_port()
        argv = [a.replace("{port}", str(rport))
                 .replace("{name}", rname) for a in self.spawn_argv]
        env = dict(os.environ)
        env.update(self.spawn_env)
        env.update(extra_env or {})
        proc = subprocess.Popen(
            argv, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        r = Replica(rname, f"http://127.0.0.1:{rport}", proc)
        with self._lock:
            self._replicas.append(r)
        return r

    def drain(self, replica: Replica) -> None:
        """Graceful scale-down: stop routing to it, then ask the child
        to drain and exit (stdin protocol — see :mod:`.replica`)."""
        with self._lock:
            replica.draining = True
        if replica.proc is not None and replica.proc.stdin is not None:
            try:
                replica.proc.stdin.write(b"drain\n")
                replica.proc.stdin.flush()
            except (BrokenPipeError, OSError, ValueError):
                pass  # already dead — reap below

    def retire_dead(self) -> List[Replica]:
        """Drop replicas that are past ``DEAD_AFTER`` or whose process
        exited; returns them (the autoscaler's replacement signal).

        A spawned replica that has NEVER passed a health poll but
        whose process is still running is a cold start in progress,
        not a corpse — its connection-refused polls don't retire it
        until ``startup_grace_s`` has elapsed (a replacement compiling
        through the cache would otherwise be culled before its HTTP
        front even binds)."""
        dead: List[Replica] = []
        now = time.monotonic()
        with self._lock:
            keep = []
            for r in self._replicas:
                exited = r.proc is not None and r.proc.poll() is not None
                cold = (r.proc is not None and not exited
                        and r.ready_at is None)
                if cold and now - r.spawned_at <= self.startup_grace_s:
                    keep.append(r)
                    continue
                if exited or cold or (r.consecutive_errors >= DEAD_AFTER
                                      and r.health is None):
                    r.retired = True
                    dead.append(r)
                else:
                    keep.append(r)
            self._replicas = keep
        for r in dead:
            if r.proc is not None:
                if r.proc.poll() is None:
                    # wedged but running (grace expired / health-dead):
                    # reap it so retirement never leaks a process
                    r.proc.kill()
                try:
                    r.proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    pass
        return dead

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def close(self, drain_children: bool = True,
              timeout_s: float = 15.0) -> None:
        self._stop.set()
        self._poller.join(timeout=5.0)
        with self._lock:
            reps = list(self._replicas)
            self._replicas = []
        for r in reps:
            if r.proc is None:
                continue
            if drain_children:
                try:
                    if r.proc.stdin is not None:
                        r.proc.stdin.write(b"drain\n")
                        r.proc.stdin.flush()
                except (BrokenPipeError, OSError, ValueError):
                    pass
        deadline = time.monotonic() + timeout_s
        for r in reps:
            if r.proc is None:
                continue
            left = max(0.1, deadline - time.monotonic())
            try:
                r.proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                r.proc.kill()
                try:
                    r.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass

    # -- health ----------------------------------------------------

    def _http_json(self, url: str, timeout_s: float) -> Dict:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode())

    def poll_once(self, replica: Replica) -> Optional[Dict]:
        """One health poll; updates the router's view. Returns the
        health document, or None on failure."""
        try:
            doc = self._http_json(replica.url + "/healthz",
                                  self.connect_timeout_s)
        except Exception:  # noqa: BLE001 — any transport/parse
            # failure counts one strike; DEAD_AFTER strikes = dead
            with self._lock:
                replica.consecutive_errors += 1
                if replica.consecutive_errors >= DEAD_AFTER:
                    replica.health = None
            return None
        first = False
        with self._lock:
            replica.consecutive_errors = 0
            replica.health = doc
            if replica.ready_at is None:
                replica.ready_at = time.monotonic()
                first = True
            if not doc.get("ready", True):
                replica.draining = True
        if first and replica.proc is not None:
            _TTR.set(replica.ready_at - replica.spawned_at,
                     replica=replica.name)
        return doc

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            for r in self.replicas():
                if self._stop.is_set():
                    break
                if r.proc is not None and r.proc.poll() is not None:
                    with self._lock:
                        r.health = None
                        r.consecutive_errors = DEAD_AFTER
                    continue
                self.poll_once(r)
            with self._lock:
                alive = sum(1 for r in self._replicas
                            if r.alive_locked())
                total = len(self._replicas)
            _REPLICAS_G.set(alive, state="alive")
            _REPLICAS_G.set(total - alive, state="down")
            self._stop.wait(timeout=self.poll_interval_s)

    # -- routing ---------------------------------------------------

    def candidates(self, model: str) -> List[Replica]:
        """Live, non-draining replicas that can serve ``model``,
        cheapest estimated wait first; breaker-open replicas excluded.
        Replicas whose waits tie (an idle fleet, or generate-only
        traffic that never moves the scheduler EWMA) rotate round-
        robin — a stable sort alone would convoy every request onto
        one replica."""
        scored = []
        with self._lock:
            for r in self._replicas:
                if r.draining or not r.alive_locked():
                    continue
                serving = (r.health or {}).get("serving", {})
                m = serving.get(model)
                if m is None:
                    continue
                if m.get("circuit") == "open" or m.get("draining"):
                    continue
                scored.append((float(m.get("estimated_wait_s", 0.0)),
                               r))
            self._rr += 1
            rr = self._rr
        scored.sort(key=lambda t: t[0])
        if len(scored) > 1:
            best = scored[0][0]
            ties = [r for w, r in scored if w - best < 1e-9]
            rest = [r for w, r in scored if w - best >= 1e-9]
            k = rr % len(ties)
            return ties[k:] + ties[:k] + rest
        return [r for _, r in scored]

    def forward(self, model: str, path: str, body: bytes,
                headers: Dict[str, str]):
        """Route one POST. Returns ``(status, body_bytes, headers)``.

        Deadline semantics: the origin deadline is fixed at ARRIVAL
        here; every replica attempt receives only the remaining
        budget. Failover (transport death, 503 shed) retries the next
        candidate while budget remains."""
        t0 = time.monotonic()
        hdrs = {k.lower(): v for k, v in headers.items()}
        deadline_ms: Optional[float] = None
        if "x-ff-timeout-ms" in hdrs:
            try:
                deadline_ms = float(hdrs["x-ff-timeout-ms"])
            except ValueError:
                return 400, json.dumps(
                    {"error": "bad x-ff-timeout-ms header: "
                              f"{hdrs['x-ff-timeout-ms']!r}"}
                ).encode(), {}
        elif self.default_deadline_ms is not None:
            deadline_ms = float(self.default_deadline_ms)
        trace_id = hdrs.get(TRACE_HEADER) or uuid.uuid4().hex[:16]

        tried: List[str] = []
        dispatched_with_deadline = False
        last_exc: Optional[str] = None
        while True:
            remaining_ms = None
            if deadline_ms is not None:
                remaining_ms = deadline_ms \
                    - (time.monotonic() - t0) * 1e3
                if remaining_ms <= 0.0:
                    # never *extend* the budget: expired at the fleet
                    # layer. SLO dedupe: count here ONLY if no replica
                    # attempt carried the remaining deadline (a replica
                    # that did will count its own late completion)
                    if not dispatched_with_deadline:
                        self._count_fleet_slo(model)
                    return 504, json.dumps(
                        {"error": "deadline exceeded in fleet router",
                         "tried": tried}).encode(), \
                        {TRACE_HEADER: trace_id}
            cands = [r for r in self.candidates(model)
                     if r.name not in tried]
            if not cands:
                with self._lock:
                    self._stats["no_replica"] += 1
                if deadline_ms is not None \
                        and not dispatched_with_deadline:
                    self._count_fleet_slo(model)
                detail = {"error": "no replica available for "
                                   f"model {model!r}",
                          "tried": tried}
                if last_exc:
                    detail["last_error"] = last_exc
                return 503, json.dumps(detail).encode(), \
                    {"Retry-After": "1", TRACE_HEADER: trace_id}
            replica = cands[0]
            tried.append(replica.name)
            fwd_headers = {"Content-Type": "application/json",
                           TRACE_HEADER: trace_id}
            if remaining_ms is not None:
                fwd_headers["x-ff-timeout-ms"] = \
                    f"{remaining_ms:.3f}"
            # socket timeout: the remaining budget plus slack for the
            # response bytes — a replica past the deadline answers 504
            # itself; the slack keeps US from abandoning a reply that
            # is already on the wire. Deadline-less requests get the
            # long request_timeout_s: a first generate may compile
            sock_t = self.request_timeout_s if remaining_ms is None \
                else max(0.05, remaining_ms / 1e3) + 2.0
            req = urllib.request.Request(
                replica.url + path, data=body, headers=fwd_headers,
                method="POST")
            try:
                if remaining_ms is not None:
                    dispatched_with_deadline = True
                with urllib.request.urlopen(req, timeout=sock_t) \
                        as resp:
                    out = resp.read()
                    with self._lock:
                        self._stats["routed"] += 1
                    _ROUTED.inc(replica=replica.name)
                    return resp.status, out, \
                        {TRACE_HEADER: trace_id}
            except urllib.error.HTTPError as e:
                out = e.read()
                if e.code == 503:
                    # shed (queue full / breaker / draining): another
                    # replica may have room — fail over
                    self._note_failover(replica)
                    last_exc = f"{replica.name}: 503 shed"
                    continue
                with self._lock:
                    self._stats["routed"] += 1
                _ROUTED.inc(replica=replica.name)
                return e.code, out, {TRACE_HEADER: trace_id}
            except (urllib.error.URLError, ConnectionError,
                    http.client.HTTPException,
                    socket.timeout, TimeoutError) as e:
                reason = getattr(e, "reason", e)
                if not isinstance(reason,
                                  (socket.timeout, TimeoutError)):
                    # transport death — crashed replica, before its
                    # headers or mid-body (IncompleteRead); strike its
                    # health (the poller revives it if it recovers)
                    with self._lock:
                        replica.consecutive_errors = DEAD_AFTER
                        replica.health = None
                # a timed-out request means a SLOW replica, not a
                # dead one — death verdicts stay with the health
                # poller; either way, fail over to the next candidate
                self._note_failover(replica)
                last_exc = f"{replica.name}: {e}"
                continue

    def _note_failover(self, replica: Replica) -> None:
        with self._lock:
            self._stats["failovers"] += 1
        _FAILOVERS.inc()

    def _count_fleet_slo(self, model: str) -> None:
        with self._lock:
            self._stats["fleet_slo_violations"] += 1
        _FLEET_SLO.inc(model=model)

    # -- aggregation -----------------------------------------------

    def fleet_health(self) -> Dict:
        """The fleet ``/healthz`` document: per-replica state + a
        converged flag (every known replica polled healthy)."""
        reps = {}
        alive = 0
        with self._lock:
            for r in self._replicas:
                ok = r.alive_locked()
                alive += 1 if ok and not r.draining else 0
                reps[r.name] = {
                    "url": r.url,
                    "alive": ok,
                    "draining": r.draining,
                    "consecutive_errors": r.consecutive_errors,
                    "serving": (r.health or {}).get("serving", {}),
                }
            total = len(self._replicas)
            stats = dict(self._stats)
        converged = total > 0 and alive == total
        return {"status": "ok" if converged else "degraded",
                "ready": alive > 0,
                "converged": converged,
                "replicas": reps,
                "fleet": stats}

    def fleet_metrics(self) -> Dict:
        """The fleet ``/v2/metrics`` document: per-replica scheduler
        stats scraped live, plus per-model aggregates where counters
        sum and latency quantiles come from the MERGED sketches."""
        per_replica: Dict[str, Dict] = {}
        for r in self.replicas():
            with self._lock:
                ok = r.alive_locked() and not r.draining
            if not ok:
                continue
            try:
                doc = self._http_json(r.url + "/v2/metrics",
                                      self.connect_timeout_s)
            except Exception:  # noqa: BLE001 — a replica dying
                # mid-scrape degrades the view, never the endpoint
                continue
            per_replica[r.name] = doc.get("models", {})
        models = merge_replica_metrics(per_replica)
        with self._lock:
            stats = dict(self._stats)
        return {"models": models, "replicas": per_replica,
                "fleet": stats}


_SUM_FIELDS = ("requests", "completed", "failed", "rejected",
               "expired", "deadline_rejected", "breaker_opens",
               "slo_violations", "batches", "queue_depth")


def merge_replica_metrics(per_replica: Dict[str, Dict]) -> Dict:
    """Aggregate per-replica ``/v2/metrics`` model blocks: counters
    sum; latency quantiles are recomputed from the union of the
    replicas' serialized sketches (``QuantileSketch.merge`` — exact,
    not an average of percentiles). Pure so the merge path is unit-
    testable against single-stream ingestion."""
    models: Dict[str, Dict] = {}
    sketches: Dict[str, Dict[str, QuantileSketch]] = {}
    for rep_doc in per_replica.values():
        for model, stats in rep_doc.items():
            agg = models.setdefault(
                model, {f: 0 for f in _SUM_FIELDS})
            agg["replicas"] = agg.get("replicas", 0) + 1
            for f in _SUM_FIELDS:
                agg[f] += int(stats.get(f, 0))
            by_label = sketches.setdefault(model, {})
            for label, doc in (stats.get("sketches") or {}).items():
                sk = QuantileSketch.from_dict(doc)
                if label in by_label:
                    by_label[label].merge(sk)
                else:
                    by_label[label] = sk
    for model, by_label in sketches.items():
        q = {}
        for label, sk in sorted(by_label.items()):
            if not sk.count:
                continue
            q[label] = {"p50": round(sk.quantile(0.5) * 1e3, 3),
                        "p90": round(sk.quantile(0.9) * 1e3, 3),
                        "p99": round(sk.quantile(0.99) * 1e3, 3),
                        "p99.9": round(sk.quantile(0.999) * 1e3, 3)}
        models[model]["latency_ms"] = q
        models[model]["sketches"] = {
            label: sk.to_dict() for label, sk in by_label.items()}
    return models


# ---------------------------------------------------------------------------
# fleet HTTP front
# ---------------------------------------------------------------------------
def _make_fleet_handler(router: FleetRouter):
    class FleetHandler(BaseHTTPRequestHandler):
        # keep-alive: every response path goes through _send, which
        # always carries Content-Length, so clients under deadline
        # pressure can reuse connections instead of paying a TCP
        # setup (and a handler-thread spawn) per request. Nagle off:
        # a buffered small response must not wait out a delayed ACK
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: bytes,
                  extra: Optional[Dict[str, str]] = None):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path in ("/healthz", "/v2/health/ready"):
                doc = router.fleet_health()
                code = 200
                if self.path == "/v2/health/ready" \
                        and not doc["ready"]:
                    code = 503
                self._send(code, json.dumps(doc).encode())
                return
            if self.path == "/v2/metrics":
                self._send(200,
                           json.dumps(router.fleet_metrics()).encode())
                return
            if self.path == "/v2/models":
                names = set()
                for r in router.replicas():
                    with router._lock:
                        serving = (r.health or {}).get("serving", {})
                    names.update(serving)
                self._send(200, json.dumps(
                    {"models": sorted(names)}).encode())
                return
            self._send(404, json.dumps(
                {"error": f"no route {self.path}"}).encode())

        def do_POST(self):
            parts = self.path.strip("/").split("/")
            # /v2/models/<name>/(infer|generate)
            if len(parts) == 4 and parts[:2] == ["v2", "models"] \
                    and parts[3] in ("infer", "generate"):
                n = int(self.headers.get("Content-Length", 0) or 0)
                body = self.rfile.read(n) if n else b""
                code, out, extra = router.forward(
                    parts[2], self.path, body, dict(self.headers))
                self._send(code, out, extra)
                return
            self._send(404, json.dumps(
                {"error": f"no route {self.path}"}).encode())

    return FleetHandler


class FleetHandle:
    """Running fleet front: the HTTP server, its thread, and the
    router (with its replica children)."""

    def __init__(self, server, thread, router: FleetRouter):
        self.server = server
        self.thread = thread
        self.router = router

    @property
    def port(self) -> int:
        return int(self.server.server_address[1])

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self, drain_children: bool = True) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10.0)
        self.router.close(drain_children=drain_children)


def serve_fleet(router: FleetRouter, host: str = "127.0.0.1",
                port: int = 0) -> FleetHandle:
    """Start the fleet HTTP front (non-blocking); ``port=0`` picks a
    free port (read it back from ``handle.port``)."""
    srv = ThreadingHTTPServer((host, port),
                              _make_fleet_handler(router))
    t = threading.Thread(target=srv.serve_forever,
                         name="ff-fleet-http", daemon=True)
    t.start()
    return FleetHandle(srv, t, router)
