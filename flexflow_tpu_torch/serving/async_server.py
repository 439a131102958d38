"""Asyncio HTTP front for the model repository.

The port of ``flexflow_tpu/serving/async_server.py`` (stdlib asyncio).
Same KServe-style surface as ``http_server.py`` (the two share the
route functions), but connections are multiplexed on one event loop
instead of a thread per connection. Request BODIES are
parsed and executed in a bounded thread pool (the batching scheduler's
``infer`` blocks on its result event), so the loop never stalls on a
device step; keep-alive is supported so load generators reuse
connections. Header reads are bounded (count and total bytes) so a
client streaming endless header lines cannot grow memory without
bound.

Usage::

    from flexflow_tpu_torch.serving import serve_async
    serve_async(repo, port=8000)                     # blocks
    srv = serve_async(repo, port=8000, block=False)  # returns handle
    ...
    srv.drain()   # graceful: finish in-flight, reject new work, close
    srv.stop()    # immediate
"""
from __future__ import annotations

import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..obs import events as obs_events
from ..obs import request_trace
from .http_server import (ServingState, drain_frontend, get_route,
                          post_route, render_body)

_MAX_BODY = 256 << 20   # sanity bound, matches big dense batches
_MAX_HEADERS = 256      # header-line count bound per request
_MAX_HEADER_BYTES = 64 << 10   # total header bytes bound per request


class AsyncServerHandle:
    """Running server + its loop thread; ``drain()`` shuts down
    gracefully (finish in-flight, shed new work), ``stop()``
    immediately."""

    def __init__(self, loop, server, thread, schedulers, pool, state):
        self._loop = loop
        self._server = server
        self._thread = thread
        self.schedulers = schedulers
        self._pool = pool
        self.state = state

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    def drain(self, deadline_s: float = 10.0) -> bool:
        """Graceful drain: flip ``/v2/health/ready`` to 503, reject new
        inference work with 503 + ``Retry-After``, finish in-flight
        requests (responses written included) within ``deadline_s``,
        then stop. Returns True when nothing was abandoned."""
        clean = drain_frontend(self.schedulers, self.state, deadline_s)
        self.stop()
        return clean

    def stop(self):
        def _close():
            self._server.close()

        try:
            self._loop.call_soon_threadsafe(_close)
            self._loop.call_soon_threadsafe(self._loop.stop)
        except RuntimeError:
            pass    # loop already stopped and closed (double stop)
        self._thread.join(timeout=10)
        # snapshot: a concurrent unload request pops from the live dict
        for s in list(self.schedulers.values()):
            s.close()
        self._pool.shutdown(wait=False)
        # the loop thread itself closes the loop (releasing the
        # selector/self-pipe fds) right after run_forever returns — see
        # serve_async's runner — so a thread that misses the join
        # timeout above still cannot leak the fds once it does stop


async def _read_request(reader):
    """Parse one HTTP/1.1 request; returns (method, path, headers,
    body) or None on EOF. An unparseable request line — or a header
    section exceeding the count/byte bounds — yields the "bad" marker:
    the client gets a 400 response and the connection closes instead of
    the server buffering unbounded header bytes (same contract as the
    bad-Content-Length path)."""
    try:
        line = await reader.readline()
    except (ConnectionError, asyncio.IncompleteReadError):
        return None
    except ValueError:
        # ONE line at/over the stream limit (64 KiB): readline raises
        # before any bound of ours can trip — same contract as a
        # garbage request line: answer 400 and close
        return "bad", "", {}, b""
    if not line:
        return None
    try:
        method, path, _ = line.decode("latin1").split(" ", 2)
    except ValueError:
        # garbage request line: nothing after it is framable, so the
        # response must close the socket — but it IS a response
        return "bad", "", {}, b""
    headers = {}
    header_bytes = 0
    while True:
        try:
            h = await reader.readline()
        except ValueError:
            # one header LINE at/over the stream limit — the byte
            # bound below only catches many small lines
            return "bad", path, {}, b""
        if h in (b"\r\n", b"\n", b""):
            break
        header_bytes += len(h)
        if len(headers) >= _MAX_HEADERS or header_bytes > _MAX_HEADER_BYTES:
            # unread header tail on the socket: framing unrecoverable,
            # answer 400 and close rather than buffer without bound
            return "bad", path, {}, b""
        k, _, v = h.decode("latin1").partition(":")
        headers[k.strip().lower()] = v.strip()
    try:
        n = int(headers.get("content-length", 0))
    except ValueError:
        return "bad", path, headers, b""     # -> 400, not a dead socket
    if n < 0 or n > _MAX_BODY:
        return "bad", path, headers, b""
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body


def _response(code: int, obj, keep_alive: bool, extra=None) -> bytes:
    body, ctype = render_body(obj)
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              503: "Service Unavailable",
              504: "Gateway Timeout"}.get(code, "OK")
    conn = "keep-alive" if keep_alive else "close"
    head = (f"HTTP/1.1 {code} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n")
    for k, v in (extra or {}).items():
        head += f"{k}: {v}\r\n"
    head += f"Connection: {conn}\r\n\r\n"
    return head.encode("latin1") + body


def _make_client_handler(repo, schedulers, pool, state):
    async def handle(reader, writer):
        loop = asyncio.get_running_loop()
        try:
            while True:
                req = await _read_request(reader)
                if req is None:
                    break
                method, path, headers, body = req
                keep = headers.get("connection", "keep-alive").lower() \
                    != "close"
                extra = {}
                # only POSTs are counted in flight (response write
                # included): drain() must not exit while an inference
                # response is unwritten, but counting health probes /
                # metrics scrapes would let monitoring traffic flake a
                # clean drain
                counted = method == "POST"
                if counted:
                    state.enter_request()
                try:
                    if method == "bad":
                        # the body was never read (unparseable request
                        # line, oversized header section, or
                        # unparseable/oversized Content-Length), so
                        # keep-alive framing on this socket is
                        # unrecoverable: respond and close
                        code, obj = 400, {"error": "malformed request"}
                        keep = False
                    elif method == "GET":
                        code, obj, extra = get_route(path, repo,
                                                     schedulers, state)
                    elif method == "POST":
                        # parse + (blocking) scheduler wait off-loop;
                        # the span is the LOOP-side view of the request
                        # (dispatch -> executor result), linked into
                        # the request's trace via the echoed id
                        with obs_events.span("serving.post",
                                             path=path) as sp:
                            code, obj, extra = \
                                await loop.run_in_executor(
                                    pool, post_route, path, body, repo,
                                    schedulers, headers, state)
                            tid = (extra or {}).get(
                                request_trace.TRACE_HEADER)
                            if tid:
                                sp.set(trace=tid)
                            sp.set(status=code)
                    else:
                        # unknown method/route: a framed 404 on a live
                        # connection (the body was consumed above),
                        # never a silent drop
                        code, obj = 404, {"error": f"method {method}"}
                    writer.write(_response(code, obj, keep, extra))
                    await writer.drain()
                finally:
                    if counted:
                        state.exit_request()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001 — teardown only
                pass

    return handle


def serve_async(repo, host: str = "127.0.0.1", port: int = 8000,
                batching: bool = True, block: bool = True,
                max_batch: int = 64, max_delay_ms: float = 2.0,
                max_queue: int = 256, pool_workers: int = 32,
                default_deadline_ms: Optional[float] = None,
                breaker_threshold: int = 5,
                breaker_cooldown_s: float = 5.0
                ) -> Optional[AsyncServerHandle]:
    """Serve a :class:`ModelRepository` on an asyncio event loop.
    Mirrors :func:`http_server.serve_http` (same endpoints, batching
    schedulers, backpressure, deadlines, circuit breaker, drain);
    ``block=False`` runs the loop on a daemon thread and returns an
    :class:`AsyncServerHandle`."""
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
                breaker_cooldown_s=breaker_cooldown_s)
    pool = ThreadPoolExecutor(max_workers=pool_workers,
                              thread_name_prefix="ffserve")
    loop = asyncio.new_event_loop()
    handler = _make_client_handler(repo, schedulers, pool, state)
    server = loop.run_until_complete(
        asyncio.start_server(handler, host, port))

    if block:
        try:
            loop.run_forever()
        finally:
            server.close()
            for s in schedulers.values():
                s.close()
            pool.shutdown(wait=False)
            loop.close()
        return None

    def _run():
        # the loop thread owns the close: run_forever returning (via
        # stop()) always releases the selector/self-pipe fds, even when
        # the stopping thread's join times out — closing from OUTSIDE
        # conditioned on is_alive() leaked them in exactly that case
        try:
            loop.run_forever()
        finally:
            loop.close()

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    return AsyncServerHandle(loop, server, t, schedulers, pool, state)
