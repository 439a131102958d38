"""Cross-process coordination: heartbeats, bounded barriers, world epoch.

The port of ``flexflow_tpu/resilience/coord.py``. ``torch.distributed``
gives a world a key-value store (the ``TCPStore`` that rank 0 hosts at
the coordinator address, behind ``init_process_group``'s rendezvous) and
collectives that fail or hang when a peer dies. This module turns the
store into a failure-detection layer for the world of ranks:

  - **heartbeats**: every rank runs a daemon thread that bumps a
    per-rank sequence number in the store every
    ``heartbeat_interval_s``; a monitor on each rank watches its peers
    and attributes a rank whose sequence stops advancing for
    ``heartbeat_timeout_s`` (a crashed process stops beating instantly;
    a SIGSTOP'd/hung one stops within one interval — the writer thread
    is in-process). The thread touches only the store, never the
    process group or the card;
  - **bounded barriers**: :meth:`Coordinator.barrier` never waits
    forever — on timeout it consults the heartbeat table and raises
    :class:`RankFailure` naming the suspected dead rank (or "unknown"
    when every peer still beats, i.e. a slow rank, not a dead one), and
    a failure the heartbeats latch during the wait ends it at once. They
    run through the store, never the process group, so the checkpoint
    writer's thread can meet in one while the train step's collectives
    run;
  - **collective errors**: a dead peer usually surfaces first as an
    error of a collective (gloo: "Connection closed by peer", within
    milliseconds). :func:`as_rank_failure` turns such an error into the
    coordinator's attributed :class:`RankFailure`, waiting at most
    ``heartbeat_timeout_s`` for the heartbeats to name the rank;
  - **world epoch**: a monotonic integer identifying the current
    incarnation of the world. The launcher (``resilience.supervisor.
    WorldSupervisor``) bumps it on every relaunch/shrink via
    ``FF_WORLD_EPOCH``; all heartbeat keys and barrier ids are
    epoch-scoped so debris from a dead epoch can never satisfy (or
    poison) a rendezvous in the next one;
  - **supervised exit**: under a world supervisor
    (``FF_WORLD_SUPERVISED=1``) a detected failure additionally arms a
    delayed hard-exit (:data:`EXIT_RANK_FAILURE`) so a survivor stuck
    inside a device collective (NCCL) — unreachable from Python — still
    dies within a bound and the supervisor can re-form the world.

Rank 0 hosts the store, so when rank 0 dies every store call of a
survivor fails: the survivor attributes that to rank 0
(:attr:`StoreKV.host_rank`), not to itself.

Single-process worlds get a no-op coordinator (local KV, barriers
return immediately) so every call site stays unconditional.

Timeouts are configurable via ``FFConfig`` (``heartbeat_interval_s``,
``heartbeat_timeout_s``, ``barrier_timeout_s``) or the ``FF_HB_INTERVAL_S``
/ ``FF_HB_TIMEOUT_S`` / ``FF_BARRIER_TIMEOUT_S`` env vars (env wins; the
launcher uses it to tighten test worlds). The record keys are the JAX
package's: ``ff/hb/e<epoch>/<rank>``, ``ff/clock/e<epoch>/<rank>``,
barrier ids ``ff:e<epoch>:<name>``.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from datetime import timedelta
from typing import Dict, List, Optional

from ..obs import events as obs_events
from ..obs.metrics_registry import REGISTRY
from . import status

log = logging.getLogger("flexflow_tpu_torch")

#: process exit code meaning "I detected a peer rank failure and chose
#: to die so the world supervisor can re-form the world" — distinct from
#: a crash of this rank itself.
EXIT_RANK_FAILURE = 17

#: the heartbeat bounds when neither the environment nor the config
#: sets them: a beat every HB_INTERVAL_S, a peer silent for HB_TIMEOUT_S
#: is dead
HB_INTERVAL_S = 0.25
HB_TIMEOUT_S = 10.0

#: words of a collective's error that say a connection to a peer was
#: lost (gloo's "Connection closed by peer", a reset or refused socket,
#: NCCL's "remote process exiting"). A rank's own error in a collective
#: (a size check, a bad root) names gloo or NCCL too, and is not one.
_PEER_LOST = ("connection closed by peer", "connection reset by peer",
              "connection refused", "broken pipe", "remote process")


class RankFailure(RuntimeError):
    """A peer rank is dead or unreachable. ``rank`` is the suspected
    dead rank (None when the timeout could not be attributed), ``epoch``
    the world epoch it happened in."""

    def __init__(self, reason: str, rank: Optional[int] = None,
                 epoch: int = 0):
        who = f"rank {rank}" if rank is not None else "unknown rank"
        super().__init__(f"{who} failed (epoch {epoch}): {reason}")
        self.rank = rank
        self.epoch = epoch
        self.reason = reason


# ---------------------------------------------------------------------------
# KV backends
# ---------------------------------------------------------------------------
class LocalKV:
    """In-process stand-in for the distributed KV store: single-process
    worlds and unit tests run the same Coordinator code against it."""

    #: the rank whose process serves the store (none: it is in-process)
    host_rank: Optional[int] = None

    def __init__(self):
        self._data: Dict[str, str] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value

    def dir_get(self, prefix: str) -> List[tuple]:
        with self._lock:
            return [(k, v) for k, v in self._data.items()
                    if k.startswith(prefix)]

    def barrier(self, name: str, timeout_s: float,
                world: int = 1) -> None:
        if world > 1:
            raise TimeoutError(
                f"LocalKV cannot rendezvous a {world}-process world")


class StoreKV:
    """The world's store: a client of the ``TCPStore`` at the
    coordinator address (``host:port``), which rank 0 serves for the
    process group's rendezvous. The coordinator keeps its own client, so
    a blocking call of the process group on the default client never
    holds up a heartbeat.

    The store cannot list keys, so :meth:`dir_get` reads ``prefix + r``
    for every rank ``r`` of the world (every directory the coordinator
    and the checkpoint quorum keep is one key per rank). A barrier is a
    counter per use that each rank bumps once and then polls until the
    world has arrived: each call holds the client for one round trip, so
    the heartbeat thread and the checkpoint writer's thread share the
    client with the main thread."""

    #: rank 0 serves the store: when its calls fail, rank 0 is gone
    host_rank: Optional[int] = 0

    def __init__(self, address: str, world: int,
                 timeout_s: float = 60.0):
        from torch.distributed import TCPStore
        addr = address.split("://", 1)[-1]
        host, port = addr.rsplit(":", 1)
        self._store = TCPStore(host, int(port), is_master=False,
                               timeout=timedelta(seconds=timeout_s),
                               wait_for_workers=False)
        self.world = int(world)
        self._uses: Dict[str, int] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: str) -> None:
        self._store.set(key, value)

    def dir_get(self, prefix: str) -> List[tuple]:
        out = []
        for r in range(self.world):
            key = f"{prefix}{r}"
            if self._store.check([key]):
                out.append((key, self._store.get(key).decode()))
        return out

    def barrier(self, name: str, timeout_s: float, world: int = 1,
                abort=None) -> None:
        """Wait until ``world`` ranks reached this use of ``name``;
        raises TimeoutError after ``timeout_s``, or the failure that
        ``abort()`` returns as soon as it returns one (the heartbeats
        named a dead peer: no need to wait the timeout out)."""
        # every rank meets the barriers in the same order, so the n-th
        # use of a name is the same rendezvous on every rank
        with self._lock:
            n = self._uses[name] = self._uses.get(name, 0) + 1
        key = f"ff/barrier/{name}/{n}"
        self._store.add(key, 1)
        deadline = time.monotonic() + timeout_s
        delay = 0.001
        while True:
            got = int(self._store.add(key, 0))
            if got >= world:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{got} of {world} ranks reached barrier {name!r}")
            failed = abort() if abort is not None else None
            if failed is not None:
                raise failed
            time.sleep(delay)
            delay = min(2 * delay, 0.05)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------
class Coordinator:
    """Per-process view of the multi-rank world. One per process
    (module singleton via :func:`ensure_started`); every public method
    is thread-safe."""

    def __init__(self, rank: int, world: int, *,
                 epoch: Optional[int] = None, kv=None,
                 heartbeat_interval_s: Optional[float] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 barrier_timeout_s: Optional[float] = None,
                 supervised: Optional[bool] = None):
        self.rank = int(rank)
        self.world = int(world)
        self.epoch = int(os.environ.get("FF_WORLD_EPOCH", "0")
                         if epoch is None else epoch)
        self.heartbeat_interval_s = _env_float(
            "FF_HB_INTERVAL_S", heartbeat_interval_s or HB_INTERVAL_S)
        self.heartbeat_timeout_s = _env_float(
            "FF_HB_TIMEOUT_S", heartbeat_timeout_s or HB_TIMEOUT_S)
        self.barrier_timeout_s = _env_float(
            "FF_BARRIER_TIMEOUT_S", barrier_timeout_s or 60.0)
        self.supervised = (os.environ.get("FF_WORLD_SUPERVISED") == "1"
                           if supervised is None else supervised)
        if kv is None:
            if world > 1:
                from ..parallel import distributed as dist
                addr = dist.coordinator_address()
                if not addr:
                    raise RuntimeError(
                        "Coordinator for a multi-process world needs the "
                        "world's rendezvous (parallel.distributed."
                        "maybe_initialize first)")
                kv = StoreKV(addr, world, timeout_s=self.barrier_timeout_s)
            else:
                kv = LocalKV()
        self.kv = kv
        self._seq = 0
        self._failure: Optional[RankFailure] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # rank -> (last seen seq, monotonic time the seq last advanced)
        self._peer_seen: Dict[int, tuple] = {}
        # cross-rank clock anchor from the last clock_sync() handshake:
        # {"perf_s", "wall_s", "name"} — perf_counter/wall sampled at
        # the barrier release, i.e. (near-)the same physical instant on
        # every rank. tools/fftrace.py uses it to place each rank's
        # monotonic span timestamps on one merged timeline.
        self.clock_anchor: Optional[Dict] = None
        status.set_value("world_epoch", self.epoch)
        status.set_value("world_rank", self.rank)
        status.set_value("world_size", self.world)
        REGISTRY.gauge("ff_world_epoch",
                       "Monotonic epoch of the current world incarnation"
                       ).set(float(self.epoch))

    # -- key naming ----------------------------------------------------
    def _hb_prefix(self) -> str:
        return f"ff/hb/e{self.epoch}/"

    def _hb_key(self, rank: int) -> str:
        return f"{self._hb_prefix()}{rank}"

    def _host_lost(self) -> Optional[int]:
        """The rank blamed when the store itself is unreachable: the
        rank that serves it, unless that is this rank."""
        host = getattr(self.kv, "host_rank", None)
        return host if host is not None and host != self.rank else None

    # -- heartbeats ----------------------------------------------------
    def start(self) -> "Coordinator":
        """Begin beating + monitoring. Idempotent."""
        if self._thread is not None or self.world <= 1:
            return self
        self.beat()  # first beat synchronously: peers see us immediately
        self._thread = threading.Thread(
            target=self._loop, name="ff-coord-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2 * self.heartbeat_interval_s + 1.0)
        self._thread = None

    def beat(self) -> None:
        self._seq += 1
        self.kv.set(self._hb_key(self.rank), str(self._seq))

    def _loop(self) -> None:
        misses_metric = REGISTRY.counter(
            "ff_heartbeat_misses_total",
            "Peer heartbeat timeouts observed by this rank")
        detected_at: Optional[float] = None
        while not self._stop.wait(self.heartbeat_interval_s):
            try:
                self.beat()
                stale = self._scan_peers()
            except Exception as e:  # noqa: BLE001 — KV died = world died
                stale = None
                self._latch(RankFailure(
                    f"coordination service unreachable: {e}",
                    rank=self._host_lost(), epoch=self.epoch))
            if stale:
                with self._lock:
                    fresh = self._failure is None
                if fresh:
                    misses_metric.inc()
                    self._latch(RankFailure(
                        f"no heartbeat for "
                        f"{self.heartbeat_timeout_s:.1f}s",
                        rank=stale[0], epoch=self.epoch))
            if self.failure() is not None and self.supervised:
                # the main thread may be stuck inside a device collective
                # (unreachable from Python) — give it one timeout's grace
                # to surface the failure via check()/barrier(), then die
                # loudly so the world supervisor can re-form the world
                if detected_at is None:
                    detected_at = time.monotonic()
                elif time.monotonic() - detected_at \
                        > self.heartbeat_timeout_s:
                    log.error(
                        "coordinator: rank failure unhandled for %.1fs "
                        "— exiting %d for the world supervisor",
                        self.heartbeat_timeout_s, EXIT_RANK_FAILURE)
                    os._exit(EXIT_RANK_FAILURE)

    def _latch(self, f: RankFailure) -> RankFailure:
        """Keep ``f`` as this process's failure unless one is latched
        already; returns the latched one (recorded once)."""
        with self._lock:
            if self._failure is not None:
                return self._failure
            self._failure = f
        _record_failure(f)
        return f

    def _scan_peers(self) -> List[int]:
        """Ranks whose heartbeat seq has not advanced within the
        timeout. A peer we have never seen is not stale until the
        timeout passes from OUR start — ranks join at different times.
        Callers race (heartbeat thread vs a timed-out barrier on the
        main/writer thread), so the peer table update is locked."""
        now = time.monotonic()
        seen: Dict[int, str] = {}
        for key, val in self.kv.dir_get(self._hb_prefix()):
            tail = key.rsplit("/", 1)[-1]
            if tail.isdigit():
                seen[int(tail)] = val
        stale = []
        with self._lock:
            for r in range(self.world):
                if r == self.rank:
                    continue
                cur = seen.get(r)
                prev = self._peer_seen.get(r)
                if cur is not None and (prev is None or prev[0] != cur):
                    self._peer_seen[r] = (cur, now)
                    continue
                if prev is None:
                    # never beat: count from monitor start
                    self._peer_seen[r] = (None, now)
                    continue
                if now - prev[1] > self.heartbeat_timeout_s:
                    stale.append(r)
        return stale

    # -- failure surface ----------------------------------------------
    def failure(self) -> Optional[RankFailure]:
        with self._lock:
            return self._failure

    def check(self) -> None:
        """Raise the pending :class:`RankFailure`, if any. Cheap — the
        train loop calls this every step."""
        f = self.failure()
        if f is not None:
            raise f

    def attribute(self, err: BaseException) -> Optional[RankFailure]:
        """The :class:`RankFailure` behind ``err``, an error that a
        collective or the store raised when a peer went away; None for
        any other error (this process's own failure). Waits at most
        ``heartbeat_timeout_s`` (plus one beat) for the heartbeats to
        name the dead rank, then settles for "unknown"."""
        if isinstance(err, RankFailure):
            return self._latch(err)
        if self.world <= 1 or not _peer_lost(err):
            return None
        deadline = time.monotonic() + self.heartbeat_timeout_s \
            + 2 * self.heartbeat_interval_s
        while time.monotonic() < deadline:
            f = self.failure()
            if f is not None:
                return f
            time.sleep(min(self.heartbeat_interval_s, 0.05))
        return self._latch(RankFailure(
            f"a collective failed and no peer was attributed within "
            f"{self.heartbeat_timeout_s:.1f}s: {err}", rank=None,
            epoch=self.epoch))

    # -- bounded barrier ----------------------------------------------
    def barrier(self, name: str,
                timeout_s: Optional[float] = None) -> None:
        """Epoch-scoped rendezvous of every rank in the world; raises
        :class:`RankFailure` (with the dead rank attributed from the
        heartbeat table) instead of waiting forever. Every rank meets
        the barriers of a name in one order: over the world's store the
        n-th use of a name is one rendezvous (``StoreKV`` counts them)."""
        self.check()
        if self.world <= 1:
            return
        timeout_s = timeout_s if timeout_s is not None \
            else self.barrier_timeout_s
        bid = f"ff:e{self.epoch}:{name}"
        # the store's barrier polls, so it also stops at a failure the
        # heartbeats latch meanwhile (before the supervised hard exit)
        kw = {"abort": self.failure} if isinstance(self.kv, StoreKV) \
            else {}
        t0 = time.perf_counter()
        try:
            self.kv.barrier(bid, timeout_s, world=self.world, **kw)
        except RankFailure:
            raise
        except Exception as e:  # timeout / connection loss
            try:
                stale = self._scan_peers()
            except Exception:  # noqa: BLE001 — the store itself is gone
                host = self._host_lost()
                stale = [host] if host is not None else []
            f = RankFailure(
                f"barrier {name!r} timed out after {timeout_s:.1f}s "
                f"({e})", rank=stale[0] if stale else None,
                epoch=self.epoch)
            with self._lock:
                if self._failure is None:
                    self._failure = f
            _record_failure(f)
            raise f from e
        finally:
            obs_events.record_span("coord.barrier", t0,
                                   time.perf_counter() - t0,
                                   barrier=name)

    # -- clock handshake ----------------------------------------------
    def clock_sync(self, name: str = "clock") -> Dict:
        """KV-store clock handshake for cross-rank trace alignment:
        every rank meets at one epoch-scoped bounded barrier, then
        samples ``(perf_counter, wall)`` at the release — the same
        physical instant (within barrier-release skew) everywhere — and
        publishes its wall sample to the KV store for diagnostics. The
        anchor is kept on ``self.clock_anchor``; the per-rank trace
        dump (obs/trace_export.dump_rank_trace) and the flight recorder
        embed it so ``tools/fftrace.py`` can align the rank timelines
        without trusting cross-host wall clocks. Single-process worlds
        anchor immediately (the barrier is a no-op)."""
        if self.world > 1:
            self.barrier(f"clock:{name}")
        t_perf = time.perf_counter()
        t_wall = time.time()
        self.clock_anchor = {"perf_s": t_perf, "wall_s": t_wall,
                             "name": name}
        try:
            self.kv.set(f"ff/clock/e{self.epoch}/{self.rank}",
                        repr(t_wall))
        except Exception:  # noqa: BLE001 — the KV copy is diagnostics
            pass
        return self.clock_anchor


def _peer_lost(err: BaseException) -> bool:
    """Whether ``err`` is how a collective or the store reports a lost
    connection to a peer: ``torch.distributed``'s ``DistNetworkError``
    (the store's "Connection was likely closed"), or a RuntimeError or
    OSError in the words of :data:`_PEER_LOST`."""
    import torch.distributed as dist
    lost = getattr(dist, "DistNetworkError", None)
    if lost is not None and isinstance(err, lost):
        return True
    text = str(err).lower()
    return isinstance(err, (RuntimeError, OSError)) and any(
        w in text for w in _PEER_LOST)


def _record_failure(f: RankFailure) -> None:
    status.record("rank_failures")
    status.set_value("last_rank_failure",
                     f"rank={f.rank} epoch={f.epoch} {f.reason}")
    REGISTRY.counter("ff_rank_failures_total",
                     "Peer rank failures detected by this process").inc()
    obs_events.counter("resilience.rank_failure")
    obs_events.instant("resilience.rank_failure", rank=f.rank,
                       epoch=f.epoch, reason=f.reason)
    # black-box dump at the detection site: this survivor may be about
    # to exit for world re-formation, and its ring/counters/world facts
    # are the only record of what the world looked like at the failure
    from ..obs import flight
    flight.dump_flight_record("rank_failure", exc=f)
    log.error("coordinator: %s", f)


# ---------------------------------------------------------------------------
# process-wide singleton
# ---------------------------------------------------------------------------
_coord: Optional[Coordinator] = None
_coord_lock = threading.Lock()


def get() -> Optional[Coordinator]:
    # benign: atomic reference read; _coord_lock only orders
    # create/teardown, and a stale None here just means "no coordinator"
    return _coord


def ensure_started(config=None) -> Coordinator:
    """The process coordinator, creating + starting it on first use.
    Called from ``FFModel.compile`` right after the world rendezvous;
    single-process worlds get the no-op local coordinator."""
    global _coord
    with _coord_lock:
        if _coord is not None:
            return _coord
        import atexit

        from ..parallel.distributed import process_count, process_index
        # stop the heartbeat thread BEFORE interpreter teardown: a beat
        # in flight while the store client is being destroyed would
        # fail the world's last rank on its way out
        atexit.register(reset)
        kw = {}
        if config is not None:
            for name in ("heartbeat_interval_s", "heartbeat_timeout_s",
                         "barrier_timeout_s"):
                v = getattr(config, name, None)
                if v:
                    kw[name] = float(v)
        _coord = Coordinator(process_index(), process_count(),
                             **kw).start()
        # an unhandled crash on a world member should leave a flight
        # record for the WorldSupervisor's per-rank report
        from ..obs import flight
        flight.install_excepthook()
        return _coord


def reset() -> None:
    """Tear down the singleton (tests)."""
    global _coord
    with _coord_lock:
        c, _coord = _coord, None
    if c is not None:
        c.stop()


def check() -> None:
    """Module-level pending-failure check: no-op without a coordinator."""
    c = _coord
    if c is not None:
        c.check()


def barrier(name: str, timeout_s: Optional[float] = None) -> None:
    """Module-level bounded barrier: no-op without a coordinator (the
    single-process checkpoint path calls this unconditionally)."""
    c = _coord
    if c is not None:
        c.barrier(name, timeout_s=timeout_s)


def as_rank_failure(err: BaseException) -> Optional[RankFailure]:
    """Module-level :meth:`Coordinator.attribute`: None without a
    coordinator of a world."""
    c = _coord
    if c is None:
        return err if isinstance(err, RankFailure) else None
    return c.attribute(err)
