"""Flight recorder: a bounded black-box dump at the moment of failure.

The port of ``flexflow_tpu/obs/flight.py``.

When a rank dies — a peer :class:`RankFailure`, a NaN rollback, an
unhandled crash — the evidence is usually gone with the process: the
span ring lived in memory, the counters were never scraped, and the
``WorldSupervisor`` only sees an exit code and a stderr tail. The
flight recorder dumps a BOUNDED record at the failure site:

  - the newest ``max_events`` spans/instants from the ring (tracing
    off = empty list; the record is still written — counters and world
    facts don't need tracing);
  - the span counters and the ring's drop count;
  - the resilience status block (world epoch/rank/size, restart and
    rank-failure tallies — the same facts ``/healthz`` serves);
  - the reason and, when available, the triggering exception.

One file per (rank, world-epoch):
``<repo>/.ffcache/flight_rank<r>_epoch<e>.json`` — a later failure in
the same incarnation overwrites (the newest failure is the one being
debugged), so the cache can never grow unboundedly. The path is
mirrored into ``resilience.status`` (``last_flight_record``) so
``/healthz`` references it, and the ``WorldSupervisor`` attaches the
per-epoch flight files to its per-rank report.

Triggers: ``resilience/coord.py`` (every detected
:class:`RankFailure`), ``resilience/supervisor.py`` (NaN rollback; the
``WorldSupervisor`` writes a launcher-side record for a failed world
epoch), and a ``sys.excepthook`` chain for unhandled crashes
(:func:`install_excepthook`, installed by the Supervisor and by the
coordinator of a world member). A record carries the coordinator's
clock anchor, when its handshake ran.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

from . import events as obs_events
from .metrics_registry import REGISTRY

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".ffcache")

SCHEMA_VERSION = 1
DEFAULT_MAX_EVENTS = 256

_hook_lock = threading.Lock()
_hook_installed = False


def flight_path(rank: int, epoch: int,
                cache_dir: Optional[str] = None) -> str:
    return os.path.join(cache_dir or _DEFAULT_DIR,
                        f"flight_rank{rank}_epoch{epoch}.json")


def flight_record(reason: str, exc: Optional[BaseException] = None,
                  max_events: int = DEFAULT_MAX_EVENTS
                  ) -> Dict[str, Any]:
    """Assemble the bounded record (no I/O)."""
    from ..resilience import status
    snap = obs_events.snapshot(max_events=max_events)
    world = status.snapshot()
    doc: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "reason": reason,
        "pid": os.getpid(),
        "rank": int(world.get("world_rank") or 0),
        "world_epoch": int(world.get("world_epoch") or 0),
        "world_size": int(world.get("world_size") or 1),
        "written_unix_s": time.time(),
        "perf_counter_s": time.perf_counter(),
        "events": snap["events"],
        "counters": snap["counters"],
        "dropped_events": snap["dropped"],
        "world": world,
    }
    if exc is not None:
        doc["exception"] = f"{type(exc).__name__}: {exc}"
    coord = _clock_anchor()
    if coord is not None:
        doc["clock"] = coord
    return doc


def _clock_anchor() -> Optional[Dict[str, Any]]:
    """The coordinator's KV-handshake clock anchor, when one ran —
    lets fftrace place this record's spans on the merged timeline."""
    try:
        from ..resilience import coord
        c = coord.get()
        return getattr(c, "clock_anchor", None) if c is not None else None
    except Exception:  # noqa: BLE001
        return None


def dump_flight_record(reason: str,
                       exc: Optional[BaseException] = None,
                       cache_dir: Optional[str] = None,
                       max_events: int = DEFAULT_MAX_EVENTS,
                       rank: Optional[Any] = None,
                       epoch: Optional[int] = None,
                       extra: Optional[Dict[str, Any]] = None
                       ) -> Optional[str]:
    """Write the flight record; returns its path (None on any failure —
    a recorder that throws at the failure site would mask the real
    error). Best-effort and re-entrant. ``rank``/``epoch`` override the
    identity (the launcher-side WorldSupervisor records as
    ``rank="launcher"`` so it can never collide with a worker rank's
    file); ``extra`` fields merge into the record."""
    try:
        doc = flight_record(reason, exc=exc, max_events=max_events)
        if rank is not None:
            doc["rank"] = rank
        if epoch is not None:
            doc["world_epoch"] = int(epoch)
        if extra:
            doc.update(extra)
        path = flight_path(doc["rank"], doc["world_epoch"], cache_dir)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        from ..resilience import status
        status.set_value("last_flight_record", path)
        REGISTRY.counter("ff_flight_records_total",
                         "Flight records dumped at failure sites"
                         ).inc(reason=reason)
        obs_events.counter("flight.records")
        return path
    except Exception:  # noqa: BLE001 — never mask the failing path
        return None


def install_excepthook() -> None:
    """Chain a ``sys.excepthook`` that dumps a flight record for
    unhandled crashes before delegating to the previous hook.
    Idempotent; KeyboardInterrupt/SystemExit are not failures."""
    global _hook_installed
    with _hook_lock:
        if _hook_installed:
            return
        prev = sys.excepthook

        def hook(etype, value, tb):
            if not issubclass(etype, (KeyboardInterrupt, SystemExit)):
                dump_flight_record("crash", exc=value)
            prev(etype, value, tb)

        sys.excepthook = hook
        _hook_installed = True
