"""Process-wide resilience status — the always-on half of the
resilience telemetry.

The port of ``flexflow_tpu/resilience/status.py``, unchanged (plain
Python). The coordinator (``resilience/coord.py``) sets the world
fields as it starts and as it detects failures; the replan fields stay
at their initial values until replanning is ported.

``obs.events`` counters vanish when tracing is disabled; a ``/healthz``
probe or a test asserting "the supervisor really did restart once" needs
numbers that exist regardless. This module is that: a thread-safe dict of
restart/fault/checkpoint facts, mirrored into the Prometheus registry by
the writers (supervisor, checkpoint manager, elastic re-plan) and merged
into both HTTP front-ends' ``/healthz`` response.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

_lock = threading.Lock()


def _fresh() -> Dict[str, Any]:
    return {
        "restarts": 0,                    # supervisor recoveries, any cause
        "nan_rollbacks": 0,               # restarts caused by non-finite loss
        "elastic_replans": 0,             # device-loss re-plan + reshard
        "faults_injected": 0,             # fault-plan clauses that fired
        "checkpoints_saved": 0,
        "corrupt_checkpoints_skipped": 0,  # restore fallbacks past bad steps
        "last_fault": None,               # "kind@step" of the newest firing
        "last_checkpoint_step": None,
        "last_checkpoint_unix_s": None,
        # multi-process world (resilience/coord.py); epoch/rank/size are
        # set when a coordinator starts, failures as they are detected
        "world_epoch": 0,
        "world_rank": 0,
        "world_size": 1,
        "rank_failures": 0,               # peer failures detected here
        "last_rank_failure": None,        # "rank=R epoch=E reason"
        # newest flight-recorder dump of this process (obs/flight.py):
        # the bounded black-box written at RankFailure / NaN-rollback /
        # crash sites, referenced from /healthz so a probe can point an
        # operator straight at the evidence
        "last_flight_record": None,
        # closed-loop plan adaptation (resilience/replan.py): the
        # controller mirrors its state machine here so /healthz answers
        # "is the fleet healing itself, and did the last swap stick"
        "replans": 0,                     # adopted plan swaps
        "replan_rollbacks": 0,            # A/B-guard reverts
        "replan_last_trigger": None,      # "drift" | "degraded" | ...
        "replan_last_outcome": None,      # "adopted" | "rolled_back" |
                                          # "rejected" | "no_win" | ...
        "replan_candidate": None,         # "idle"|"searching"|"pending"
        "replan_cooldown_until_unix_s": None,
    }


_data: Dict[str, Any] = _fresh()


def record(key: str, n: int = 1) -> None:
    with _lock:
        _data[key] = (_data.get(key) or 0) + n


def set_value(key: str, value: Any) -> None:
    with _lock:
        _data[key] = value


def record_fault(kind: str, step: int) -> None:
    with _lock:
        _data["faults_injected"] += 1
        _data["last_fault"] = f"{kind}@{step}"


def record_checkpoint(step: int) -> None:
    with _lock:
        _data["checkpoints_saved"] += 1
        _data["last_checkpoint_step"] = int(step)
        _data["last_checkpoint_unix_s"] = time.time()


def snapshot() -> Dict[str, Any]:
    with _lock:
        return dict(_data)


def reset() -> None:
    """Back to process-start state (tests)."""
    with _lock:
        _data.clear()
        _data.update(_fresh())


def checkpoint_age_s() -> Optional[float]:
    with _lock:
        t = _data.get("last_checkpoint_unix_s")
    return None if t is None else max(0.0, time.time() - t)


def health_fields() -> Dict[str, Any]:
    """The resilience block of the ``/healthz`` response: the snapshot
    plus a derived time-since-last-checkpoint age (probes alert on age,
    not on a unix timestamp)."""
    out = snapshot()
    age = checkpoint_age_s()
    if age is not None:
        out["checkpoint_age_s"] = round(age, 3)
    # cooldown as a remaining-seconds age (probes alert on remaining,
    # not on a unix timestamp), clamped at 0 once it elapsed
    until = out.pop("replan_cooldown_until_unix_s", None)
    out["replan_cooldown_remaining_s"] = \
        0.0 if until is None else round(max(0.0, until - time.time()), 3)
    return out
